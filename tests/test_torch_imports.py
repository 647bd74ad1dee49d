"""Import hygiene of the PyTorch port: it and chip_smoke.py must run on a
machine that has PyTorch, numpy and scipy but none of JAX, flax, PIL,
transformers, scikit-learn or yaml, and they never load the JAX package or
its compiled host library (built for the build machine's CPU).

yaml is optional: an import of it inside a function, in a `try` that
handles ImportError (config.py reads a YAML `--config` where yaml
exists), passes; any other import of a forbidden name fails."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "instance_based_loc_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "PIL", "transformers",
             "sklearn", "yaml", "instance_based_loc_tpu"}
OPTIONAL = {"yaml"}     # imported in a function, guarded by ImportError


def _guarded_imports(tree) -> set:
    """Import nodes inside a function and inside a `try` whose handlers
    catch ImportError."""
    guarded = set()
    for func in ast.walk(tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(func):
            if isinstance(node, ast.Try) and any(
                    isinstance(h.type, ast.Name)
                    and h.type.id in ("ImportError", "ModuleNotFoundError")
                    for h in node.handlers):
                for stmt in node.body:
                    guarded.update(id(n) for n in ast.walk(stmt))
    return guarded


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, names in os.walk(os.path.join(ROOT, PACKAGE)):
        dirs[:] = [d for d in dirs if d != "_build"]   # build output only
        files += [os.path.join(dirpath, n) for n in sorted(names)
                  if n.endswith(".py")]
    return files


def _modules():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import_or_native_library(path):
    with open(path) as f:
        source = f.read()
    assert "libiblgeom" not in source
    tree = ast.parse(source)
    guarded = _guarded_imports(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in OPTIONAL and id(node) in guarded:
                continue
            assert top not in FORBIDDEN, (path, name)


def test_importing_every_module_loads_neither_jax_nor_pil():
    code = ("import importlib, sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in ('jax', 'flax', 'PIL', 'transformers', "
            "'sklearn', 'yaml', 'instance_based_loc_tpu') if m in sys.modules)\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-I", "-c", code],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
