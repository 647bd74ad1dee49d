"""Build the package's CUDA sources with `nvcc` and load them with `ctypes`.

Each source under `csrc/` exposes a plain `extern "C"` interface, so it
compiles in seconds without PyTorch's headers. `nvcc` runs in a subprocess
with its own timeout, at first use, and writes into `_build/` beside the
package (listed in `.gitignore`). The library's file name carries a hash of
its source and of every shared header (`csrc/*.cuh`), so an edited source or
header is rebuilt and a stale library is never loaded. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_TIMEOUT_S = 300
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels are built on a machine with the "
                           "CUDA toolkit")
    return path


def library_path(source: str) -> str:
    """Where the library built from `csrc/<source>` lives."""
    h = hashlib.sha256()
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for name in [source, *headers]:
        h.update(name.encode() + b"\0")
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build(source: str) -> dict:
    """Compile `csrc/<source>` for sm_90a unless its library is already built.

    Returns {"path", "seconds", "log"}; `log` holds nvcc's output (with
    `-Xptxas -v`: registers, shared memory and spills of each kernel)."""
    path = library_path(source)
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": "(already built)"}
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} (exit "
                               f"{proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, path)   # atomic: a reader never sees half a library
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {"path": path, "seconds": time.perf_counter() - t0,
            "log": (proc.stdout + proc.stderr).strip()}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built first if needed."""
    if source not in _LOADED:
        _LOADED[source] = ctypes.CDLL(build(source)["path"])
    return _LOADED[source]
