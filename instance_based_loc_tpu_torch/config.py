"""DATOR's config tree (counterpart of `instance_based_loc_tpu/config.py`):
nested dataclasses merged, in order, from

    defaults -> YAML file -> dotted overrides ("a.b.c=value")

as the reference's yacs `merge_from_file` / `merge_from_list` does.

A YAML file needs the `yaml` package, which the card's machine does not
have: there `--config` raises and names the dotted overrides. A dotted
override's value is read by `parse_scalar`, YAML 1.1's rules for a plain
scalar (the ones `yaml.safe_load` applies to one), so overrides read the
same on every machine.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

from .models.dator.fourdnet import FourDNetConfig
from .models.dator.train import TrainConfig


@dataclasses.dataclass
class DataConfig:
    root: str = "./data/reid"
    height: int = 256
    width: int = 128
    batch_size: int = 64           # config.yml SOLVER.IMS_PER_BATCH
    num_instances: int = 4         # DATALOADER.NUM_INSTANCE (P x K)
    seed: int = 0
    # u8 rgb + u16 depth batches, dequantised on the device
    quantize_upload: bool = True
    # the whole quantised dataset on the device, batches gathered there by
    # index: "auto" (when under device_dataset_max_mb), true or false
    device_dataset: Any = "auto"
    device_dataset_max_mb: int = 512
    # held-out split for eval (same layout as root); empty: eval on root
    val_root: str = ""


@dataclasses.dataclass
class EvalConfig:
    period: int = 5                # eval every N epochs
    checkpoint_period: int = 20    # checkpoint every N epochs
    re_ranking: bool = False       # TEST.RE_RANKING
    max_rank: int = 50
    train_split: bool = True       # also evaluate on the training split


@dataclasses.dataclass
class DatorConfig:
    model: FourDNetConfig = dataclasses.field(default_factory=FourDNetConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    output_dir: str = "./out/torch/dator"
    # the JAX package's mesh "model" axis; one card runs both towers
    n_model_shards: int = 1


_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")


def parse_scalar(raw: str):
    """A plain YAML 1.1 scalar as `yaml.safe_load` reads it: booleans
    (yes/no/on/off/true/false), null, decimal, hex (0x), octal (0...),
    binary (0b) and base-60 (1:30) integers, floats with a dot (so "1e-4"
    stays a string), .inf / .nan, a quoted string without its quotes;
    anything else is a string."""
    text = raw.strip()
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    sign = -1 if text.startswith("-") else 1
    body = text.lstrip("+-")
    digits = body.replace("_", "")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if re.fullmatch(r"0x[0-9a-fA-F_]+", body):
        return sign * int(digits[2:], 16)
    if re.fullmatch(r"0b[01_]+", body):
        return sign * int(digits[2:], 2)
    if re.fullmatch(r"0[0-7_]+", body):
        return sign * int(digits, 8)
    if re.fullmatch(r"[1-9][0-9_]*(:[0-5]?[0-9])+", body):   # base 60
        return sign * int(sum(int(x) * 60 ** i for i, x in
                              enumerate(reversed(digits.split(":")))))
    if _FLOAT.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    if body in (".inf", ".Inf", ".INF"):
        return sign * float("inf")
    if text in (".nan", ".NaN", ".NAN"):
        return float("nan")
    return text


def _merge_into(obj: Any, updates: dict) -> Any:
    """Recursively apply a dict onto a (possibly frozen) dataclass tree,
    casting each value to the type of the field's current value."""
    if not dataclasses.is_dataclass(obj):
        return updates
    fields = {f.name for f in dataclasses.fields(obj)}
    kwargs = {}
    for key, value in updates.items():
        if key not in fields:
            raise KeyError(f"unknown config key '{key}' for "
                           f"{type(obj).__name__}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            kwargs[key] = _merge_into(current, value)
        else:
            kwargs[key] = type(current)(value) if current is not None else value
    return dataclasses.replace(obj, **kwargs)


def load_config(yaml_path: str | None = None,
                overrides: list[str] | None = None) -> DatorConfig:
    """defaults -> YAML -> dotted overrides (e.g. 'train.base_lr=0.01')."""
    cfg = DatorConfig()
    if yaml_path:
        try:
            import yaml
        except ImportError as exc:
            raise RuntimeError(
                f"--config {yaml_path} needs the yaml package, which this "
                f"machine does not have; give the settings as dotted "
                f"overrides instead (e.g. train.base_lr=0.01 "
                f"data.root=DIR)") from exc
        with open(yaml_path) as f:
            cfg = _merge_into(cfg, yaml.safe_load(f) or {})
    for item in overrides or []:
        key, _, raw = item.partition("=")
        tree: dict = {}
        node = tree
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node[p] = {}
            node = node[p]
        node[parts[-1]] = parse_scalar(raw)
        cfg = _merge_into(cfg, tree)
    return cfg


def device_dataset_on(value: Any, dataset_mb: float, max_mb: float) -> bool:
    """`data.device_dataset`: "auto" is on when the quantised dataset fits
    in max_mb; otherwise a boolean, given as one or as its text ("true",
    "False", ...: a dotted override stores str(bool) in this str field)."""
    if value == "auto":
        return dataset_mb <= max_mb
    if isinstance(value, str):
        if value not in _BOOL:
            raise ValueError(f"data.device_dataset must be auto, true or "
                             f"false; got {value!r}")
        return _BOOL[value]
    return bool(value)
