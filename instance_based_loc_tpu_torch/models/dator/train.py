"""DATOR checkpoint I/O (counterpart of the npz half of
`instance_based_loc_tpu/models/dator/train.py`; the trainer is not ported
yet).

The checkpoint format that crosses packages is the JAX package's flat npz:
one entry per parameter, keyed by its flax key path
("['params']['towers']['block0']['attn']['qkv']['kernel']"), fp32 values
stored as fp16. The port's DATOR modules keep the flax names and shapes, so
a state-dict key is that path without its collection, joined by dots
("towers.block0.attn.qkv.kernel"); parameters live in the "params"
collection and buffers (BatchNorm statistics) in "batch_stats".

Orbax checkpoint directories (the JAX trainer's) are not read: convert
them with the JAX package's `save_params_npz`.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn


def _npz_key(name: str, collection: str) -> str:
    return f"['{collection}']" + "".join(f"['{p}']" for p in name.split("."))


def _npz_keys(model: nn.Module) -> dict[str, str]:
    """State-dict key -> npz key of every entry of `model`."""
    buffers = {name for name, _ in model.named_buffers()}
    return {name: _npz_key(name, "batch_stats" if name in buffers
                           else "params")
            for name in model.state_dict()}


def save_params_npz(model: nn.Module, path: str) -> None:
    """The model's state as the JAX package's flat npz (fp32 values stored
    as fp16, as `save_params_npz` there does). Raises if a value does not
    fit in fp16."""
    flat = {}
    for name, key in _npz_keys(model).items():
        arr = model.state_dict()[name].detach().float().cpu().numpy()
        half = arr.astype(np.float16)
        if not np.isfinite(half).all():
            raise ValueError(f"save_params_npz: non-finite values after the "
                             f"fp16 cast in {key} (fp32 max abs "
                             f"{np.abs(arr).max():.3e})")
        flat[key] = half
    np.savez_compressed(path, **flat)


def load_params_npz(model: nn.Module, path: str,
                    strict: bool = True) -> dict:
    """The npz's values for every entry of `model`'s state dict, in the
    model's types, as a state dict for `model.load_state_dict`.

    strict=False keeps the model's own value for an entry the npz lacks
    (a checkpoint written before the model grew it, e.g. the BNNeck). A
    shape mismatch always raises, naming both shapes. Extra npz entries
    (train-only heads) are ignored. (The JAX loader's `key_filter`, a
    warm start for training, waits for the trainer.)"""
    data = np.load(path)
    state = model.state_dict()
    out, missing = {}, []
    for name, key in _npz_keys(model).items():
        current = state[name]
        if key not in data:
            if strict:
                raise KeyError(f"npz checkpoint missing param {key}")
            missing.append(key)
            out[name] = current
            continue
        arr = data[key]
        if tuple(arr.shape) != tuple(current.shape):
            raise ValueError(
                f"npz checkpoint shape mismatch at {key}: checkpoint "
                f"{tuple(arr.shape)} vs model {tuple(current.shape)}")
        out[name] = torch.as_tensor(arr.astype(np.float32)).to(current.dtype)
    if missing:
        print(f"load_params_npz: {len(missing)} params not in {path}, "
              f"kept the model's values: {missing[:6]}"
              + (" ..." if len(missing) > 6 else ""))
    return out


def flat_npz_to_tree(path: str) -> dict:
    """Template-free load: the nested parameter dict straight from the
    npz's key paths; fp16 leaves come back fp32."""
    data = np.load(path)
    tree: dict = {}
    for key in data.files:
        parts = re.findall(r"\['([^']+)'\]", key)
        if not parts:
            raise ValueError(f"unparseable npz key {key!r}")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        arr = data[key]
        if arr.dtype == np.float16:
            arr = arr.astype(np.float32)
        node[parts[-1]] = arr
    return tree


def params_from_jax(variables: dict, model: nn.Module) -> dict:
    """A flax variables tree of the JAX module ({"params": ...,
    "batch_stats": ...}, numpy or jax arrays) as `model`'s state dict.
    Every entry of the model must be in the tree; tree entries the model
    does not have (train-only heads) are ignored."""
    out = {}
    state = model.state_dict()
    for name, key in _npz_keys(model).items():
        node = variables
        for part in re.findall(r"\['([^']+)'\]", key):
            if part not in node:
                raise KeyError(f"the JAX tree has no {key}")
            node = node[part]
        arr = np.array(node, np.float32)
        if arr.shape != tuple(state[name].shape):
            raise ValueError(f"{key}: JAX {arr.shape} vs port "
                             f"{tuple(state[name].shape)}")
        out[name] = torch.as_tensor(arr).to(state[name].dtype)
    return out
