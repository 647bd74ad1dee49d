"""Embedder registry (counterpart of
`instance_based_loc_tpu/models/embedders.py`).

Embedders are factories returning one batched callable:

    embed(detections, full_rgb_image, full_depth_image, consider_floor)
        -> np.ndarray (M, E)

Keys mirror the reference CLI (`--embeddings {clip,dino,vit,dator}`) plus
the weights-free test embedders (`dummy`, `color`).
"""

from __future__ import annotations

import numpy as np

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_embedder(name: str, **kwargs):
    """Build the named embedder; returns the batched callable."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown embedder '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


@register("dummy")
def _dummy(**_kwargs):
    """Constant embedding per detection (the reference's dummy_get_embs)."""
    def embed(detections, **_):
        return np.tile(np.array([1.0, 2.0, 3.0], np.float32),
                       (len(detections), 1))
    return embed


@register("color")
def _color(bins: int = 8, **_kwargs):
    """Masked colour histogram (bins^3-dim, L2-normalised): the weights-free
    embedder of the end-to-end tests."""
    def embed(detections, full_rgb_image, **_):
        img = np.asarray(full_rgb_image, np.float32) / 255.0
        dim = bins ** 3
        out = np.zeros((len(detections), dim), np.float32)
        for i, mask in enumerate(np.asarray(detections.masks)):
            sel = img[mask.astype(bool)]
            if not len(sel):
                continue
            idx = np.clip((sel * bins).astype(int), 0, bins - 1)
            flat = idx[:, 0] * bins * bins + idx[:, 1] * bins + idx[:, 2]
            hist = np.bincount(flat, minlength=dim).astype(np.float32)
            out[i] = hist / max(np.linalg.norm(hist), 1e-6)
        return out
    return embed


def _vit_factory(variant):
    def build(checkpoint_path: str | None = None, **kwargs):
        from .vit_embedder import build_vit_embedder
        return build_vit_embedder(variant=variant,
                                  checkpoint_path=checkpoint_path, **kwargs)
    return build


for _name in ("vit", "dino", "clip"):
    register(_name)(_vit_factory(_name))


@register("dator")
def _dator(checkpoint_path: str | None = None, **kwargs):
    """The DATOR (FourDNet) RGB-D embedder; `checkpoint_path` is a flat
    .npz checkpoint (models/dator/embedder.py)."""
    from .dator.embedder import build_dator_embedder
    return build_dator_embedder(checkpoint_path=checkpoint_path, **kwargs)
