"""Batched crop embedders on the ViT trunk (counterpart of
`instance_based_loc_tpu/models/vit_embedder.py`).

Preprocessing reproduces what the reference's HF processors do, in torch on
the embedder's device instead of PIL:

| variant | resize | normalize |
|---|---|---|
| vit    | 224x224 bilinear | mean .5, std .5 |
| dinov2 | shortest side 256 bilinear -> centre crop 224 | imagenet mean/std |
| clip   | 224x224 bicubic | CLIP mean/std |

Resizes run PIL's two antialiased passes (horizontal, then vertical) with
`F.interpolate(..., antialias=True)`, rounding and clipping to uint8 values
after each as PIL does. PIL computes in fixed point, so each pass can round
a pixel one uint8 step the other way: |diff| <= 2/255 / std after
normalisation.

Without a checkpoint the trunk gets random weights from seed 0
(`init_params`), the same on every build. `load_params` reads what the JAX
package's loader reads: an HF torch state dict (`.bin` / `.pth` of
ViTModel, Dinov2Model or CLIPVisionModel), or a flat `.npz` whose `params`
entry is the pickled JAX parameter tree with numpy leaves; it also takes a
state dict of this package's ViT (`torch.save` of `model.state_dict()`).
"""

from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from .vit import (VARIANTS, ViT, ViTConfig, init_params, params_from_jax,
                  port_hf_clip_vision_params, port_hf_dinov2_params,
                  port_hf_vit_params)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

_NORMS = {
    "vit": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "dinov2": (IMAGENET_MEAN, IMAGENET_STD),
    "clip": (CLIP_MEAN, CLIP_STD),
}

MAX_CROPS = 16  # crops per ViT batch (the JAX package's padded batch)


def _resize(x: torch.Tensor, h: int, w: int, mode: str) -> torch.Tensor:
    """PIL's resize of a uint8 image: a horizontal then a vertical
    antialiased pass, each rounded and clipped to uint8 values."""
    for size in ((x.shape[-2], w), (h, w)):
        if tuple(x.shape[-2:]) != size:
            x = F.interpolate(x, size=size, mode=mode, align_corners=False,
                              antialias=True)
            x = torch.clamp(torch.round(x), 0.0, 255.0)
    return x


def preprocess_crop(crop, variant: str, size: int = 224,
                    device="cpu") -> torch.Tensor:
    """Resize + normalise one RGB crop (h, w, 3) uint8 -> (size, size, 3)
    float32 on `device`."""
    variant = "dinov2" if variant == "dino" else variant
    x = torch.as_tensor(np.asarray(crop, np.uint8), device=device)
    x = x.permute(2, 0, 1)[None].to(torch.float32)            # (1, 3, h, w)
    if variant == "dinov2":
        h, w = x.shape[-2:]
        scale = 256 / min(w, h)
        nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
        x = _resize(x, nh, nw, "bilinear")
        top, left = (nh - size) // 2, (nw - size) // 2
        x = x[..., top:top + size, left:left + size]
    else:
        x = _resize(x, size, size, "bicubic" if variant == "clip" else "bilinear")
    mean, std = _NORMS[variant]
    mean = torch.tensor(mean, dtype=torch.float32).to(device)
    std = torch.tensor(std, dtype=torch.float32).to(device)
    x = x[0].permute(1, 2, 0) / 255.0
    return (x - mean) / std


_PICKLE_MODULES = ("numpy", "builtins", "collections", "_codecs")


class _NumpyTreeUnpickler(pickle.Unpickler):
    """Unpickles dicts, lists and numpy arrays only: a tree pickled with jax
    or flax objects (a FrozenDict, jax arrays) needs those packages, which
    the card does not have, and no other class is unpickled at all."""

    def find_class(self, module, name):
        if module.split(".")[0] not in _PICKLE_MODULES:
            raise ValueError(
                f"the pickled parameter tree holds a {module}.{name} object; "
                f"only dicts of numpy arrays load without jax and flax "
                f"(re-save the tree with numpy leaves, e.g. "
                f"jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(p)))")
        return super().find_class(module, name)


def read_npz_tree(path: str, entry: str = "params"):
    """The tree pickled into entry `entry` of a flat `.npz` (the JAX
    package's format for ported ViT params and LoRA adapters)."""
    import io
    with np.load(path, allow_pickle=False) as data:
        raw = data[entry].tobytes()
    try:
        return _NumpyTreeUnpickler(io.BytesIO(raw)).load()
    except ValueError as err:
        raise ValueError(f"{path}: {err}") from None


_HF_PORTERS = {"vit": port_hf_vit_params, "dinov2": port_hf_dinov2_params,
               "clip": port_hf_clip_vision_params}


def load_params(model: ViT, cfg: ViTConfig, variant: str,
                checkpoint_path: str | None) -> ViT:
    """Weights into `model`, in place (JAX `vit_embedder.load_params`):
    seeded random weights without a checkpoint; a `.npz` holds the JAX
    parameter tree (`params_from_jax`); any other file is a torch state
    dict, this module's own or an HF one, ported for `variant`."""
    if checkpoint_path is None:
        device = model.pos_embed.device
        init_params(model, torch.Generator(device=device).manual_seed(0))
        return model
    if checkpoint_path.endswith(".npz"):
        sd = params_from_jax(read_npz_tree(checkpoint_path), cfg)
    else:
        sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        if "patch_embed.weight" not in sd:
            key = "dinov2" if variant == "dino" else variant
            sd = _HF_PORTERS[key](sd, cfg)
    model.load_state_dict(sd)
    return model


def build_vit_embedder(variant: str = "vit", checkpoint_path: str | None = None,
                       l2_normalize: bool | None = None,
                       max_crops: int = MAX_CROPS, device="cuda", cfg=None):
    """The batched embed callable ObjectMemory takes. Crops are embedded in
    batches of `max_crops` (zero-padded, as in the JAX package);
    `embed.batches` counts the batches run. `cfg` overrides the variant's
    configuration (the tests use a narrow trunk)."""
    key = "dinov2" if variant == "dino" else variant
    cfg = VARIANTS[key] if cfg is None else cfg
    dev = resolve_device(device)
    with torch.device(dev):
        model = ViT(cfg)
    load_params(model, cfg, variant, checkpoint_path).eval()
    if l2_normalize is None:
        l2_normalize = key == "clip"   # the reference normalises CLIP only

    @torch.no_grad()
    def embed(detections, full_rgb_image=None, **_):
        crops = detections.crops
        n = len(crops)
        if n == 0:
            return np.zeros((0, cfg.projection_dim or cfg.hidden_size),
                            np.float32)
        outs = []
        for start in range(0, n, max_crops):
            chunk = crops[start:start + max_crops]
            batch = torch.zeros((max_crops, cfg.image_size, cfg.image_size, 3),
                                device=dev)
            for i, crop in enumerate(chunk):
                batch[i] = preprocess_crop(crop, key, cfg.image_size, dev)
            cls, _ = model(batch)
            if l2_normalize:
                cls = cls / torch.clamp(torch.linalg.norm(cls, dim=-1,
                                                          keepdim=True),
                                        min=1e-12)
            outs.append(cls[:len(chunk)])
            embed.batches += 1
        return torch.cat(outs).cpu().numpy()

    embed.batches = 0
    embed.model = model
    return embed
