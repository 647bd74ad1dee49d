"""DATOR as a localisation embedder (counterpart of
`instance_based_loc_tpu/models/dator/embedder.py`): a FourDNet, trained or
seeded at random, embeds each detection's (RGB crop, depth crop) pair, in
batches of `max_crops`."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ... import resolve_device
from ..precision import resolve_compute_dtype
from .data import preprocess_depth, preprocess_rgb
from .fourdnet import FourDNet, FourDNetConfig, init_params
from .train import load_params_npz
from .transreid_vit import TransReIDConfig

MAX_CROPS = 16


def default_config(dtype: torch.dtype | None = None) -> FourDNetConfig:
    """The served FourDNet: two ViT-B/16 towers at 256x128 in local_feature
    mode, reduced_dim 128, BNNeck, computing in `dtype` (the cascade's
    precision policy: bf16 unless IBL_MODEL_DTYPE says otherwise)."""
    dtype = resolve_compute_dtype(dtype)
    return FourDNetConfig(backbone=TransReIDConfig(local_feature=True,
                                                   dtype=dtype),
                          dtype=dtype)


def _npz_num_classes(path: str) -> int | None:
    flat = np.load(path)
    for key in flat.files:
        if "classifier" in key and "kernel" in key and "aux" not in key \
                and "token" not in key:
            return int(flat[key].shape[-1])
    return None


def build_dator_embedder(checkpoint_path: str | None = None,
                         model_cfg: FourDNetConfig | None = None,
                         height: int = 256, width: int = 128,
                         max_crops: int = MAX_CROPS,
                         feature: str | None = None, device="cuda"):
    """The batched embed callable ObjectMemory takes. The depth crop is cut
    from the full depth image by the detection's box, as the reference does
    (utils/embeddings.py:112-117).

    checkpoint_path: a flat `.npz` (the JAX package's `save_params_npz`;
    the head's class count is taken from the file, and entries the file
    lacks, such as an old checkpoint's BNNeck, keep their init); None gives
    random weights from seed 0, the same on every build. feature: "embedding" (the reference's
    128-d output, the default, also via IBL_DATOR_FEATURE) or "cls" (the
    L2-normalised concatenation of the two towers' class tokens).
    `embed.batches` counts the crop batches run and `embed.model` is the
    FourDNet."""
    feature = feature or os.environ.get("IBL_DATOR_FEATURE", "embedding")
    if feature not in ("embedding", "cls"):
        raise ValueError(f"feature must be 'embedding' or 'cls', got "
                         f"{feature!r}")
    cfg = model_cfg or default_config()
    dev = resolve_device(device)
    if checkpoint_path is not None and not checkpoint_path.endswith(".npz"):
        raise ValueError(
            f"{checkpoint_path}: only flat .npz checkpoints are read (orbax "
            f"directories are not); write one with the JAX package's "
            f"models.dator.train.save_params_npz")
    if checkpoint_path is not None:
        n_cls = _npz_num_classes(checkpoint_path)
        if n_cls is not None and n_cls != cfg.num_classes:
            cfg = dataclasses.replace(cfg, num_classes=n_cls)
    with torch.device(dev):
        model = FourDNet(cfg)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    if checkpoint_path is not None:
        model.load_state_dict(load_params_npz(model, checkpoint_path,
                                              strict=False))
    model.eval()

    @torch.no_grad()
    def embed(detections, full_rgb_image=None, full_depth_image=None, **_):
        n = len(detections)
        dim = (cfg.reduced_dim if feature == "embedding"
               else 2 * cfg.backbone.hidden_size)
        if n == 0:
            return np.zeros((0, dim), np.float32)
        full_depth = np.asarray(full_depth_image)
        outs = []
        for start in range(0, n, max_crops):
            idxs = range(start, min(start + max_crops, n))
            rgbs = np.zeros((max_crops, height, width, 3), np.float32)
            depths = np.zeros((max_crops, height, width, 3), np.float32)
            for slot, i in enumerate(idxs):
                x1, y1, x2, y2 = detections.boxes_xyxy[i].astype(int)
                depth_crop = full_depth[max(y1, 0):max(y2, y1 + 1),
                                        max(x1, 0):max(x2, x1 + 1)]
                if depth_crop.size == 0:
                    depth_crop = np.zeros((2, 2), np.float32)
                rgbs[slot] = preprocess_rgb(detections.crops[i], height, width)
                depths[slot] = preprocess_depth(depth_crop, height, width)
            rgb_b = torch.from_numpy(rgbs).to(dev)
            depth_b = torch.from_numpy(depths).to(dev)
            if feature == "cls":
                _, _, (rc, dc) = model(rgb_b, depth_b, return_cls_tokens=True)
                rc = rc / (torch.linalg.norm(rc, dim=-1, keepdim=True) + 1e-8)
                dc = dc / (torch.linalg.norm(dc, dim=-1, keepdim=True) + 1e-8)
                feats = torch.cat([rc, dc], dim=-1)
            else:
                _, feats = model(rgb_b, depth_b)
            outs.append(feats[:len(idxs)].float().cpu().numpy())
            embed.batches += 1
        return np.concatenate(outs)

    embed.batches = 0
    embed.model = model
    return embed
