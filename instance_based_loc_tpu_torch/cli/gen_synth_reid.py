"""Procedural reference-scale ReID dataset generator (counterpart of
`instance_based_loc_tpu/cli/gen_synth_reid.py`; the same files, PNG
written by the port's codec).

The reference trains DATOR on RealSense scans of lab objects: hundreds of
identities, thousands of RGB+depth crop pairs, dir-per-instance layout
(reference dator/datasets/realsense.py:29-96). This writes a procedural
stand-in at the same scale and layout: each identity is a parametric
textured object (palette, pattern frequency/orientation, silhouette)
rendered under nuisance variation (viewpoint squash/shift, illumination
gain, sensor noise, background clutter) with a correlated smooth depth
map. Identity is recoverable only from appearance+shape: the ReID task is
real, the pixels are synthetic.

    python -m instance_based_loc_tpu_torch.cli.gen_synth_reid \
        --out /tmp/reid300 --ids 300 --train-per-id 12 --val-per-id 2 \
        --test-per-id 2

The output layout is the one models/dator/data.py scan_instance_dirs reads:
    out/{train,val,test}/id_####/s###_rgb.png + s###_depth.npy
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.synthetic import _identity_params
from ..utils.png import write_png


def _render(idp: dict, rng: np.random.Generator, h: int, w: int):
    """One (rgb u8 (h,w,3), depth f32 (h,w) meters) sample of an identity
    under nuisance variation."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    # viewpoint nuisances: horizontal squash (azimuth), in-plane shift
    squash = rng.uniform(0.75, 1.0)
    dx, dy = rng.uniform(-0.15, 0.15, 2)
    u = (xx - dx) / (idp["aspect"] * squash)
    v = (yy - dy) / 0.92
    sil = (np.abs(u) ** idp["round"] + np.abs(v) ** idp["round"]) <= 1.0

    # identity texture in object coordinates (phase jitters per sample)
    ca, sa = np.cos(idp["angle"]), np.sin(idp["angle"])
    t = (u * ca + v * sa) * idp["freq"] + rng.uniform(0, 2 * np.pi)
    if idp["kind"] == 0:
        pat = 0.5 + 0.5 * np.sin(t)
    elif idp["kind"] == 1:
        t2 = (-u * sa + v * ca) * idp["freq"] + rng.uniform(0, 2 * np.pi)
        pat = ((np.sin(t) > 0) ^ (np.sin(t2) > 0)).astype(np.float32)
    else:
        pat = 0.5 + 0.5 * np.sin(np.hypot(u, v) * idp["freq"] * 2.0)
    rgb = (idp["base"][None, None] * pat[..., None]
           + idp["second"][None, None] * (1.0 - pat[..., None]))

    # background clutter + illumination + sensor noise
    bg = rng.uniform(0.0, 1.0, 3)[None, None] * np.ones((h, w, 1))
    bg += rng.normal(0, 0.08, (h, w, 3))
    img = np.where(sil[..., None], rgb, bg)
    img = img * rng.uniform(0.6, 1.3) + rng.uniform(-0.08, 0.08)
    img += rng.normal(0, 0.02, img.shape)
    rgb_u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)

    # depth: smooth relief over the silhouette, background farther
    r2 = np.clip(np.abs(u) ** 2 + np.abs(v) ** 2, 0, 1)
    relief = idp["depth0"] - idp["bulge"] * np.sqrt(np.clip(1 - r2, 0, 1))
    depth = np.where(sil, relief, idp["depth0"] + rng.uniform(0.7, 2.0))
    depth = depth + rng.normal(0, 0.004, depth.shape)   # sensor noise
    return rgb_u8, depth.astype(np.float32)


def generate(out: str, ids: int, train_per_id: int, val_per_id: int,
             test_per_id: int, h: int, w: int, seed: int):
    master = np.random.default_rng(seed)
    counts = {"train": train_per_id, "val": val_per_id, "test": test_per_id}
    total = 0
    for i in range(ids):
        idp = _identity_params(master)
        per_id_rng = np.random.default_rng(seed * 100003 + i)
        for split, n in counts.items():
            d = os.path.join(out, split, f"id_{i:04d}")
            os.makedirs(d, exist_ok=True)
            for s in range(n):
                rgb, depth = _render(idp, per_id_rng, h, w)
                write_png(os.path.join(d, f"s{s:03d}_rgb.png"), rgb)
                np.save(os.path.join(d, f"s{s:03d}_depth.npy"), depth)
                total += 1
    return total


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--ids", type=int, default=300)
    p.add_argument("--train-per-id", type=int, default=12)
    p.add_argument("--val-per-id", type=int, default=2)
    p.add_argument("--test-per-id", type=int, default=2)
    p.add_argument("--height", type=int, default=192,
                   help="source crop height (loader resizes to cfg size)")
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    n = generate(args.out, args.ids, args.train_per_id, args.val_per_id,
                 args.test_per_id, args.height, args.width, args.seed)
    print(f"wrote {n} samples / {args.ids} identities under {args.out}")


if __name__ == "__main__":
    main()
