"""DATOR data (counterpart of `instance_based_loc_tpu/models/dator/data.py`):
crop preprocessing (`preprocess_rgb`, `preprocess_depth`), the
dir-per-instance ReID dataset scan (`scan_instance_dirs`, the layout
`ObjectDatasetMemory.dump_dataset` and `cli.gen_synth_reid` write) and the
P x K identity sampler (`PKSampler`), whose batches, for a seed and an
epoch, are the JAX package's index for index (the same numpy generator
draws in the same order).

The JAX package resizes with PIL's bilinear filter, which the card's
machine does not have. `pil_resize` is PIL's algorithm (Resample.c) in
numpy: per axis, a triangle filter widened by the downscale factor, its
weights normalised per output pixel; the horizontal pass runs first. For
8-bit images the weights are fixed point with 22 fraction bits and each
pass rounds and clips to uint8, as PIL's does; for float32 ("F") images the
sums run in float64, tap by tap in PIL's order, and each pass stores
float32. The outputs equal PIL's bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from collections import defaultdict

import numpy as np

from ...utils.png import read_png

_PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=64)
def _coefficients(in_size: int, out_size: int):
    """PIL's `precompute_coeffs` for the bilinear filter over the whole
    input: (xmin (out,), weights (out, ksize) float64, zero past each
    pixel's taps). Cached per size pair (read-only arrays): a dataset's
    crops share a few sizes."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax)
        w = np.maximum(1.0 - np.abs((x + xmin - center + 0.5) * ss), 0.0)
        ww = 0.0
        for v in w:          # PIL sums the weights in order
            ww += v
        kk[xx, :xmax] = w / ww if ww != 0.0 else w
        xmins[xx] = xmin
    xmins.setflags(write=False)
    kk.setflags(write=False)
    return xmins, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One PIL pass along `axis` (0 rows, 1 columns) of an (H, W[, C])
    uint8 or float32 image."""
    in_size = img.shape[axis]
    xmins, kk = _coefficients(in_size, out_size)
    src = np.moveaxis(img, axis, 0)
    ksize = kk.shape[1]
    # tap t of output pixel o reads input xmin[o] + t (clipped; its weight
    # is zero past the pixel's taps)
    idx = np.minimum(xmins[:, None] + np.arange(ksize)[None, :], in_size - 1)
    if img.dtype == np.uint8:
        k = np.where(kk < 0, (-0.5 + kk * (1 << _PRECISION_BITS)),
                     (0.5 + kk * (1 << _PRECISION_BITS))).astype(np.int64)
        acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                      np.int64)
        for t in range(ksize):
            w = k[:, t].reshape((out_size,) + (1,) * (src.ndim - 1))
            acc += src[idx[:, t]].astype(np.int64) * w
        out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    elif img.dtype == np.float32:
        acc = np.zeros((out_size,) + src.shape[1:], np.float64)
        for t in range(ksize):
            w = kk[:, t].reshape((out_size,) + (1,) * (src.ndim - 1))
            acc += src[idx[:, t]].astype(np.float64) * w
        out = acc.astype(np.float32)
    else:
        raise ValueError(f"pil_resize takes uint8 or float32, got {img.dtype}")
    return np.moveaxis(out, 0, axis)


def pil_resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`Image.fromarray(img).resize((width, height), Image.BILINEAR)` as an
    array: img (H, W, 3) uint8 or (H, W) float32."""
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    return img


def preprocess_rgb(rgb: np.ndarray, height: int = 256,
                   width: int = 128) -> np.ndarray:
    """Resize + normalize mean/std .5 (val_transforms, get_embeds.py:80-87)."""
    img = pil_resize(np.asarray(rgb).astype(np.uint8), width, height)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - 0.5) / 0.5


def preprocess_depth(depth: np.ndarray, height: int = 256, width: int = 128,
                     clip_max: float = 50.0) -> np.ndarray:
    """The reference depth recipe (bases.py:93-135): grayscale -> resize ->
    clip [0, clip_max] -> scale to [-1, 1] -> 3 channels."""
    d = np.asarray(depth, np.float32)
    if d.ndim == 3:
        d = d.mean(-1)
    d = np.clip(pil_resize(d, width, height), 0.0, clip_max)
    d = d / clip_max * 2.0 - 1.0
    return np.repeat(d[..., None], 3, axis=-1)


@dataclasses.dataclass
class ReIDSample:
    rgb_path: str
    depth_path: str
    pid: int
    cam_id: int = 0


def scan_instance_dirs(root: str) -> list[ReIDSample]:
    """root/<instance>/<name>_rgb.png with <name>_depth.npy (or .png); the
    identity index is the instance directory's rank in sorted order."""
    samples = []
    pids = sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))
    for pid_idx, pid_dir in enumerate(pids):
        full = os.path.join(root, pid_dir)
        for f in sorted(os.listdir(full)):
            if f.endswith("_rgb.png") or f.endswith("_rgb.jpg"):
                stem = f.rsplit("_rgb.", 1)[0]
                for ext in ("npy", "png"):
                    dp = os.path.join(full, f"{stem}_depth.{ext}")
                    if os.path.exists(dp):
                        samples.append(ReIDSample(os.path.join(full, f), dp,
                                                  pid_idx))
                        break
    return samples


class PKSampler:
    """P identities x K instances per batch (reference datasets/sampler.py),
    deterministic for a (seed, epoch)."""

    def __init__(self, samples: list[ReIDSample], batch_size: int,
                 num_instances: int, seed: int = 0):
        if batch_size % num_instances:
            raise ValueError(f"batch_size {batch_size} is not a multiple of "
                             f"num_instances {num_instances}")
        self.samples = samples
        self.k = num_instances
        self.p = batch_size // num_instances
        self.seed = seed
        self.by_pid: dict[int, list[int]] = defaultdict(list)
        for i, s in enumerate(samples):
            self.by_pid[s.pid].append(i)

    def epoch_batches(self, epoch: int) -> list[list[int]]:
        rng = np.random.default_rng((self.seed, epoch))
        buckets = {}
        for pid, idxs in self.by_pid.items():
            idxs = list(idxs)
            rng.shuffle(idxs)
            # pad to a multiple of K by resampling (the reference resamples
            # with replacement when an identity has fewer than K instances)
            while len(idxs) % self.k != 0 or len(idxs) < self.k:
                idxs.append(int(rng.choice(self.by_pid[pid])))
            buckets[pid] = [idxs[i:i + self.k]
                            for i in range(0, len(idxs), self.k)]
        # each batch draws P distinct identities and one K-chunk of each
        remaining = {pid: list(cs) for pid, cs in buckets.items()}
        batches = []
        while sum(1 for cs in remaining.values() if cs) >= self.p:
            avail = sorted(pid for pid, cs in remaining.items() if cs)
            chosen = rng.choice(len(avail), size=self.p, replace=False)
            batch = []
            for ci in chosen:
                batch += remaining[avail[ci]].pop()
            batches.append(batch)
        return batches

    def load_all(self, height: int = 256, width: int = 128):
        """The whole dataset as quantised arrays (u8 rgb (N, H, W, 3), u16
        depth (N, H, W), i32 pids), for training from a device-resident
        dataset."""
        return self.load_batch(list(range(len(self.samples))), height,
                               width, quantize=True)

    def load_batch(self, batch_idxs: list[int], height: int = 256,
                   width: int = 128, quantize: bool = False):
        """Normalised fp32 rgb and 3-channel depth (B, H, W, 3), or with
        quantize=True u8 rgb (B, H, W, 3) and u16 depth (B, H, W) for
        `train.dequantize_batch`; plus i32 pids. The bytes are the JAX
        package's (PIL's resize, reproduced by `pil_resize`)."""
        rgbs, depths, pids = [], [], []
        for i in batch_idxs:
            s = self.samples[i]
            rgb = read_png(s.rgb_path)[..., :3]
            if s.depth_path.endswith(".npy"):
                depth = np.load(s.depth_path)
            else:
                depth = read_png(s.depth_path)
            if quantize:
                rgbs.append(pil_resize(rgb.astype(np.uint8), width, height))
                d = np.asarray(depth, np.float32)
                if d.ndim == 3:
                    d = d.mean(-1)
                d = np.clip(pil_resize(d, width, height), 0.0, 50.0)
                depths.append(np.round(d * (65535.0 / 50.0))
                              .astype(np.uint16))
            else:
                rgbs.append(preprocess_rgb(rgb, height, width))
                depths.append(preprocess_depth(depth, height, width))
            pids.append(s.pid)
        return (np.stack(rgbs), np.stack(depths),
                np.asarray(pids, np.int32))
