"""DATOR crop preprocessing (counterpart of `preprocess_rgb` and
`preprocess_depth` in `instance_based_loc_tpu/models/dator/data.py`; the
ReID dataset and sampler wait for training).

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

import numpy as np

_PRECISION_BITS = 32 - 8 - 2


def _coefficients(in_size: int, out_size: int):
    """PIL's `precompute_coeffs` for the bilinear filter over the whole
    input: (xmin (out,), weights (out, ksize) float64, zero past each
    pixel's taps)."""
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
