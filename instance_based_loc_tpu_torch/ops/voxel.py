"""Colour-preserving voxel downsampling on the host (counterpart of
`instance_based_loc_tpu/ops/voxel.py:voxel_downsample_numpy`, its exact
numpy path).

Points are binned by floor(p / voxel) and each occupied voxel becomes the
mean of its points and colours. Output order is sorted by voxel coordinate.

Each voxel key becomes one int64 code in mixed radix over the keys' extent,
which orders like the rows, so one 1-D `np.unique` and float64
`np.bincount` sums give the reference's rows bit for bit (both add the
points in input order) at a fraction of the row-wise `np.unique` and
`np.add.at` cost. Extents whose code would overflow int64 take the
row-wise path.
"""

from __future__ import annotations

import numpy as np

_INT64_MAX = np.iinfo(np.int64).max


def _voxel_ids(keys: np.ndarray) -> np.ndarray:
    """Rank of each row's key among the distinct keys, in row order."""
    lo = keys.min(0)
    span = [int(x) for x in keys.max(0) - lo + 1]
    if span[0] * span[1] * span[2] > _INT64_MAX:
        _, inv = np.unique(keys, axis=0, return_inverse=True)
        return inv.reshape(-1)
    k = keys - lo
    codes = (k[:, 0] * span[1] + k[:, 1]) * span[2] + k[:, 2]
    _, inv = np.unique(codes, return_inverse=True)
    return inv


def voxel_downsample_numpy(points, colors, voxel_size):
    """Returns (points (K, 3), colors (K, 3)) float32, one row per occupied
    voxel."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    colors = (np.zeros_like(points) if colors is None
              else np.asarray(colors, np.float32).reshape(-1, 3))
    if len(points) == 0:
        return points, colors
    keys = np.floor(points / np.float32(voxel_size)).astype(np.int64)
    inv = _voxel_ids(keys)
    k = int(inv.max()) + 1
    counts = np.bincount(inv, minlength=k).astype(np.float32)[:, None]

    def mean(values):
        sums = np.stack([np.bincount(inv, weights=values[:, c], minlength=k)
                         for c in range(3)], 1)
        return (sums / counts).astype(np.float32)

    return mean(points), mean(colors)
