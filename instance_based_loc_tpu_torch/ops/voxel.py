"""Colour-preserving voxel downsampling on the host (counterpart of
`instance_based_loc_tpu/ops/voxel.py:voxel_downsample_numpy`, its exact
numpy path).

Points are binned by floor(p / voxel) and each occupied voxel becomes the
mean of its points and colours. Output order is sorted by voxel coordinate.
"""

from __future__ import annotations

import numpy as np


def voxel_downsample_numpy(points, colors, voxel_size):
    """Returns (points (K, 3), colors (K, 3)) float32, one row per occupied
    voxel."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    colors = (np.zeros_like(points) if colors is None
              else np.asarray(colors, np.float32).reshape(-1, 3))
    if len(points) == 0:
        return points, colors
    keys = np.floor(points / np.float32(voxel_size)).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    k = int(inv.max()) + 1
    counts = np.bincount(inv, minlength=k).astype(np.float32)[:, None]
    sum_pts = np.zeros((k, 3), np.float64)
    sum_cols = np.zeros((k, 3), np.float64)
    np.add.at(sum_pts, inv, points)
    np.add.at(sum_cols, inv, colors)
    return ((sum_pts / counts).astype(np.float32),
            (sum_cols / counts).astype(np.float32))
