"""Depth-image backprojection with the reference's centered-pixel convention
(counterpart of `instance_based_loc_tpu/ops/backprojection.py`).

The reference unprojects with a *centered* pixel grid rather than an
optical-center intrinsic:

    horizontal = linspace(-cols/2, cols/2, cols)   # per column
    vertical   = linspace( rows/2, -rows/2, rows)  # per row (y points up)
    X = horizontal * depth / fx,  Y = vertical * depth / fy,  Z = depth

and drops z == 0 points.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def centered_pixel_grid(rows: int, cols: int, device="cpu"):
    """The reference's linspace grid: (1, cols) horizontal, (rows, 1)
    vertical. Cached per shape and device, so a captured query program
    copies nothing from the host."""
    horizontal = torch.as_tensor(
        np.linspace(-cols / 2, cols / 2, cols).astype(np.float32),
        device=device)
    vertical = torch.as_tensor(
        np.linspace(rows / 2, -rows / 2, rows).astype(np.float32),
        device=device)
    return horizontal[None, :], vertical[:, None]


def backproject(depth: torch.Tensor, fx: float, fy: float):
    """Unproject a (rows, cols) depth image.

    Returns (points (rows*cols, 3) float32 in the reference camera frame,
    valid (rows*cols,) where depth != 0)."""
    rows, cols = depth.shape
    depth = depth.float()
    horizontal, vertical = centered_pixel_grid(rows, cols, depth.device)
    x = horizontal * depth / fx
    y = vertical * depth / fy
    points = torch.stack([x, y, depth], dim=-1).reshape(-1, 3)
    return points, (depth != 0).reshape(-1)
