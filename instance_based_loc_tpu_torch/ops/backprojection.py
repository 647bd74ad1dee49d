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

from .. import resolve_device
from .outliers import DEFAULT_OUTLIER_REMOVAL_CONFIG, radius_outlier_keep_mask
from .pointcloud import PointCloud


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


def _inputs(depth, device, *others):
    """depth and `others` as tensors on depth's device when depth is a
    tensor, else on `device` (the card by default)."""
    dev = depth.device if isinstance(depth, torch.Tensor) else \
        resolve_device(device)
    return [torch.as_tensor(x if isinstance(x, torch.Tensor)
                            else np.asarray(x), device=dev)
            for x in (depth, *others)]


def pointcloud_from_depth(depth, fx: float, fy: float, rgb=None,
                          outlier_removal_config: dict | None =
                          DEFAULT_OUTLIER_REMOVAL_CONFIG,
                          device="cuda") -> PointCloud:
    """The reference's `get_(coloured_)pointcloud_from_depth`: backproject,
    drop z == 0, optionally radius-outlier-filter. The cloud keeps all
    rows * cols rows with a validity mask. Runs on `depth`'s device when it
    is a tensor, else on `device`."""
    depth_t, = _inputs(depth, device)
    points, valid = backproject(depth_t, fx, fy)
    if rgb is not None:
        colors = (_inputs(depth_t, device, rgb)[1].float() / 255.0
                  ).reshape(-1, 3)
    else:
        colors = torch.zeros_like(points)
    if outlier_removal_config is not None:
        valid = radius_outlier_keep_mask(
            points, valid, radius=outlier_removal_config["radius"],
            nb_points=outlier_removal_config["radius_nb_points"])
    return PointCloud(points, colors, valid)


def mask_pointclouds_from_depth(depth, rgb, masks, fx: float, fy: float,
                                apply_outlier_removal: bool = True,
                                radius: float = 0.05,
                                radius_nb_points: int = 12,
                                device="cuda") -> PointCloud:
    """Every mask's cloud at once (the reference's per-mask loop).

    depth (rows, cols) already divided by the depth factor; rgb (rows,
    cols, 3) u8 or float; masks (M, rows, cols) bool or 0/1. Returns a
    batched PointCloud: points and colors (M, P, 3) (every mask's rows are
    the frame's P = rows * cols points), mask (M, P). The radius outlier
    filter runs per mask (`radius_outlier_keep_mask` over all masks in one
    call). Runs on `depth`'s device when it is a tensor, else on
    `device`."""
    depth_t, rgb_t, m = _inputs(depth, device, rgb, masks)
    points, valid = backproject(depth_t, fx, fy)
    colors = (rgb_t.float() / 255.0).reshape(-1, 3)
    m = m.reshape(m.shape[0], -1).bool()
    per_mask = m & valid[None, :]
    if apply_outlier_removal:
        per_mask = radius_outlier_keep_mask(points, per_mask, radius,
                                            radius_nb_points)
    n = per_mask.shape[0]
    return PointCloud(points[None].expand(n, -1, -1),
                      colors[None].expand(n, -1, -1), per_mask)
