"""Radius outlier removal (counterpart of
`instance_based_loc_tpu/ops/outliers.py`; replaces Open3D's
`remove_radius_outlier`).

Exact brute-force neighbour counting, tiled so peak memory stays
O(ROW_TILE * COL_TILE). A point is kept when at least `nb_points` valid
points (itself included) lie within `radius`, as in Open3D.
"""

from __future__ import annotations

import torch

from .distance import f32_sq, pairwise_sq_dists

DEFAULT_OUTLIER_REMOVAL_CONFIG = {
    "radius_nb_points": 12,
    "radius": 0.05,
}

ROW_TILE, COL_TILE = 2048, 16384   # one (rows, cols) block is 128 MB in fp32


def radius_neighbor_counts(points: torch.Tensor, masks: torch.Tensor,
                           radius: float) -> torch.Tensor:
    """Per mask, the number of its points within `radius` of each point.

    points (N, 3); masks (M, N) or (N,) bool. Returns int32 counts of the
    masks' shape. Only points inside some mask are compared: a count of a
    point outside mask m is never read (`radius_outlier_keep_mask` ands it
    with the mask), and a point outside every mask adds to no count."""
    squeeze = masks.dim() == 1
    masks = masks.reshape(-1, masks.shape[-1])
    sel = torch.nonzero(masks.any(dim=0)).squeeze(-1)
    pts = points[sel].float()
    msk = masks[:, sel].float()                       # (M, n)
    r2 = f32_sq(radius)
    counts_sel = torch.zeros(masks.shape[0], len(sel), dtype=torch.float32,
                             device=points.device)
    for r0 in range(0, len(sel), ROW_TILE):
        rows = pts[r0:r0 + ROW_TILE]
        acc = counts_sel[:, r0:r0 + ROW_TILE]
        for c0 in range(0, len(sel), COL_TILE):
            within = pairwise_sq_dists(rows, pts[c0:c0 + COL_TILE],
                                       clamp=False) <= r2
            acc += msk[:, c0:c0 + COL_TILE] @ within.float().T
    counts = torch.zeros(masks.shape, dtype=torch.int32, device=points.device)
    counts[:, sel] = counts_sel.round().to(torch.int32)
    return counts[0] if squeeze else counts


def radius_outlier_keep_mask(points: torch.Tensor, masks: torch.Tensor,
                             radius: float, nb_points: int) -> torch.Tensor:
    """True for points of each mask that survive radius-outlier removal."""
    counts = radius_neighbor_counts(points, masks, radius)
    return masks & (counts >= nb_points)


def remove_radius_outliers(cloud, radius: float | None = None,
                           nb_points: int | None = None,
                           config: dict | None = None):
    """`PointCloud` form of `radius_outlier_keep_mask` (the reference's
    call sites); `config` is a DEFAULT_OUTLIER_REMOVAL_CONFIG-style dict."""
    from .pointcloud import PointCloud
    if config is not None:
        radius = config["radius"]
        nb_points = config["radius_nb_points"]
    keep = radius_outlier_keep_mask(cloud.points, cloud.mask, radius,
                                    nb_points)
    return PointCloud(cloud.points, cloud.colors, keep)
