"""Surface normal estimation (counterpart of
`instance_based_loc_tpu/ops/normals.py`; replaces Open3D's
`estimate_normals` with KDTreeSearchParamHybrid(radius, max_nn)).

Brute-force K nearest neighbours from pairwise distances, the neighbourhood
covariance, and the closed-form 3x3 eigensolver: the normal is the
smallest-eigenvalue eigenvector. A radius mask reproduces Open3D's
radius-AND-max_nn semantics. Batched over leading dimensions.
"""

from __future__ import annotations

import torch

from .distance import f32_sq, pairwise_sq_dists
from .eigen3 import eigh3x3
from .pointcloud import gather_rows


def knn_hybrid(points: torch.Tensor, mask: torch.Tensor, radius: float,
               k: int = 30):
    """For each point, up to `k` nearest valid points within `radius` (self
    included, as Open3D's search returns the query too).

    points (..., N, 3), mask (..., N). Returns (idx (..., N, k) int64,
    neighbor_mask (..., N, k) bool)."""
    big = 1e30
    d2 = pairwise_sq_dists(points, points)
    d2 = torch.where(mask[..., None, :], d2, torch.full_like(d2, big))
    d2k, idx = torch.topk(d2, min(k, points.shape[-2]), dim=-1,
                          largest=False, sorted=True)
    ok = (d2k <= f32_sq(radius)) & (d2k < big / 2) & mask[..., None]
    return idx, ok


def estimate_normals(points: torch.Tensor, mask: torch.Tensor, radius: float,
                     max_nn: int = 30) -> torch.Tensor:
    """Per-point unit normals from the neighbourhood covariance, oriented
    towards the origin (a camera at the world origin); neighbourhoods of
    fewer than 3 points give (0, 0, 1)."""
    idx, ok = knn_hybrid(points, mask, radius, k=max_nn)
    nbrs = gather_rows(points, idx)                           # (..., N, k, 3)
    w = ok.to(points.dtype)[..., None]
    count = torch.clamp(torch.sum(w, dim=-2), min=1.0)        # (..., N, 1)
    mean = torch.sum(nbrs * w, dim=-2) / count
    centered = (nbrs - mean[..., None, :]) * w
    cov = torch.einsum("...ki,...kj->...ij", centered, centered) / count[..., None]
    _, vecs = eigh3x3(cov)
    normal = vecs[..., 0]

    degenerate = torch.sum(ok, dim=-1) < 3
    ez = torch.zeros_like(normal)
    ez[..., 2] = 1.0
    normal = torch.where(degenerate[..., None], ez, normal)
    flip = torch.sum(normal * points, dim=-1) > 0
    normal = torch.where(flip[..., None], -normal, normal)
    norm = torch.linalg.norm(normal, dim=-1, keepdim=True)
    return normal / torch.clamp(norm, min=1e-12)
