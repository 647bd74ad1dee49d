"""Fast Point Feature Histograms, 33-dim (counterpart of
`instance_based_loc_tpu/ops/fpfh.py`; replaces Open3D's
`compute_fpfh_feature` with KDTreeSearchParamHybrid(5 * voxel, max_nn)).

Rusu's FPFH with the PCL/Open3D pair features over the hybrid neighbourhood:
with d = p_t - p_s, swap (s, t) if |n_s . d| < |n_t . d|; u = n_s,
v = unit(d x u), w = u x v; f1 = v . n_t, f3 = u . d/|d|,
f4 = atan2(w . n_t, u . n_t). SPFH bins each into 11 bins with weight
100/(k-1); FPFH(p) = SPFH(p) + (1/k) sum_q SPFH(q) / |p - q|, normalised to
sum 100 (the reference's documented simplification). Batched over leading
dimensions.
"""

from __future__ import annotations

import torch

from .normals import knn_hybrid
from .pointcloud import gather_rows

FPFH_BINS = 11
FPFH_DIM = 3 * FPFH_BINS


def _pair_features(p_s, n_s, p_t, n_t):
    """PCL pair features (f1, f3, f4) and |d| for broadcastable (..., 3)."""
    d = p_t - p_s
    dist = torch.linalg.norm(d, dim=-1, keepdim=True)
    dsafe = torch.where(dist > 1e-12, d / torch.clamp(dist, min=1e-12),
                        torch.zeros_like(d))
    a_s = torch.abs(torch.sum(n_s * dsafe, dim=-1))
    a_t = torch.abs(torch.sum(n_t * dsafe, dim=-1))
    swap = (a_s < a_t)[..., None]
    n_s, n_t = torch.broadcast_tensors(n_s, n_t)
    u = torch.where(swap, n_t, n_s)
    nt = torch.where(swap, n_s, n_t)
    dd = torch.where(swap, -dsafe, dsafe)
    v = torch.linalg.cross(dd, u)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
    w = torch.linalg.cross(u, v)
    f1 = torch.sum(v * nt, dim=-1)
    f3 = torch.sum(u * dd, dim=-1)
    f4 = torch.atan2(torch.sum(w * nt, dim=-1), torch.sum(u * nt, dim=-1))
    return f1, f3, f4, dist[..., 0]


def _bin_index(value, lo, hi):
    idx = torch.floor(FPFH_BINS * (value - lo) / (hi - lo)).to(torch.int64)
    return torch.clamp(idx, 0, FPFH_BINS - 1)


def compute_fpfh(points: torch.Tensor, normals: torch.Tensor,
                 mask: torch.Tensor, radius: float,
                 max_nn: int = 100) -> torch.Tensor:
    """(..., N, 33) FPFH features; invalid points get zero vectors."""
    n = points.shape[-2]
    idx, ok = knn_hybrid(points, mask, radius, k=max_nn)
    ok = ok & (idx != torch.arange(n, device=idx.device)[:, None])  # no self

    p_t = gather_rows(points, idx)                        # (..., N, k, 3)
    n_t = gather_rows(normals, idx)
    f1, f3, f4, dist = _pair_features(points[..., :, None, :],
                                      normals[..., :, None, :], p_t, n_t)
    b1 = _bin_index(f1, -1.0, 1.0)
    b3 = _bin_index(f3, -1.0, 1.0)
    b4 = _bin_index(f4, -torch.pi, torch.pi)

    okf = ok.to(torch.float32)
    k_valid = torch.sum(okf, dim=-1)                      # (..., N)
    incr = torch.where(k_valid > 0, 100.0 / torch.clamp(k_valid, min=1.0),
                       torch.zeros_like(k_valid))
    w = (okf * incr[..., None])[..., None]                # (..., N, k, 1)

    def hist(b):
        oh = torch.nn.functional.one_hot(b, FPFH_BINS).to(torch.float32) * w
        return oh.sum(dim=-2)

    spfh = torch.cat([hist(b1), hist(b3), hist(b4)], dim=-1)   # (..., N, 33)

    inv_d = torch.where(ok & (dist > 1e-12),
                        1.0 / torch.clamp(dist, min=1e-12),
                        torch.zeros_like(dist))
    neigh = gather_rows(spfh, idx)                        # (..., N, k, 33)
    agg = torch.einsum("...k,...kf->...f", inv_d, neigh)
    fpfh = spfh + agg / torch.clamp(k_valid, min=1.0)[..., None]

    total = torch.sum(fpfh, dim=-1, keepdim=True)
    fpfh = torch.where(total > 1e-12,
                       100.0 * fpfh / torch.clamp(total, min=1e-12),
                       torch.zeros_like(fpfh))
    return torch.where(mask[..., None], fpfh, torch.zeros_like(fpfh))
