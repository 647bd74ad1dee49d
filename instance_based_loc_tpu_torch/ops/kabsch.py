"""Closed-form rigid alignment, Kabsch / Umeyama via SVD (counterpart of
`instance_based_loc_tpu/ops/kabsch.py`). Batched over leading dimensions,
so thousands of RANSAC hypotheses solve in one call."""

from __future__ import annotations

import numpy as np
import torch

from .eigen3 import det3x3, svd3x3


def kabsch_transform(p: torch.Tensor, q: torch.Tensor,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """Best-fit rigid transform T (..., 4, 4) with T @ [p;1] ~= q for
    row-wise corresponding points p, q (..., N, 3).

    W = sum q'_i p'_i^T, SVD(W) = U S Vh, R = U diag(1,1,det(U)det(Vh)) Vh,
    t = mean(q) - R mean(p) (reference `get_SVD_transform`).

    The solve runs in float64 and returns the input type. The closed-form
    SVD takes V from the eigenvectors of WᵀW and U = W V / S, which
    multiplies V's rounding error by the condition number S0/S2; in fp32 (the
    reference, whose TPU has no float64) thin slab-shaped clouds give
    rotations up to 0.17 off LAPACK's, and so does this solve run in fp32
    (`kabsch_solve`; perf/torch_port_numerics.py)."""
    if weights is not None:
        weights = weights.double()
    return kabsch_solve(p.double(), q.double(), weights).to(p.dtype)


def kabsch_solve(p: torch.Tensor, q: torch.Tensor,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """`kabsch_transform` in the inputs' own type (the reference's fp32
    solve when given fp32)."""
    if weights is None:
        weights = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    w = weights[..., None]
    wsum = torch.clamp(torch.sum(weights, dim=-1), min=1e-12)[..., None]
    u_p = torch.sum(p * w, dim=-2) / wsum
    u_q = torch.sum(q * w, dim=-2) / wsum
    p_c = p - u_p[..., None, :]
    q_c = q - u_q[..., None, :]
    cov = (q_c * w).transpose(-1, -2) @ p_c
    uu, _, vh = svd3x3(cov)
    d = det3x3(uu) * det3x3(vh)
    diag = torch.ones(d.shape + (3,), dtype=cov.dtype, device=cov.device)
    diag = torch.cat([diag[..., :2], d[..., None]], dim=-1)
    r = (uu * diag[..., None, :]) @ vh
    t = u_q - (r @ u_p[..., None])[..., 0]
    out = torch.zeros(r.shape[:-2] + (4, 4), dtype=cov.dtype, device=cov.device)
    out[..., :3, :3] = r
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def kabsch_masked(p: torch.Tensor, q: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """`kabsch_transform` over the rows where `mask` is True."""
    return kabsch_transform(p, q, weights=mask.to(p.dtype))


def kabsch_numpy(p, q) -> np.ndarray:
    """Host Kabsch in float64 for tiny correspondence sets (e.g. an
    assignment's 2-7 object centroids), with LAPACK's SVD; returns a
    float32 (4, 4)."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    u_p = p.mean(0)
    u_q = q.mean(0)
    cov = (q - u_q).T @ (p - u_p)
    uu, _, vh = np.linalg.svd(cov)
    d = np.linalg.det(uu) * np.linalg.det(vh)
    r = uu @ np.diag([1.0, 1.0, d]) @ vh
    t = u_q - r @ u_p
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = r
    out[:3, 3] = t
    return out


def apply_transform(points: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 transforms (..., 4, 4) to points (..., N, 3)."""
    return (points @ transform[..., :3, :3].transpose(-1, -2)
            + transform[..., None, :3, 3])
