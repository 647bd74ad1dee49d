"""Ellipsoid fit of an object's cloud for clip_loc (counterpart of
`instance_based_loc_tpu/ops/ellipsoid.py`; reference
`clip_loc/ellipsoid_utils.py:4-55`): the principal axes of the covariance,
semi-axes from the square roots of its eigenvalues, then inflated by
`scaling_factor` until every point lies inside (at most `max_iterations`
times; the reference stops at 20). The ellipsoid is kept as (center, axes,
lengths); `sample_ellipsoid_surface` draws its surface for display.
"""

from __future__ import annotations

import numpy as np
import torch

from .eigen3 import eigh3x3
from .pointcloud import masked_mean


def fit_ellipsoid(points: torch.Tensor, mask: torch.Tensor,
                  scaling_factor: float = 1.05, max_iterations: int = 60):
    """points (N, 3), mask (N,) -> (center (3,), axes (3, 3) in columns,
    largest first, lengths (3,) semi-axes)."""
    center = masked_mean(points, mask)
    centered = (points - center) * mask[:, None].to(points.dtype)
    n = torch.clamp(mask.sum().to(points.dtype) - 1.0, min=1.0)
    cov = centered.T @ centered / n                # np.cov, ddof 1
    w_asc, v_asc = eigh3x3(cov)
    s = torch.clamp(w_asc.flip(-1), min=0.0)
    u = v_asc.flip(-1)
    lengths = torch.sqrt(torch.clamp(s, min=1e-12)) * scaling_factor
    proj = (points - center) @ u
    for _ in range(max_iterations):
        r = torch.linalg.norm(proj / lengths, dim=-1)
        if bool(torch.all(torch.where(mask, r <= 1.0, True))):
            break
        lengths = lengths * scaling_factor
    return center, u, lengths


def sample_ellipsoid_surface(center, axes, lengths, n_u: int = 40,
                             n_v: int = 20) -> np.ndarray:
    """(n_u * n_v, 3) points on the ellipsoid's surface (host numpy)."""
    u = np.linspace(0, 2 * np.pi, n_u)
    v = np.linspace(0, np.pi, n_v)
    uu, vv = np.meshgrid(u, v)
    lengths = np.asarray(lengths)
    local = np.stack([
        lengths[0] * np.cos(uu) * np.sin(vv),
        lengths[1] * np.sin(uu) * np.sin(vv),
        lengths[2] * np.cos(vv),
    ], axis=-1).reshape(-1, 3)
    return local @ np.asarray(axes).T + np.asarray(center)
