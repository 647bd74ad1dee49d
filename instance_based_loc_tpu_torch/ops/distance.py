"""Pairwise distance primitives (counterpart of
`instance_based_loc_tpu/ops/distance.py`).

Every Gram matrix here is full fp32: the package switches TF32 off
(`instance_based_loc_tpu_torch/__init__.py`), the counterpart of the
reference's `Precision.HIGHEST`. All functions take leading batch
dimensions.
"""

from __future__ import annotations

import numpy as np
import torch


def gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b^T in fp32: a (..., N, D), b (..., M, D) -> (..., N, M)."""
    return a.float() @ b.float().transpose(-1, -2)


def matmul_hp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full fp32 (TF32 is off package-wide)."""
    return torch.matmul(a, b)


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor,
                      clamp: bool = True) -> torch.Tensor:
    """Squared euclidean distances (..., N, M) of a (..., N, D) and
    b (..., M, D), clamped at 0."""
    sq_a = torch.sum(a * a, dim=-1)
    sq_b = torch.sum(b * b, dim=-1)
    d2 = sq_a[..., :, None] + sq_b[..., None, :] - 2.0 * (a @ b.transpose(-1, -2))
    return torch.clamp(d2, min=0.0) if clamp else d2


def masked_nearest(a: torch.Tensor, b: torch.Tensor, b_mask: torch.Tensor,
                   big: float = 1e30):
    """For each row of a, the index and squared distance of the nearest
    valid row of b. Returns (idx (..., N) int64, sqdist (..., N))."""
    d2 = pairwise_sq_dists(a, b)
    d2 = torch.where(b_mask[..., None, :], d2, torch.full_like(d2, big))
    val, idx = torch.min(d2, dim=-1)
    return idx, val


def f32_sq(x: float) -> float:
    """x squared in float32, as the reference computes a threshold's square
    (`jnp.float32(x) ** 2`)."""
    x32 = np.float32(x)
    return float(x32 * x32)
