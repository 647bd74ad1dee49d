"""Fixed-capacity masked point clouds (counterpart of
`instance_based_loc_tpu/ops/pointcloud.py`): the helpers every op shares.

A cloud is three tensors of one capacity N:

    points : (N, 3) float32
    colors : (N, 3) float32
    mask   : (N,)   bool      -- True where the row holds a real point

Invalid rows hold zeros and never influence a result: every op in this
package takes and returns masks explicitly. Batched ops put any leading
dimensions before N.
"""

from __future__ import annotations

import torch


def round_up_pow2(n: int, minimum: int = 8) -> int:
    """Round `n` up to a power of two (>= minimum)."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def masked_mean(values: torch.Tensor, mask: torch.Tensor,
                dim: int = -2) -> torch.Tensor:
    """Mean of `values` rows where mask is True; zeros when no valid rows.
    values (..., N, C), mask (..., N) -> (..., C)."""
    mask_f = mask.to(values.dtype)
    while mask_f.dim() < values.dim():
        mask_f = mask_f.unsqueeze(-1)
    total = torch.sum(values * mask_f, dim=dim)
    count = torch.clamp(torch.sum(mask_f, dim=dim), min=1.0)
    return total / count


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: x (..., N, C), idx (..., *shape) -> (..., *shape, C)
    with out[..., i, :] = x[..., idx[..., i], :] (the batched form of
    `x[idx]`). The index goes to int64: torch.gather reads an expanded
    int32 index wrongly."""
    lead = x.shape[:-2]
    flat = idx.reshape(*lead, -1).long()
    out = torch.gather(x, -2, flat.unsqueeze(-1).expand(*flat.shape,
                                                        x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def gather_values(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched value gather: x (..., N), idx (..., *shape) -> (..., *shape)."""
    lead = x.shape[:-1]
    flat = idx.reshape(*lead, -1).long()
    return torch.gather(x, -1, flat).reshape(idx.shape)
