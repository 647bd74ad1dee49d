"""Fixed-capacity masked point clouds (counterpart of
`instance_based_loc_tpu/ops/pointcloud.py`): the helpers every op shares.

A cloud is three tensors of one capacity N:

    points : (N, 3) float32
    colors : (N, 3) float32
    mask   : (N,)   bool      -- True where the row holds a real point

Invalid rows hold zeros and never influence a result: every op in this
package takes and returns masks explicitly. Batched ops put any leading
dimensions before N. `PointCloud` bundles the three; the ops themselves
take the tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device


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


@dataclasses.dataclass
class PointCloud:
    """A padded, masked point cloud of three tensors on one device
    (counterpart of the JAX package's `PointCloud`):

        points (..., N, 3) float32, colors (..., N, 3) float32,
        mask (..., N) bool

    `points[i]` / `colors[i]` are meaningful only where `mask[i]` is True.
    A batched cloud (leading dimensions) is what the batched registration
    takes; the host utilities (`to_numpy`, `compact`) take one cloud."""

    points: torch.Tensor
    colors: torch.Tensor
    mask: torch.Tensor

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_numpy(points: np.ndarray, colors: np.ndarray | None = None,
                   capacity: int | None = None,
                   device="cuda") -> "PointCloud":
        """Valid rows first, zero rows after, `capacity` rows in all (the
        next power of two when None), on `device`."""
        points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        n = points.shape[0]
        if colors is None:
            colors = np.zeros_like(points)
        else:
            colors = np.asarray(colors, dtype=np.float32).reshape(-1, 3)
            if colors.shape[0] != n:
                raise ValueError(f"{n} points but {colors.shape[0]} colors")
        if capacity is None:
            capacity = round_up_pow2(n)
        if capacity < n:
            raise ValueError(f"capacity {capacity} < {n} points")
        pts = np.zeros((capacity, 3), dtype=np.float32)
        cols = np.zeros((capacity, 3), dtype=np.float32)
        msk = np.zeros((capacity,), dtype=bool)
        pts[:n] = points
        cols[:n] = colors
        msk[:n] = True
        dev = resolve_device(device)
        return PointCloud(torch.as_tensor(pts, device=dev),
                          torch.as_tensor(cols, device=dev),
                          torch.as_tensor(msk, device=dev))

    @staticmethod
    def empty(capacity: int = 8, device="cuda") -> "PointCloud":
        dev = resolve_device(device)
        return PointCloud(
            torch.zeros((capacity, 3), dtype=torch.float32, device=dev),
            torch.zeros((capacity, 3), dtype=torch.float32, device=dev),
            torch.zeros((capacity,), dtype=torch.bool, device=dev))

    # ------------------------------------------------------------------ #
    # queries (on the device)
    # ------------------------------------------------------------------ #
    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def count(self) -> torch.Tensor:
        """Number of valid points (int32 tensor, one per cloud)."""
        return torch.sum(self.mask.to(torch.int32), dim=-1,
                         dtype=torch.int32)

    def centroid(self) -> torch.Tensor:
        """Mean of valid points; zeros if empty."""
        return masked_mean(self.points, self.mask)

    def bounds(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(min, max) over valid points; (+inf, -inf) rows where empty."""
        m = self.mask[..., None]
        inf = torch.full_like(self.points, float("inf"))
        mn = torch.amin(torch.where(m, self.points, inf), dim=-2)
        mx = torch.amax(torch.where(m, self.points, -inf), dim=-2)
        return mn, mx

    # ------------------------------------------------------------------ #
    # host-side utilities
    # ------------------------------------------------------------------ #
    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """(points, colors) of only the valid rows, as numpy arrays."""
        mask = self.mask.cpu().numpy()
        return self.points.cpu().numpy()[mask], self.colors.cpu().numpy()[mask]

    def compact(self, capacity: int | None = None) -> "PointCloud":
        """Drop invalid rows and pad again to a (new) capacity, on the same
        device."""
        pts, cols = self.to_numpy()
        return PointCloud.from_numpy(pts, cols, capacity=capacity,
                                     device=self.device)

    def pad_to(self, capacity: int) -> "PointCloud":
        """Grow the capacity with invalid zero rows."""
        cur = self.capacity
        if capacity < cur:
            raise ValueError(f"capacity {capacity} < the cloud's {cur}")
        if capacity == cur:
            return self
        lead = self.points.shape[:-2]
        extra = capacity - cur
        zeros = self.points.new_zeros(lead + (extra, 3))
        return PointCloud(
            torch.cat([self.points, zeros], dim=-2),
            torch.cat([self.colors, zeros], dim=-2),
            torch.cat([self.mask, self.mask.new_zeros(lead + (extra,))],
                      dim=-1))


def concatenate(clouds: list[PointCloud],
                capacity: int | None = None) -> PointCloud:
    """One padded cloud of `clouds` in order (capacity the sum of theirs,
    or `capacity`, which must not be smaller)."""
    out = PointCloud(torch.cat([c.points for c in clouds], dim=-2),
                     torch.cat([c.colors for c in clouds], dim=-2),
                     torch.cat([c.mask for c in clouds], dim=-1))
    if capacity is not None and capacity != out.capacity:
        out = out.pad_to(capacity)
    return out


def apply_point_mask(cloud: PointCloud, keep: torch.Tensor) -> PointCloud:
    """The cloud restricted to rows where `keep` is True."""
    return PointCloud(cloud.points, cloud.colors, cloud.mask & keep)
