"""Colour-preserving voxel downsampling (counterpart of
`instance_based_loc_tpu/ops/voxel.py`).

Points are binned by floor(p / voxel) and each occupied voxel becomes the
mean of its points and colours. Output order is sorted by voxel coordinate.

Two paths, as in the JAX package:

* the device path (`voxel_downsample`): int32 voxel coordinates sorted by
  (x, y, z), fp32 segment sums in that order (`torch.segment_reduce`, one
  sequential sum per voxel, so the card gives the CPU's bits); the cloud
  keeps its capacity and a mask (the environment map build);
* the host path (`voxel_downsample_numpy`), the JAX package's exact numpy
  path (memory consolidation). Each voxel key becomes one int64 code in mixed radix over the keys' extent,
which orders like the rows, so one 1-D `np.unique` and float64
`np.bincount` sums give the reference's rows bit for bit (both add the
points in input order) at a fraction of the row-wise `np.unique` and
`np.add.at` cost. Extents whose code would overflow int64 take the
row-wise path.
"""

from __future__ import annotations

import numpy as np
import torch

_INT32_MAX = torch.iinfo(torch.int32).max
_INT64_MAX = np.iinfo(np.int64).max


def _voxel_ids(keys: np.ndarray) -> np.ndarray:
    """Rank of each row's key among the distinct keys, in row order."""
    lo = keys.min(0)
    span = [int(x) for x in keys.max(0) - lo + 1]
    if span[0] * span[1] * span[2] > _INT64_MAX:
        _, inv = np.unique(keys, axis=0, return_inverse=True)
        return inv.reshape(-1)
    k = keys - lo
    codes = (k[:, 0] * span[1] + k[:, 1]) * span[2] + k[:, 2]
    _, inv = np.unique(codes, return_inverse=True)
    return inv


def voxel_downsample_numpy(points, colors, voxel_size):
    """Returns (points (K, 3), colors (K, 3)) float32, one row per occupied
    voxel."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    colors = (np.zeros_like(points) if colors is None
              else np.asarray(colors, np.float32).reshape(-1, 3))
    if len(points) == 0:
        return points, colors
    keys = np.floor(points / np.float32(voxel_size)).astype(np.int64)
    inv = _voxel_ids(keys)
    k = int(inv.max()) + 1
    counts = np.bincount(inv, minlength=k).astype(np.float32)[:, None]

    def mean(values):
        sums = np.stack([np.bincount(inv, weights=values[:, c], minlength=k)
                         for c in range(3)], 1)
        return (sums / counts).astype(np.float32)

    return mean(points), mean(colors)


def voxel_coords(points: torch.Tensor, voxel_size,
                 mask: torch.Tensor) -> torch.Tensor:
    """floor(p / voxel) per axis as int32; invalid rows get INT32_MAX, so
    they sort to the end and never merge with real voxels."""
    size = torch.tensor(voxel_size, dtype=torch.float32, device=points.device)
    coords = torch.floor(points / size).to(torch.int32)
    return torch.where(mask[:, None], coords, _INT32_MAX)


def voxel_downsample(points: torch.Tensor, colors: torch.Tensor,
                     mask: torch.Tensor, voxel_size):
    """Mean point and colour per voxel of a masked cloud (N, 3), (N, 3),
    (N,). The capacity is kept: row i is the mean of the i-th occupied
    voxel in (x, y, z) order, and the rows past the occupied voxels are
    masked out. Returns (points, colors, mask)."""
    n = points.shape[0]
    coords = voxel_coords(points, voxel_size, mask)
    order = torch.arange(n, device=points.device)
    for axis in (2, 1, 0):           # stable sorts: x major, then y, then z
        order = order[torch.sort(coords[order, axis], stable=True).indices]
    coords_s = coords[order]
    changed = (coords_s[1:] != coords_s[:-1]).any(dim=1)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=points.device),
                       changed])
    starts = torch.nonzero(first).reshape(-1)
    lengths = torch.diff(starts, append=starts.new_full((1,), n))
    w = mask[order].to(torch.float32)[:, None]

    def segment_sum(values):
        # one sequential sum per segment, in sorted order: the same bits
        # on the card and the CPU and from run to run (a scatter-add would
        # sum in the card's atomic order)
        out = torch.zeros((n,) + values.shape[1:], dtype=torch.float32,
                          device=points.device)
        out[:len(lengths)] = torch.segment_reduce(values, "sum",
                                                  lengths=lengths)
        return out

    sum_pts = segment_sum(points[order] * w)
    sum_cols = segment_sum(colors[order] * w)
    counts = segment_sum(w[:, 0])
    denom = torch.clamp(counts, min=1.0)[:, None]
    return sum_pts / denom, sum_cols / denom, counts > 0


def voxel_downsample_points(points: torch.Tensor, mask: torch.Tensor,
                            voxel_size):
    """Positions-only `voxel_downsample`; returns (points, mask)."""
    out_pts, _, out_mask = voxel_downsample(points, torch.zeros_like(points),
                                            mask, voxel_size)
    return out_pts, out_mask
