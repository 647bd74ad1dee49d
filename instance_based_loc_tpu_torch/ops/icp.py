"""Iterative Closest Point refinement (counterpart of
`instance_based_loc_tpu/ops/icp.py`; replaces Open3D's
`registration_colored_icp` / `registration_icp` / `evaluate_registration`).

Each iteration is a nearest-neighbour search then a masked, colour-weighted
Kabsch solve; each `lax.scan` of the reference is a Python loop here.
Colour enters as a down-weighting of correspondences with mismatched colours
(the reference's documented deviation from Open3D's joint photometric
solve). Batched over leading dimensions.

The step's Kabsch solve runs in fp32, the reference's arithmetic
(`kabsch_solve`), not in float64 as RANSAC's hypotheses and the centroid
init do: over 48 random streams the trial CLI's TUM scene localised 25
times with a float64 ICP and 39 times in fp32 (the JAX package: 46), and
the 5-object scene of tests/test_memory_e2e.py 40 of 40 times either way
(perf/torch_port_numerics.py).
"""

from __future__ import annotations

import torch

from .distance import f32_sq, masked_nearest
from .kabsch import apply_transform, kabsch_solve
from .pointcloud import gather_rows

DEFAULT_ICP_ITERS = 30
COLOR_SIGMA = 0.25


def _init(src_pts, init_transform):
    if init_transform is not None:
        return init_transform
    eye = torch.eye(4, dtype=torch.float32, device=src_pts.device)
    return eye.expand(src_pts.shape[:-2] + (4, 4))


def _icp_step(T, src_pts, src_mask, tgt_pts, tgt_mask, thr, src_colors,
              tgt_colors, use_colors):
    """One correspond-and-solve step; returns (T_next, nn_d2, inlier)."""
    moved = apply_transform(src_pts, T)
    nn_idx, nn_d2 = masked_nearest(moved, tgt_pts, tgt_mask)
    inlier = src_mask & (nn_d2 <= f32_sq(thr))
    w = inlier.to(torch.float32)
    if use_colors and src_colors is not None and tgt_colors is not None:
        cd2 = torch.sum((src_colors - gather_rows(tgt_colors, nn_idx)) ** 2,
                        dim=-1)
        w = w * torch.exp(-cd2 / (2.0 * COLOR_SIGMA ** 2))
    T_new = kabsch_solve(src_pts, gather_rows(tgt_pts, nn_idx), weights=w)
    enough = torch.sum(inlier, dim=-1) >= 3
    return torch.where(enough[..., None, None], T_new, T), nn_d2, inlier


def icp(src_pts, src_mask, tgt_pts, tgt_mask, max_correspondence_distance,
        init_transform=None, src_colors=None, tgt_colors=None,
        max_iterations: int = DEFAULT_ICP_ITERS, use_colors: bool = False,
        early_exit: bool = False):
    """Returns (T (..., 4, 4), fitness, inlier_rmse) with Open3D's semantics.

    early_exit=True stops a lane once both the fitness and the rmse change
    by at most 1e-6 between iterations (Open3D's ICPConvergenceCriteria);
    a stopped lane keeps its transform while others go on."""
    thr = max_correspondence_distance
    T = _init(src_pts, init_transform)
    if not early_exit:
        for _ in range(max_iterations):
            T, _, _ = _icp_step(T, src_pts, src_mask, tgt_pts, tgt_mask, thr,
                                src_colors, tgt_colors, use_colors)
    else:
        lead = src_pts.shape[:-2]
        dev = src_pts.device
        fit = torch.zeros(lead, device=dev)
        rmse = torch.zeros(lead, device=dev)
        prev_fit = torch.full(lead, -1.0, device=dev)
        prev_rmse = torch.full(lead, -1.0, device=dev)
        n_src = torch.clamp(torch.sum(src_mask.to(torch.float32), dim=-1),
                            min=1.0)
        for i in range(max_iterations):
            running = ((torch.abs(prev_fit - fit) > 1e-6)
                       | (torch.abs(prev_rmse - rmse) > 1e-6) | (i < 2))
            if not bool(running.any()):
                break
            T_next, nn_d2, inlier = _icp_step(
                T, src_pts, src_mask, tgt_pts, tgt_mask, thr, src_colors,
                tgt_colors, use_colors)
            cnt = torch.sum(inlier.to(torch.float32), dim=-1)
            new_rmse = torch.sqrt(
                torch.sum(torch.where(inlier, nn_d2, torch.zeros_like(nn_d2)),
                          dim=-1) / torch.clamp(cnt, min=1.0))
            new_fit = cnt / n_src
            T = torch.where(running[..., None, None], T_next, T)
            prev_fit = torch.where(running, fit, prev_fit)
            prev_rmse = torch.where(running, rmse, prev_rmse)
            fit = torch.where(running, new_fit, fit)
            rmse = torch.where(running, new_rmse, rmse)
    rmse, fitness = evaluate_transform_arrays(
        src_pts, src_mask, tgt_pts, tgt_mask, T, max_correspondence_distance)
    return T, fitness, rmse


def icp_scheduled(src_pts, src_mask, tgt_pts, tgt_mask, thresholds,
                  init_transform=None, src_colors=None, tgt_colors=None,
                  use_colors: bool = False):
    """Multi-scale ICP: `thresholds` gives each iteration's max
    correspondence distance (a coarse->fine schedule as one loop). Returns
    (T, fitness, rmse) evaluated at thresholds[-1]."""
    T = _init(src_pts, init_transform)
    for thr in thresholds:
        T, _, _ = _icp_step(T, src_pts, src_mask, tgt_pts, tgt_mask,
                            float(thr), src_colors, tgt_colors, use_colors)
    rmse, fitness = evaluate_transform_arrays(
        src_pts, src_mask, tgt_pts, tgt_mask, T, float(thresholds[-1]))
    return T, fitness, rmse


def evaluate_transform_arrays(src_pts, src_mask, tgt_pts, tgt_mask,
                              transform, threshold):
    """Open3D `evaluate_registration`: returns (inlier_rmse, fitness)."""
    moved = apply_transform(src_pts, transform)
    _, nn_d2 = masked_nearest(moved, tgt_pts, tgt_mask)
    inlier = src_mask & (nn_d2 <= f32_sq(threshold))
    count = torch.sum(inlier.to(torch.float32), dim=-1)
    n_src = torch.clamp(torch.sum(src_mask.to(torch.float32), dim=-1), min=1.0)
    rmse = torch.sqrt(torch.sum(torch.where(inlier, nn_d2,
                                            torch.zeros_like(nn_d2)), dim=-1)
                      / torch.clamp(count, min=1.0))
    return rmse, count / n_src
