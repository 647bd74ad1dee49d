"""The coarse-to-fine registration pipeline as a library API (counterpart of
`instance_based_loc_tpu/ops/registration.py`, mirroring the reference's
`utils/fpfh_register.py`):

    register_point_clouds(source, target, voxel_size,
                          global_dist_factor=1.5, local_dist_factor=0.4)
      -> normals(2 * voxel, nn 30) -> FPFH(5 * voxel, nn 100)
      -> feature-matching RANSAC (threshold voxel * global_dist_factor)
      -> coloured ICP            (threshold voxel * local_dist_factor)
      -> (transform, inlier_rmse, fitness)

plus `refine_registration` (ICP only, from a given init),
`evaluate_transform` and `register_assignments_batched`, which registers A
assignments in one batched call on the leading axis.

As in the reference, `voxel_size` sets only the search radii and the
thresholds: nothing is voxel-downsampled. The radii and thresholds are
fp32 products, as the reference computes them.

Each function takes `samples` (..., H, 3), correspondence indices that
replace the RANSAC draw (so a test can feed in the reference's draws), and
a `torch.Generator` for the draw otherwise (seeded from `seed` when None).

The localisation query program does not call this module: its own
registration (`localise_kernels._register_one`) subsamples for FPFH, picks
the basin by coarse inliers and may stop ICP early.
"""

from __future__ import annotations

import numpy as np
import torch

from .fpfh import compute_fpfh
from .icp import evaluate_transform_arrays, icp
from .normals import estimate_normals
from .pointcloud import PointCloud, round_up_pow2
from .ransac import feature_correspondences, ransac_registration


def _mul32(a: float, b: float) -> float:
    """a * b in float32 (the reference's traced fp32 arithmetic)."""
    return float(np.float32(a) * np.float32(b))


def _generator(device, generator, seed: int):
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(seed)


def _register(src: PointCloud, tgt: PointCloud, voxel_size: float,
              global_dist_factor: float, local_dist_factor: float,
              generator, num_hypotheses: int, icp_iterations: int,
              samples):
    """FPFH + RANSAC + coloured ICP, batched over leading dimensions.
    Returns (T, rmse, fitness) tensors."""
    radius_normal = _mul32(voxel_size, 2.0)
    radius_feature = _mul32(voxel_size, 5.0)
    src_n = estimate_normals(src.points, src.mask, radius_normal, max_nn=30)
    tgt_n = estimate_normals(tgt.points, tgt.mask, radius_normal, max_nn=30)
    src_f = compute_fpfh(src.points, src_n, src.mask, radius_feature,
                         max_nn=100)
    tgt_f = compute_fpfh(tgt.points, tgt_n, tgt.mask, radius_feature,
                         max_nn=100)
    corr_idx, corr_valid = feature_correspondences(src_f, src.mask, tgt_f,
                                                   tgt.mask, mutual=True)
    T_ransac, _, _ = ransac_registration(
        src.points, src.mask, tgt.points, corr_idx, corr_valid,
        _mul32(voxel_size, global_dist_factor), generator=generator,
        num_hypotheses=num_hypotheses, samples=samples)
    T, fitness, rmse = icp(
        src.points, src.mask, tgt.points, tgt.mask,
        _mul32(voxel_size, local_dist_factor), init_transform=T_ransac,
        src_colors=src.colors, tgt_colors=tgt.colors,
        max_iterations=icp_iterations, use_colors=True)
    return T, rmse, fitness


def _refine(src: PointCloud, tgt: PointCloud, init_T, coarse_dist: float,
            fine_dist: float, icp_iterations: int):
    """Coarse then fine coloured ICP from `init_T`. Returns (T, rmse,
    fitness) tensors, fitness and rmse at `fine_dist`."""
    T, _, _ = icp(src.points, src.mask, tgt.points, tgt.mask, coarse_dist,
                  init_transform=init_T, src_colors=src.colors,
                  tgt_colors=tgt.colors, max_iterations=icp_iterations,
                  use_colors=True)
    T, fitness, rmse = icp(src.points, src.mask, tgt.points, tgt.mask,
                           fine_dist, init_transform=T,
                           src_colors=src.colors, tgt_colors=tgt.colors,
                           max_iterations=icp_iterations, use_colors=True)
    return T, rmse, fitness


def register_point_clouds(source: PointCloud, target: PointCloud,
                          voxel_size: float,
                          global_dist_factor: float = 1.5,
                          local_dist_factor: float = 0.4,
                          seed: int = 0,
                          num_hypotheses: int = 4096,
                          icp_iterations: int = 30,
                          samples: torch.Tensor | None = None,
                          generator: torch.Generator | None = None):
    """The reference's `register_point_clouds`, on the clouds' device.
    Returns (transform (4, 4) numpy, inlier_rmse float, fitness float)."""
    T, rmse, fitness = _register(
        source, target, voxel_size, global_dist_factor, local_dist_factor,
        _generator(source.device, generator, seed), num_hypotheses,
        icp_iterations, samples)
    return T.cpu().numpy(), float(rmse), float(fitness)


def refine_registration(source: PointCloud, target: PointCloud,
                        init_transform, voxel_size: float,
                        local_dist_factor: float = 0.4,
                        coarse_factor: float = 4.0,
                        icp_iterations: int = 30):
    """ICP-only registration from an external coarse init (e.g. the
    assignment-centroid Kabsch init): ICP at voxel_size * coarse_factor
    pulls into the basin, then at voxel_size * local_dist_factor polishes.
    Returns (transform, inlier_rmse, fitness), the last two at the fine
    distance, like `register_point_clouds`."""
    init = torch.as_tensor(np.asarray(init_transform, np.float32),
                           device=source.device)
    T, rmse, fitness = _refine(source, target, init,
                               voxel_size * coarse_factor,
                               voxel_size * local_dist_factor, icp_iterations)
    return T.cpu().numpy(), float(rmse), float(fitness)


def evaluate_transform(source: PointCloud, target: PointCloud, trans_init,
                       threshold: float = 0.02):
    """The reference's `evaluate_transform` (Open3D's
    `evaluate_registration`): returns (inlier_rmse, fitness)."""
    T = torch.as_tensor(np.asarray(trans_init, np.float32),
                        device=source.device)
    rmse, fitness = evaluate_transform_arrays(
        source.points, source.mask, target.points, target.mask, T,
        threshold)
    return float(rmse), float(fitness)


def register_assignments_batched(src: PointCloud, tgt: PointCloud,
                                 init_T, has_init, det_means, mem_means,
                                 eval_src: PointCloud, eval_tgt: PointCloud,
                                 voxel_size: float,
                                 global_dist_factor: float = 1.5,
                                 local_dist_factor: float = 0.4,
                                 seed: int = 0,
                                 num_hypotheses: int = 4096,
                                 icp_iterations: int = 30,
                                 samples: torch.Tensor | None = None,
                                 generator: torch.Generator | None = None):
    """A localisation query's A assignment registrations in one batched
    call. `src` / `tgt` are batched clouds (A, N, ...), mean-centred per
    assignment; `eval_src` / `eval_tgt` are the full detection and memory
    clouds, one each. Per assignment a:

      cand1 = FPFH + RANSAC + coloured ICP
      cand2 = coarse-to-fine ICP from init_T[a], if has_init[a]
      T[a]  = the candidate of higher fitness (cand1 on a tie)
      the full clouds' rmse and fitness at 0.02 under the global transform
      composed from T[a] and the means.

    `samples` (A, H, 3) replaces the RANSAC draws. Returns numpy (T (A, 4,
    4), rmse, fitness, full_rmse, full_fitness)."""
    dev = src.device

    def tensor(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    t1, r1, f1 = _register(src, tgt, voxel_size, global_dist_factor,
                           local_dist_factor,
                           _generator(dev, generator, seed), num_hypotheses,
                           icp_iterations, samples)
    t2, r2, f2 = _refine(src, tgt, tensor(init_T),
                         _mul32(voxel_size, 4.0),
                         _mul32(voxel_size, local_dist_factor),
                         icp_iterations)
    f2 = torch.where(tensor(has_init, torch.bool), f2,
                     torch.full_like(f2, -1.0))
    use2 = f2 > f1
    T = torch.where(use2[:, None, None], t2, t1)
    rmse = torch.where(use2, r2, r1)
    fitness = torch.where(use2, f2, f1)

    # the global-frame transform, the mean-centring accounted for
    R = T[:, :3, :3]
    gT = torch.eye(4, dtype=torch.float32, device=dev).repeat(len(T), 1, 1)
    gT[:, :3, :3] = R
    gT[:, :3, 3] = (T[:, :3, 3] + tensor(mem_means)
                    - (R @ tensor(det_means)[:, :, None])[..., 0])
    full_rmse, full_fitness = evaluate_transform_arrays(
        eval_src.points, eval_src.mask, eval_tgt.points, eval_tgt.mask, gT,
        0.02)
    return tuple(x.cpu().numpy()
                 for x in (T, rmse, fitness, full_rmse, full_fitness))


def pad_for_registration(cloud: PointCloud,
                         capacity: int | None = None) -> PointCloud:
    """The cloud compacted and padded to `capacity` (a power of two, at
    least 128, when None), on its device."""
    pts, cols = cloud.to_numpy()
    cap = capacity or round_up_pow2(max(len(pts), 128))
    return PointCloud.from_numpy(pts, cols, capacity=cap, device=cloud.device)
