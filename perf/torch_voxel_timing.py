"""Host time of the port's voxel grid (`ops/voxel.py`) on 2 M uniform
points at voxel 0.02 m, the size of the random-weight cascade's memory
(`chip_smoke.py` phase 7), beside the row-wise form it replaced
(`np.unique(keys, axis=0)` and `np.add.at`, the JAX package's numpy path).
Checks that both give the same rows bit for bit, and prints the best of
three runs of each.

Runs on the CPU, from the repository root:
    python perf/torch_voxel_timing.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from instance_based_loc_tpu_torch.ops.voxel import (  # noqa: E402
    voxel_downsample_numpy)

N, VOXEL = 2_000_000, 0.02


def row_wise(points, colors, voxel_size):
    keys = np.floor(points / np.float32(voxel_size)).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    k = int(inv.max()) + 1
    counts = np.bincount(inv, minlength=k).astype(np.float32)[:, None]
    sum_pts = np.zeros((k, 3), np.float64)
    sum_cols = np.zeros((k, 3), np.float64)
    np.add.at(sum_pts, inv, points)
    np.add.at(sum_cols, inv, colors)
    return ((sum_pts / counts).astype(np.float32),
            (sum_cols / counts).astype(np.float32))


def best_s(fn, *args, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        times.append(time.perf_counter() - t0)
    return min(times), out


def main():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    cols = rng.uniform(size=(N, 3)).astype(np.float32)
    t_new, (p_new, c_new) = best_s(voxel_downsample_numpy, pts, cols, VOXEL)
    t_old, (p_old, c_old) = best_s(row_wise, pts, cols, VOXEL)
    assert np.array_equal(p_new, p_old) and np.array_equal(c_new, c_old)
    print(f"{N} points, voxel {VOXEL}: {len(p_new)} voxels; row-wise "
          f"{t_old:.3f} s, voxel codes {t_new:.3f} s (best of 3, identical "
          f"output)")


if __name__ == "__main__":
    main()
