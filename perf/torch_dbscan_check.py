"""The port's DBSCAN on a dense overlapping cloud like the ones the
random-weight cascade produces (`chip_smoke.py` phase 7): 60 noisy copies
of a 2 m x 2 m surface sampled every 2 cm (600 k points, ~4.7 k neighbours
per point within eps 0.1). Prints the host time and the cluster count.
Agreement with the JAX package's labels is held by
`tests/test_torch_geometry.py` (case `dbscan`).

Runs on the CPU, from the repository root:
    python perf/torch_dbscan_check.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    from instance_based_loc_tpu_torch.ops.clustering import dbscan

    rng = np.random.default_rng(0)
    grid = np.stack(np.meshgrid(np.arange(0, 2, 0.02), np.arange(0, 2, 0.02),
                                indexing="ij"), -1).reshape(-1, 2)
    surface = np.concatenate([grid, np.zeros((len(grid), 1))], 1)
    dense = np.concatenate([surface + rng.normal(scale=0.003,
                                                 size=surface.shape)
                            for _ in range(60)])
    t0 = time.perf_counter()
    labels = dbscan(dense, 0.1, 40)
    print(f"dense case: {len(dense)} points, {labels.max() + 1} clusters, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    main()
