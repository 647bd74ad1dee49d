"""The JAX package on the CPU on bench.py's e2e scene, as the reference for
the PyTorch port's chip smoke run (chip_smoke.py phase 3).

Scene: default_scene(num_objects=9, seed=3), 9 ring views at 640x480 with
focal 525; ColorRegionDetector(min_area=500) and the `color` embedder. The
memory is built from views 0-5, downsampled at 0.02 and reclustered with
DBSCAN (eps 0.1, min 40); views 6-8 are localised. Prints one line per view
with its translation and rotation error and whether it meets the reference's
success thresholds (0.6 m, 0.3 rad).

Run: JAX_PLATFORMS=cpu python perf/jax_bench_scene_cpu.py
"""

import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from instance_based_loc_tpu.data.synthetic import (  # noqa: E402
    default_scene, render_scene, ring_poses)
from instance_based_loc_tpu.memory import (  # noqa: E402
    ColorRegionDetector, ObjectMemory)
from instance_based_loc_tpu.models.embedders import get_embedder  # noqa: E402
from instance_based_loc_tpu.ops.transforms import quaternion_error  # noqa: E402


def main():
    focal, h, w = 525.0, 480, 640
    scene = default_scene(num_objects=9, seed=3)
    poses = ring_poses(9, radius=4.5, height=1.3, target=(0, 0.4, 0))
    frames = [render_scene(scene, p, h, w, focal) for p in poses]
    memory = ObjectMemory(
        detector=ColorRegionDetector(min_area=500,
                                     floor_colors=[scene.floor_color]),
        camera_focal_lenth_x=focal, camera_focal_lenth_y=focal,
        get_embeddings_func=get_embedder("color"), log_enabled=False)
    t0 = time.perf_counter()
    for i in range(6):
        rgb, depth, _ = frames[i]
        memory.process_image(rgb, depth, poses[i], consider_floor=True,
                             min_points=200, outlier_removal_config=None)
    memory.downsample_all_objects(voxel_size=0.02)
    memory.recluster_objects_with_dbscan(eps=0.1, min_points_per_cluster=40)
    print(f"build: {len(memory.memory)} objects, "
          f"{time.perf_counter() - t0:.1f} s (cpu)", flush=True)
    for i in (6, 7, 8):
        rgb, depth, _ = frames[i]
        est, (assn, _) = memory.localise(rgb, depth,
                                         outlier_removal_config=None)
        te = float(np.linalg.norm(est[:3] - poses[i][:3]))
        re_ = float(quaternion_error(jnp.asarray(poses[i][3:]),
                                     jnp.asarray(est[3:])))
        print(f"view {i}: trans_err {te:.4f} m, rot_err {re_:.4f} rad, "
              f"success {te < 0.6 and re_ < 0.3}, assn {assn}", flush=True)


if __name__ == "__main__":
    main()
