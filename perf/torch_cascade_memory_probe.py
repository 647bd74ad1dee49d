"""What the random-weight cascade hands the object memory, and what its
consolidation costs, on the card.

Builds chip_smoke.py's phase-7 cascade (full-width GroundingDINO -> SAM-H,
seeded random weights, bf16) and tests/test_neural_e2e.py's scene, then runs
phase 7's memory build step by step with host timings: the detections of
each frame (and the sizes of their boxes and masks), `process_image` for
views 0 and 2, `downsample_all_objects`, the number of point pairs within
the DBSCAN radius (what a pair-list DBSCAN must hold), and
`recluster_objects_with_dbscan` and `localise`.

Run on a machine with a CUDA card, from the repository root:
    python3 perf/torch_cascade_memory_probe.py
"""

import collections
import os
import resource
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.spatial import cKDTree  # noqa: E402


def stamp(t0, what):
    torch.cuda.synchronize()
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"{what}: {time.perf_counter() - t0:.2f} s (peak host RSS "
          f"{rss_gb:.1f} GB)", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_cascade_memory_probe: needs a CUDA card")
    import chip_smoke
    from instance_based_loc_tpu_torch.memory import ObjectMemory
    from instance_based_loc_tpu_torch.models.cascade import (
        build_cascade_detector)
    from instance_based_loc_tpu_torch.models.embedders import get_embedder
    from instance_based_loc_tpu_torch.models.gdino import GDinoConfig
    from instance_based_loc_tpu_torch.models.sam import SamConfig

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    frames, poses = chip_smoke.e2e_frames()
    with tempfile.TemporaryDirectory() as workdir:
        cascade = build_cascade_detector(
            gdino_vocab=chip_smoke.write_vocab(workdir), random_init=True,
            sam_cfg=SamConfig(), gdino_cfg=GDinoConfig(),
            compute_dtype="bfloat16", device="cuda")
    det = cascade.find(frames[0][0], True)
    w = det.boxes_xyxy[:, 2] - det.boxes_xyxy[:, 0]
    h = det.boxes_xyxy[:, 3] - det.boxes_xyxy[:, 1]
    px = det.masks.sum(axis=(1, 2))
    print(f"view 0: {len(det)} detections "
          f"{dict(collections.Counter(det.phrases))}; box width / height "
          f"percentiles 5/50/95: {np.percentile(w, [5, 50, 95]).round(1)} / "
          f"{np.percentile(h, [5, 50, 95]).round(1)} px; mask pixels "
          f"{np.percentile(px, [5, 50, 95]).round(0)} of "
          f"{det.masks.shape[1] * det.masks.shape[2]}", flush=True)

    memory = ObjectMemory(detector=cascade,
                          camera_focal_lenth_x=chip_smoke.FOCAL_E2E,
                          camera_focal_lenth_y=chip_smoke.FOCAL_E2E,
                          get_embeddings_func=get_embedder("color"),
                          log_enabled=False, device="cuda")
    for i in (0, 2):
        rgb, depth, _ = frames[i]
        t0 = time.perf_counter()
        memory.process_image(rgb, depth, poses[i], consider_floor=True,
                             min_points=50, outlier_removal_config=None)
        stamp(t0, f"process_image view {i} ({len(memory.memory)} objects)")
    t0 = time.perf_counter()
    memory.downsample_all_objects(voxel_size=0.02)
    stamp(t0, "downsample_all_objects")
    pts = np.concatenate([o.points() for o in memory.memory])
    t0 = time.perf_counter()
    tree = cKDTree(pts)
    pairs = (tree.count_neighbors(tree, 0.1) - len(pts)) // 2
    print(f"{len(pts)} object points, {pairs} pairs within 0.1 m", flush=True)
    stamp(t0, "pair count")
    t0 = time.perf_counter()
    memory.recluster_objects_with_dbscan(eps=0.1, min_points_per_cluster=40)
    stamp(t0, f"recluster_objects_with_dbscan ({len(memory.memory)} "
              f"objects left)")
    rgb, depth, _ = frames[1]
    t0 = time.perf_counter()
    memory.localise(rgb, depth, outlier_removal_config=None)
    stamp(t0, "localise view 1")


if __name__ == "__main__":
    main()
