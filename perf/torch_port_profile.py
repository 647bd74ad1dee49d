"""Where a localisation query of the PyTorch port spends its time on the card.

Builds the memory of chip_smoke.py's scene (bench.py's e2e scene: 9 objects,
640x480, focal 525; views 0-5, voxel 0.02, DBSCAN eps 0.1 / min 40) with the
`color` embedder on the card, warms up on views 6-8, then profiles 3 queries
(views 6, 7, 8) with torch.profiler. Prints, per query: host wall time, the
summed device time of its kernels, the number of kernel launches and of
memory copies, the device's idle share (1 - device time / wall time), and the
kernels that take the most device time.

Run on a machine with a CUDA card, from the repository root:
    python3 perf/torch_port_profile.py
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_port_profile: needs a CUDA card")
    from instance_based_loc_tpu_torch.data.synthetic import (
        default_scene, render_scene, ring_poses)
    from instance_based_loc_tpu_torch.memory import (
        ColorRegionDetector, ObjectMemory)
    from instance_based_loc_tpu_torch.models.embedders import get_embedder

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    focal, h, w = 525.0, 480, 640
    scene = default_scene(num_objects=9, seed=3)
    poses = ring_poses(9, radius=4.5, height=1.3, target=(0, 0.4, 0))
    frames = [render_scene(scene, p, h, w, focal) for p in poses]
    memory = ObjectMemory(
        detector=ColorRegionDetector(min_area=500,
                                     floor_colors=[scene.floor_color]),
        camera_focal_lenth_x=focal, camera_focal_lenth_y=focal,
        get_embeddings_func=get_embedder("color"), log_enabled=False,
        device="cuda")
    for i in range(6):
        rgb, depth, _ = frames[i]
        memory.process_image(rgb, depth, poses[i], consider_floor=True,
                             min_points=200, outlier_removal_config=None)
    memory.downsample_all_objects(voxel_size=0.02)
    memory.recluster_objects_with_dbscan(eps=0.1, min_points_per_cluster=40)
    queries = [frames[i][:2] for i in (6, 7, 8)]
    for rgb, depth in queries:                       # warm-up
        memory.localise(rgb, depth, outlier_removal_config=None)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for rgb, depth in queries:
            memory.localise(rgb, depth, outlier_removal_config=None)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(queries)

    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in events if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    copies = [e for e in events if "memcpy" in e.name.lower()]
    busy_us = sum(e.time_range.elapsed_us() for e in events) / len(queries)
    n = len(queries)
    if not events:
        sys.exit("torch_port_profile: the profiler recorded no device events")
    print(f"per query: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / 1e3 / (wall * 1e3):.3f}, "
          f"{len(kernels) / n:.0f} kernel launches, {len(copies) / n:.0f} "
          f"memory copies", flush=True)
    by_name: dict = {}
    for e in kernels:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    print("top kernels by device time per query (us, launches):", flush=True)
    for name, (tot, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:12]:
        print(f"  {tot / n:9.1f} us {cnt / n:6.0f}x  {name[:90]}", flush=True)


if __name__ == "__main__":
    main()
