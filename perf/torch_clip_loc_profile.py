"""Where one clip_loc `localize` spends its time, on the card.

The bench scene (bench.py:233-264: 9 objects, 640x480, focal 525): an object
memory from views 0-5 with the depth detector and the `color` embedder,
DBSCAN reclustering, converted to a ClipLocObjectMemory; view 6 localised
from RGB alone with the colour detector, 200 RANSAC rounds (the clip_loc
CLI's configuration in chip_smoke.py phase 12 (a)). After a warm-up call:

1. host ms per call over 5 calls, and the same split by stage (detection
   and embedding, the P3P solve, the pose scoring, the Gauss-Newton
   refinement), each stage timed with the card synchronised;
2. one call under torch.profiler: wall ms, device busy ms (the union of the
   kernels' intervals), kernel launches, and the kernels and host ops that
   take longest.

Prints the card's name and power limit first.

Run: python3 perf/torch_clip_loc_profile.py [--device cuda]
"""

import argparse
import collections
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from instance_based_loc_tpu_torch.data.synthetic import (  # noqa: E402
    default_scene, render_scene, ring_poses)
from instance_based_loc_tpu_torch.memory import (  # noqa: E402
    ColorRegionDetector, DepthRegionDetector, ObjectMemory)
from instance_based_loc_tpu_torch.memory import clip_loc  # noqa: E402
from instance_based_loc_tpu_torch.models.embedders import (  # noqa: E402
    get_embedder)

FOCAL, H, W = 525.0, 480, 640


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def stage_timers(device):
    """Wraps clip_loc's P3P, projection and refinement calls and the
    detector with synchronised host timers; returns the totals (ms)."""
    totals = collections.defaultdict(float)

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(device)
            totals[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    clip_loc.batched_p3p = timed("p3p", clip_loc.batched_p3p)
    clip_loc.project_points = timed("projection (scoring, inliers)",
                                    clip_loc.project_points)
    clip_loc.refine_pnp = timed("refine_pnp", clip_loc.refine_pnp)
    clip_loc._distinct_pixels = timed("distinct pixels",
                                      clip_loc._distinct_pixels)
    return totals, timed


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    scene = default_scene(num_objects=9, seed=3)
    poses = ring_poses(9, radius=4.5, height=1.3, target=(0, 0.4, 0))
    frames = [render_scene(scene, pose, H, W, FOCAL) for pose in poses]
    embed = get_embedder("color")
    memory = ObjectMemory(detector=DepthRegionDetector(FOCAL, FOCAL,
                                                       min_area=400),
                          camera_focal_lenth_x=FOCAL,
                          camera_focal_lenth_y=FOCAL,
                          get_embeddings_func=embed, log_enabled=False,
                          device=device)
    for i in range(6):
        rgb, depth, _ = frames[i]
        memory.process_image(rgb, depth, poses[i], consider_floor=True,
                             min_points=200, outlier_removal_config=None)
    memory.downsample_all_objects(voxel_size=0.02)
    memory.recluster_objects_with_dbscan(eps=0.1, min_points_per_cluster=40)
    mem = clip_loc.ClipLocObjectMemory.from_object_memory(memory,
                                                          log_enabled=False)
    k_cv = np.array([[FOCAL, 0, W / 2], [0, -FOCAL, H / 2], [0, 0, 1]],
                    np.float32)
    query = ColorRegionDetector(min_area=500,
                                floor_colors=[scene.floor_color])
    rgb = frames[6][0]

    def call():
        return mem.localize(rgb, k_cv, query, embed, k=3, rounds=200)

    est = call()                                   # warm-up
    print(f"{len(mem)} clip_loc objects; view 6 pose {np.round(est, 4)}; "
          f"true {np.round(poses[6], 4)}")
    totals, timed = stage_timers(device)
    query.find = timed("detection", query.find)
    embed_timed = timed("embedding", embed)

    def staged():
        return mem.localize(rgb, k_cv, query, embed_timed, k=3, rounds=200)

    reps = 5
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        staged()
    sync(device)
    per_call = (time.perf_counter() - t0) / reps * 1e3
    print(f"localize: {per_call:.1f} ms per call over {reps} calls (stages "
          f"timed with the card synchronised)")
    for name, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {ms / reps:.1f} ms per call")
    print(f"  the rest (sampling, gathers, copies): "
          f"{per_call - sum(totals.values()) / reps:.1f} ms per call")
    if device.type != "cuda":
        return
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    print(f"profiled call: wall {wall:.1f} ms (profiler on), device busy "
          f"{busy / 1e3:.2f} ms, idle share {1 - busy / 1e3 / wall:.3f}, "
          f"{len(spans)} device kernels and copies")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=8))
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=8))


if __name__ == "__main__":
    main()
