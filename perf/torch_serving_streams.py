"""bench.py's serving stream pose by pose, in either package: how often
each eval view of the bench scene is localised within the reference's gate
(0.6 m, 0.3 rad) over many random streams.

The bench scene (bench.py:233-264: `default_scene(9, seed 3)`, 9 ring views
at 640x480, focal 525, `ColorRegionDetector(min_area=500)`, memory from
views 0-5, voxel 0.02, DBSCAN 0.1 / 40) serves views 6-8 x `--repeat`
(24: bench.py's 72-query stream) through `localise_many`; query j draws
from seed base + j + 1, so each view meets `--repeat` streams. The port
builds the memory (on `--device`) and saves it to `--memory-pkl`, or loads
it from there, so both packages, and the card, can serve one memory.

    JAX_PLATFORMS=cpu python perf/torch_serving_streams.py --package jax \\
        --memory-pkl bench_memory.pkl
    python3 perf/torch_serving_streams.py --package port --device cuda \\
        --batch 12 --memory-pkl bench_memory.pkl
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

FOCAL, H, W = 525.0, 480, 640
EVAL_VIEWS = (6, 7, 8)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--package", choices=["jax", "port"], required=True,
                   help="the package that serves the stream")
    p.add_argument("--memory-pkl", default=None,
                   help="load the port-built memory from this pkl if it "
                        "exists, else build it (with the port) and save it")
    p.add_argument("--device", default="cpu", help="the port's device")
    p.add_argument("--batch", type=int, default=1,
                   help="localise_many's chunk size")
    p.add_argument("--repeat", type=int, default=24)
    args = p.parse_args()

    from instance_based_loc_tpu_torch.data.synthetic import (
        default_scene, render_scene, ring_poses)
    from instance_based_loc_tpu_torch.memory import (ColorRegionDetector,
                                                     ObjectMemory)
    from instance_based_loc_tpu_torch.models.embedders import get_embedder
    from instance_based_loc_tpu_torch.utils.metrics import (is_success,
                                                           pose_errors)

    scene = default_scene(num_objects=9, seed=3)
    poses = ring_poses(9, radius=4.5, height=1.3, target=(0, 0.4, 0))
    frames = [render_scene(scene, q, H, W, FOCAL) for q in poses]

    def port_memory():
        return ObjectMemory(
            detector=ColorRegionDetector(min_area=500,
                                         floor_colors=[scene.floor_color]),
            camera_focal_lenth_x=FOCAL, camera_focal_lenth_y=FOCAL,
            get_embeddings_func=get_embedder("color"), log_enabled=False,
            device=args.device)

    base = 6                      # one seed per memory-build view
    if args.memory_pkl and os.path.exists(args.memory_pkl):
        source = args.memory_pkl
    else:
        memory = port_memory()
        for i in range(6):
            rgb, depth, _ = frames[i]
            memory.process_image(rgb, depth, poses[i], consider_floor=True,
                                 min_points=200, outlier_removal_config=None)
        memory.downsample_all_objects(voxel_size=0.02)
        memory.recluster_objects_with_dbscan(eps=0.1,
                                             min_points_per_cluster=40)
        if memory._frame_counter != base:
            raise RuntimeError(f"the build drew {memory._frame_counter} "
                               f"seeds, not {base}")
        source = args.memory_pkl or "memory.pkl"
        memory.save_to_pkl(source)
        source = f"the port on {args.device}, saved to {source}"
    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from instance_based_loc_tpu.memory import (
            ColorRegionDetector as JaxDetector, ObjectMemory as JaxMemory)
        from instance_based_loc_tpu.models.embedders import (
            get_embedder as jax_embedder)
        memory = JaxMemory(
            detector=JaxDetector(min_area=500,
                                 floor_colors=[scene.floor_color]),
            camera_focal_lenth_x=FOCAL, camera_focal_lenth_y=FOCAL,
            get_embeddings_func=jax_embedder("color"), log_enabled=False)
    else:
        memory = port_memory()
    memory.load(args.memory_pkl or "memory.pkl")
    print(f"{args.package}: memory of {len(memory.memory)} objects from "
          f"{source}", flush=True)

    views = list(EVAL_VIEWS) * args.repeat
    memory._frame_counter = base
    out = memory.localise_many([frames[v][:2] for v in views],
                               batch=args.batch, outlier_removal_config=None)
    fails = {v: [] for v in EVAL_VIEWS}
    for j, (v, (est, _)) in enumerate(zip(views, out)):
        te, re_ = pose_errors(poses[v], est)
        if not is_success(te, re_):
            fails[v].append((j, round(float(te), 3), round(float(re_), 3)))
    for v in EVAL_VIEWS:
        print(f"{args.package}: view {v}: {args.repeat - len(fails[v])} / "
              f"{args.repeat} streams within the gate; misses (query, m, "
              f"rad): {fails[v]}", flush=True)
    total = sum(len(f) for f in fails.values())
    print(f"{args.package}: {len(views) - total} / {len(views)} queries "
          f"within the gate", flush=True)


if __name__ == "__main__":
    main()
