"""Generate a ReID training dataset from a scene (counterpart of
`instance_based_loc_tpu/cli/gen_reid_dataset.py`; reference
`tum_gen_dataset_trial.py` + ObjectDatasetMemory.dump_dataset): build a
memory that keeps each observation's crops, cluster it, dump
dir-per-instance RGB / depth crops.

    python -m instance_based_loc_tpu_torch.cli.gen_reid_dataset \\
        --out ./data/reid [--data-path DATASET --convention synth ...]
    python -m instance_based_loc_tpu_torch.cli.gen_reid_dataset \\
        --out ./data/reid --synthetic                     # fixture scene

It runs on the card by default; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--convention", type=str, default="synth")
    p.add_argument("--focal-length", type=float, default=200.0)
    p.add_argument("--n-views", type=int, default=8)
    p.add_argument("--min-points", type=int, default=200)
    p.add_argument("--num-objects", type=int, default=6,
                   help="scene instances for --synthetic")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--textured", action="store_true",
                   help="ReID-identity textured scene (data.synthetic."
                        "textured_scene): object i wears procedural "
                        "identity i")
    p.add_argument("--height", type=int, default=160)
    p.add_argument("--width", type=int, default=220)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the CPU "
                        "path)")
    args = p.parse_args(argv)

    from .. import resolve_device
    from ..memory import ColorRegionDetector
    from ..memory.dataset_memory import ObjectDatasetMemory
    from ..models.embedders import get_embedder

    device = resolve_device(args.device)
    if args.synthetic or args.data_path is None:
        from ..data.synthetic import (default_scene, render_scene, ring_poses,
                                      textured_scene)
        if args.textured:
            from ..memory import DepthRegionDetector
            scene = textured_scene(num_objects=args.num_objects,
                                   seed=args.seed)
            # textures shatter colour quantisation: segment geometrically
            detector = DepthRegionDetector(args.focal_length,
                                           args.focal_length, min_area=200)
        else:
            scene = default_scene(num_objects=args.num_objects,
                                  seed=args.seed)
            detector = ColorRegionDetector(min_area=80,
                                           floor_colors=[scene.floor_color])
        poses = ring_poses(args.n_views, radius=4.5, height=1.3,
                           target=(0, 0.4, 0))
        memory = ObjectDatasetMemory(
            detector=detector, camera_focal_lenth_x=args.focal_length,
            camera_focal_lenth_y=args.focal_length,
            get_embeddings_func=get_embedder("color"), log_enabled=True,
            device=device)
        for pose in poses:
            rgb, depth, _ = render_scene(scene, pose, args.height,
                                         args.width, args.focal_length)
            memory.process_image(rgb, depth, pose, consider_floor=True,
                                 min_points=args.min_points)
    else:
        from ..data.loader import RGBDDataset
        ds = RGBDDataset(args.data_path, evaluation_indices=[],
                         convention=args.convention,
                         focal_length_x=args.focal_length,
                         focal_length_y=args.focal_length, build_map=False,
                         device=device)
        detector = ColorRegionDetector(min_area=80)
        memory = ObjectDatasetMemory(
            detector=detector, camera_focal_lenth_x=args.focal_length,
            camera_focal_lenth_y=args.focal_length,
            get_embeddings_func=get_embedder("color"), log_enabled=True,
            device=device)
        for idx in ds.environment_indices:
            rgb_path, depth_path, pose = ds.get_image_data(idx)
            memory.process_image(rgb_path, depth_path, pose,
                                 consider_floor=False,
                                 depth_factor=ds.depth_factor,
                                 min_points=args.min_points)

    # consolidate observations of the same instance before dumping
    memory.downsample_all_objects(voxel_size=0.02)
    memory.recluster_objects_with_dbscan(eps=0.1, min_points_per_cluster=40)
    memory.dump_dataset(args.out)
    print(f"instances: {len(memory.memory)}")


if __name__ == "__main__":
    main()
