"""Generic localisation trial (counterpart of
`instance_based_loc_tpu/cli/localisation_trial.py`: the reference's
{tum,real,synth,8room}_localisation_trial.py folded into one script with a
--convention flag; the flags and the results.txt format are kept).

It runs on the card by default; `--device cpu` runs it on the CPU, and
without a card the default raises. `--serve-batch G` serves the eval views
through `ObjectMemory.localise_many` in chunks of G queries, one program
per chunk (a CUDA-graph replay on the card where the query configuration
allows it), as the JAX CLI's throughput mode does; `--serve-data-axis`
above 1 raises, since the port runs on one card.

Example (synthetic fixture, weights-free):
    python -m instance_based_loc_tpu_torch.cli.localisation_trial \\
        --convention synth --data-path <dir> --embeddings color \\
        --detector color --focal-length 300 -e 4
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .. import resolve_device
from ..data.loader import RGBDDataset
from ..memory import ColorRegionDetector, DepthRegionDetector, ObjectMemory
from ..models.embedders import get_embedder
from ..utils.logging import get_mem_stats
from ..utils.metrics import format_results_report, is_success, pose_errors


# Per-dataset tuned defaults, mirroring the reference trial scripts
# ({tum,real,8room,irl_rrc}_localisation_trial.py argparse blocks; synth uses
# the committed fixture's focal length 300 and the repo's tuned FPFH factors).
# Applied only where the user did not pass the flag explicitly.
CONVENTION_DEFAULTS = {
    "tum": dict(focal_length_x=525.0, focal_length_y=525.0,
                start_file_index=0, last_file_index=1500, sampling_period=30,
                fpfh_global_dist_factor=1.5, fpfh_local_dist_factor=1.5,
                fpfh_voxel_size=0.05),
    "real": dict(focal_length_x=385.28887939453125,
                 focal_length_y=384.3631591796875,
                 start_file_index=0, last_file_index=1200, sampling_period=40,
                 fpfh_global_dist_factor=1.5, fpfh_local_dist_factor=1.5,
                 fpfh_voxel_size=0.05),
    "8room": dict(focal_length_x=300.0, focal_length_y=300.0,
                  start_file_index=200, last_file_index=1500,
                  sampling_period=15,
                  fpfh_global_dist_factor=1.5, fpfh_local_dist_factor=1.5,
                  fpfh_voxel_size=0.05),
    "hm3d": dict(focal_length_x=300.0, focal_length_y=300.0,
                 start_file_index=0, last_file_index=None, sampling_period=30,
                 fpfh_global_dist_factor=1.5, fpfh_local_dist_factor=1.5,
                 fpfh_voxel_size=0.05),
    "synth": dict(focal_length_x=300.0, focal_length_y=300.0,
                  start_file_index=0, last_file_index=None, sampling_period=1,
                  fpfh_global_dist_factor=2.0, fpfh_local_dist_factor=0.4,
                  fpfh_voxel_size=0.05),
}


def apply_convention_defaults(args):
    """Fill None-valued flags from the per-convention table. An explicit
    --focal-length(-x) without -y sets both."""
    if args.focal_length_y is None and args.focal_length_x is not None:
        args.focal_length_y = args.focal_length_x
    for key, val in CONVENTION_DEFAULTS[args.convention].items():
        if getattr(args, key, None) is None:
            setattr(args, key, val)
    if args.focal_length_y is None:
        args.focal_length_y = args.focal_length_x
    return args


def build_detector(args):
    if args.detector == "color":
        return ColorRegionDetector(min_area=args.min_region_area)
    if args.detector == "depth":
        return DepthRegionDetector(args.focal_length_x, args.focal_length_y,
                                   min_area=max(args.min_region_area, 400))
    if args.detector == "cascade":
        from ..models.cascade import build_cascade_detector
        if not (args.ram_checkpoint or args.gdino_checkpoint
                or args.sam_checkpoint):
            raise SystemExit(
                "--detector cascade without any checkpoint degenerates to one "
                "full-image box per keyword (useless). Pass --ram-checkpoint/"
                "--gdino-checkpoint/--sam-checkpoint, or use --detector color.")
        return build_cascade_detector(ram_checkpoint=args.ram_checkpoint,
                                      gdino_checkpoint=args.gdino_checkpoint,
                                      sam_checkpoint=args.sam_checkpoint,
                                      gdino_vocab=args.gdino_vocab,
                                      ram_tag_list=args.ram_tag_list,
                                      device=args.device)
    raise ValueError(f"unknown detector {args.detector}")


def build_memory(args, memory, dataloader, outlier_cfg,
                 recluster: str = "clustering_and_IoU"):
    """The trial scripts' shared memory-build phase (reference
    tum_localisation_trial.py:97-176): process every environment frame,
    downsample, optional floor removal, recluster (the IoU strategy, or
    DBSCAN alone for clip_loc), optional pkl save."""
    depth_factor = dataloader.depth_factor
    indices = list(dataloader.environment_indices)
    chunk = max(1, getattr(args, "detect_batch", 1) or 1)
    find_batch = getattr(memory.detector, "find_batch", None)
    use_batch = chunk > 1 and find_batch is not None
    chunks = [indices[i:i + chunk] for i in range(0, len(indices), chunk)]

    def load_and_detect(idxs):
        items = [dataloader.get_image_data(i) for i in idxs]
        if not use_batch:
            return items, [p for p, _, _ in items], [None] * len(items)
        # chunked build: detect the whole chunk in batched calls
        # (CascadeDetector.find_batch), then feed each frame through the
        # per-frame embed / backproject step
        rgbs = [p if isinstance(p, np.ndarray)
                else memory.load_rgb_image_func(p) for p, _, _ in items]
        return items, rgbs, find_batch(rgbs, args.consider_floor)

    def detected_chunks():
        if not use_batch:
            for ch in chunks:
                yield load_and_detect(ch)
            return
        # prefetch depth 1: the next chunk's image loads and detection run
        # on a worker thread while this thread drains the current chunk
        # through process_image
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = None
            for ch in chunks:
                nxt = ex.submit(load_and_detect, ch)
                if fut is None:
                    fut = nxt
                    continue
                yield fut.result()
                fut = nxt
            if fut is not None:
                yield fut.result()

    for items, rgbs, dets in detected_chunks():
        for (_, depth_path, pose), rgb, det in zip(items, rgbs, dets):
            memory.process_image(rgb, depth_path, pose,
                                 consider_floor=args.consider_floor,
                                 depth_factor=depth_factor,
                                 min_points=args.min_points,
                                 outlier_removal_config=outlier_cfg,
                                 detections=det)
            mem_gb, dev_gb = get_mem_stats(memory.device)
            if not args.quiet:
                print(f"Using {mem_gb} GB of memory and {dev_gb} GB of device")

    memory.downsample_all_objects(voxel_size=args.downsample_voxel_size)
    if args.remove_floor:
        memory.remove_points_below_floor()
    if recluster == "clustering_and_IoU":
        memory.recluster_via_clustering_and_IoU(
            embedding_distance_threshold=args.embedding_distance_threshold,
            eps=args.dbscan_eps,
            min_points_per_cluster=args.dbscan_min_points,
            IoU_threshold=args.iou_threshold)
    elif recluster == "dbscan":
        memory.recluster_objects_with_dbscan(
            eps=args.dbscan_eps,
            min_points_per_cluster=args.dbscan_min_points)
    else:
        raise ValueError(f"unknown recluster strategy {recluster!r}")
    if not args.quiet:
        print("\nMemory is")
        print(memory)
    if args.memory_save_path:
        os.makedirs(os.path.dirname(os.path.abspath(args.memory_save_path)),
                    exist_ok=True)
        memory.save_to_pkl(args.memory_save_path)
    return memory


def main(args, detector=None):
    """Build (or load) the memory, localise the eval views, write the
    report; returns (translation errors, rotation errors)."""
    if args.serve_data_axis > 1:
        raise ValueError("--serve-data-axis above 1: the port runs on one "
                         "card")
    # per-frame debug ply dumps are a latency-mode feature
    if args.serve_batch > 1 and args.save_point_clouds:
        raise SystemExit("--save-point-clouds requires latency-mode "
                         "serving; drop --serve-batch")
    device = resolve_device(args.device)
    embed_kwargs = ({"checkpoint_path": args.embedder_checkpoint}
                    if getattr(args, "embedder_checkpoint", None) else {})
    embeddings_func = get_embedder(args.embeddings, device=device,
                                   **embed_kwargs)
    if detector is None:
        detector = build_detector(args)

    memory = ObjectMemory(
        detector=detector,
        camera_focal_lenth_x=args.focal_length_x,
        camera_focal_lenth_y=args.focal_length_y,
        get_embeddings_func=embeddings_func,
        log_enabled=not args.quiet,
        device=device,
    )

    dataloader = RGBDDataset(
        data_path=args.data_path,
        evaluation_indices=args.eval_img_inds,
        convention=args.convention,
        focal_length_x=args.focal_length_x,
        focal_length_y=args.focal_length_y,
        map_pointcloud_cache_path=args.map_pcd_cache_path,
        start_file_index=args.start_file_index,
        last_file_index=args.last_file_index,
        sampling_period=args.sampling_period,
        build_map=args.build_map,
        device=device,
    )
    depth_factor = dataloader.depth_factor
    # the Kinect frame fix applies only to the map cloud (reference
    # tum_dataloader.py:109); process_image uses the plain transform even
    # for TUM (reference object_memory.py:221), so the memory, the
    # estimates and the parsed ground truth share one convention.
    # mm-scale sensors want the reference outlier config; coarse synthetic
    # depth (point spacing > radius) must disable it or clouds get wiped
    outlier_cfg = None if args.no_outlier_removal else {
        "radius_nb_points": 12, "radius": 0.05}
    localise_outlier_cfg = None if args.no_outlier_removal else {
        "radius_nb_points": 8, "radius": 0.05}

    if args.load_memory and args.memory_load_path:
        memory.load(args.memory_load_path)
    else:
        build_memory(args, memory, dataloader, outlier_cfg)

    loc_kwargs = dict(
        outlier_removal_config=localise_outlier_cfg,
        fpfh_global_dist_factor=args.fpfh_global_dist_factor,
        fpfh_local_dist_factor=args.fpfh_local_dist_factor,
        fpfh_voxel_size=args.fpfh_voxel_size,
        depth_factor=depth_factor)

    frames_meta = [dataloader.get_image_data(idx) for idx in args.eval_img_inds]
    if args.serve_batch > 1:
        # throughput serving: chunks of G queries, one device program each
        # (bench.py's serving configuration)
        results = memory.localise_many(
            [(rgb, depth) for rgb, depth, _ in frames_meta],
            batch=args.serve_batch, **loc_kwargs)
    else:
        results = [memory.localise(
            rgb_path, depth_path, testname=args.testname,
            subtest_name=str(idx), save_point_clouds=args.save_point_clouds,
            **loc_kwargs)
            for idx, (rgb_path, depth_path, _) in zip(args.eval_img_inds,
                                                      frames_meta)]

    trans_errors, rot_errors, assignments = [], [], []
    for idx, (_, _, target_pose), (estimated_pose, assn) in zip(
            args.eval_img_inds, frames_meta, results):
        te, re_ = pose_errors(target_pose, estimated_pose)
        print(f"Localisation {idx}: trans={te:.3f} rot={re_:.3f} "
              f"{'SUCCESS' if is_success(te, re_) else 'MISALIGNED'}")
        trans_errors.append(te)
        rot_errors.append(re_)
        assignments.append(assn)

    os.makedirs(args.out_dir, exist_ok=True)
    report = format_results_report(trans_errors, rot_errors, assignments)
    with open(os.path.join(args.out_dir, f"{args.testname}_results.txt"),
              "w") as f:
        f.write(report)
    print(report)
    return trans_errors, rot_errors


def make_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--convention",
                   choices=["tum", "real", "synth", "8room", "hm3d"],
                   default="synth")
    p.add_argument("--data-path", type=str, required=True)
    p.add_argument("-e", "--eval-img-inds", type=int, nargs="+", default=[4])
    p.add_argument("--embeddings", type=str, default="dino",
                   help="clip | dino | vit | dator | color | dummy")
    p.add_argument("--detector", type=str, default="color",
                   help="cascade (RAM+GroundingDINO+SAM; requires checkpoints)"
                        " | color (weights-free default) | depth "
                        "(weights-free geometric segmentation)")
    p.add_argument("--ram-checkpoint", type=str, default=None)
    p.add_argument("--gdino-checkpoint", type=str, default=None)
    p.add_argument("--gdino-vocab", type=str, default=None,
                   help="BERT vocab.txt for the grounder's tokenizer")
    p.add_argument("--ram-tag-list", type=str, default=None,
                   help="ram_tag_list.txt (index-aligned with the checkpoint)")
    p.add_argument("--sam-checkpoint", type=str, default=None)
    p.add_argument("--embedder-checkpoint", type=str, default=None,
                   help="weights for --embeddings vit/dino/clip (an HF "
                        ".bin/.pth, a flat .npz of JAX params, or the "
                        "port's own state dict) or dator (a flat .npz "
                        "checkpoint)")
    p.add_argument("--focal-length-x", "--focal-length", type=float,
                   default=None, dest="focal_length_x")
    p.add_argument("--focal-length-y", type=float, default=None)
    p.add_argument("--map-pcd-cache-path", type=str, default=None)
    p.add_argument("--build-map", action="store_true")
    p.add_argument("--start-file-index", type=int, default=None)
    p.add_argument("--last-file-index", type=int, default=None)
    p.add_argument("--sampling-period", type=int, default=None)
    p.add_argument("--testname", type=str, default="trial")
    p.add_argument("--out-dir", type=str, default="./out/torch",
                   help="results directory; the default keeps the port's "
                        "reports apart from the JAX package's in ./out")
    p.add_argument("--load-memory", action="store_true")
    p.add_argument("--memory-load-path", type=str, default=None)
    p.add_argument("--memory-save-path", type=str, default=None)
    p.add_argument("--save-point-clouds", action="store_true")
    p.add_argument("--consider-floor", action="store_true")
    p.add_argument("--remove-floor", action="store_true")
    p.add_argument("--min-points", type=int, default=500)
    p.add_argument("--min-region-area", type=int, default=120)
    p.add_argument("--downsample-voxel-size", type=float, default=0.01)
    p.add_argument("--embedding-distance-threshold", type=float, default=0.5)
    p.add_argument("--dbscan-eps", type=float, default=0.05)
    p.add_argument("--dbscan-min-points", type=int, default=50)
    p.add_argument("--iou-threshold", type=float, default=0.25)
    p.add_argument("--fpfh-global-dist-factor", type=float, default=None)
    p.add_argument("--fpfh-local-dist-factor", type=float, default=None)
    p.add_argument("--fpfh-voxel-size", type=float, default=None)
    p.add_argument("--no-outlier-removal", action="store_true",
                   help="disable radius outlier filtering (coarse synthetic "
                        "depth)")
    p.add_argument("--serve-batch", type=int, default=1,
                   help="throughput serving: localise the eval views in "
                        "chunks of G queries, one device program per chunk "
                        "(1 = latency mode, one localise per view)")
    p.add_argument("--serve-data-axis", type=int, default=1,
                   help="the JAX package's multi-chip serving axis; the "
                        "port runs on one card, so only 1 runs")
    p.add_argument("--detect-batch", type=int, default=1,
                   help="memory build: detect frames in chunks of F (the "
                        "cascade's find_batch), the next chunk on a worker "
                        "thread")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda by default; cpu runs "
                        "on the host)")
    p.add_argument("--quiet", action="store_true")
    return p


if __name__ == "__main__":
    main(apply_convention_defaults(make_parser().parse_args()))
