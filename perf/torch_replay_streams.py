"""Chosen poses of the 86-pose synthetic replay over several random
streams, in either package, on the CPU.

The replay (`synth_localisation_trial --num-objects 12 --n-views 172
--eval-every 2`) localises each eval pose once, with the random stream its
position in the run gives it. This builds the same memory as the trial CLI
does, then localises each chosen pose with that stream (stream 0) and with
`--streams - 1` others, and prints each pose's successes within the
reference's gate (0.6 m, 0.3 rad): a pose that succeeds on some streams and
not on others is marginal in that package. With `--streams 1` and every
pose, it replays the CLI's run pose by pose.

`--memory-from` has the other package build the memory, which the one that
localises then loads from its pkl, so both packages can be held to one
memory. `--no-native` switches off the JAX package's compiled helpers
(voxel grid, DBSCAN, radius outliers), so that it builds by its numpy
path, which the port follows.

    JAX_PLATFORMS=cpu python perf/torch_replay_streams.py --package jax \\
        --poses 20 24 37 --streams 10 [--memory-from port] [--no-native]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def _package(name):
    """(trial CLI module, RGBDDataset, ColorRegionDetector, ObjectMemory,
    get_embedder, device kwargs) of one package."""
    if name == "jax":
        from instance_based_loc_tpu.cli import localisation_trial as lt
        from instance_based_loc_tpu.data.loader import RGBDDataset
        from instance_based_loc_tpu.memory import (ColorRegionDetector,
                                                   ObjectMemory)
        from instance_based_loc_tpu.models.embedders import get_embedder
        return lt, RGBDDataset, ColorRegionDetector, ObjectMemory, \
            get_embedder, {}
    from instance_based_loc_tpu_torch.cli import localisation_trial as lt
    from instance_based_loc_tpu_torch.data.loader import RGBDDataset
    from instance_based_loc_tpu_torch.memory import (ColorRegionDetector,
                                                     ObjectMemory)
    from instance_based_loc_tpu_torch.models.embedders import get_embedder
    return lt, RGBDDataset, ColorRegionDetector, ObjectMemory, \
        get_embedder, {"device": "cpu"}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--package", choices=["jax", "port"], required=True,
                   help="the package that localises")
    p.add_argument("--memory-from", choices=["jax", "port"], default=None,
                   help="the package that builds the memory (default: the "
                        "one that localises); the other loads its pkl")
    p.add_argument("--poses", type=int, nargs="+", required=True,
                   help="1-based pose numbers of the replay's report")
    p.add_argument("--streams", type=int, default=10)
    p.add_argument("--no-native", action="store_true",
                   help="JAX package: build by the numpy path")
    args = p.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.no_native:
        from instance_based_loc_tpu.ops import native
        for name in ("voxel_downsample_native", "dbscan_native",
                     "radius_outlier_native"):
            setattr(native, name, lambda *a, **k: None)
    from instance_based_loc_tpu.data.synthetic import (default_scene,
                                                       write_synth_dataset)
    from instance_based_loc_tpu.utils.metrics import is_success, pose_errors

    scene = default_scene(num_objects=12, seed=3)
    eval_inds = list(range(1, 172, 2))

    def make(name, data):
        lt, RGBDDataset, Detector, ObjectMemory, get_embedder, device = \
            _package(name)
        memory = ObjectMemory(
            Detector(min_area=80, floor_colors=[scene.floor_color]),
            300.0, 300.0, get_embedder("color"), log_enabled=False, **device)
        ds = RGBDDataset(data, eval_inds, convention="synth",
                         focal_length_x=300.0, focal_length_y=300.0,
                         build_map=False, **device)
        return lt, memory, ds, device

    with tempfile.TemporaryDirectory() as data:
        write_synth_dataset(data, scene, n_views=172, height=240, width=320,
                            focal_length=300.0)
        flags = ["--convention", "synth", "--data-path", data,
                 "--embeddings", "color", "--focal-length", "300.0",
                 "-e", *map(str, eval_inds), "--consider-floor",
                 "--min-points", "200", "--downsample-voxel-size", "0.02",
                 "--dbscan-eps", "0.1", "--dbscan-min-points", "40",
                 "--no-outlier-removal", "--quiet"]
        builder = args.memory_from or args.package
        lt, memory, ds, device = make(builder, data)
        if device:
            flags += ["--device", "cpu"]
        targs = lt.apply_convention_defaults(lt.make_parser().parse_args(
            flags))
        lt.build_memory(targs, memory, ds, None)
        base = memory._frame_counter
        if builder != args.package:
            path = f"{data}/memory.pkl"
            memory.save_to_pkl(path)
            _, memory, ds, _ = make(args.package, data)
            memory.load(path)
        print(f"{args.package}: memory of {len(memory.memory)} objects "
              f"built by {builder}", flush=True)
        first = 0
        for pose in args.poses:
            rgb, depth, target = ds.get_image_data(eval_inds[pose - 1])
            results = []
            for s in range(args.streams):
                # stream 0 is the one the replay's run gives this pose
                memory._frame_counter = base + pose - 1 + 1000 * s
                est, _ = memory.localise(
                    rgb, depth, outlier_removal_config=None,
                    fpfh_global_dist_factor=targs.fpfh_global_dist_factor,
                    fpfh_local_dist_factor=targs.fpfh_local_dist_factor,
                    fpfh_voxel_size=targs.fpfh_voxel_size)
                results.append(pose_errors(target, est))
            ok = sum(is_success(te, re_) for te, re_ in results)
            first += is_success(*results[0])
            print(f"{args.package}: pose {pose}: stream 0 translation "
                  f"{results[0][0]:.3f} m; {ok} / {args.streams} streams "
                  f"within the gate", flush=True)
        print(f"{args.package}: stream 0 within the gate on {first} of "
              f"{len(args.poses)} poses", flush=True)


if __name__ == "__main__":
    main()
