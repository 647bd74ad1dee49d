"""Synthetic end-to-end localisation demo (counterpart of
`instance_based_loc_tpu/cli/synth_localisation_trial.py`): writes a
procedural scene (no downloads), builds the memory with the weights-free
colour detector and embedder, localises held-out views and prints the
binned report. Runs on the card unless `--device cpu` is given.

    python -m instance_based_loc_tpu_torch.cli.synth_localisation_trial --quick
"""

from __future__ import annotations

import argparse
import tempfile

from ..data.synthetic import default_scene, write_synth_dataset
from ..memory import ColorRegionDetector
from . import localisation_trial


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true", help="small scene, fast run")
    p.add_argument("--num-objects", type=int, default=6)
    p.add_argument("--n-views", type=int, default=8)
    p.add_argument("--eval-every", type=int, default=0,
                   help="hold out every k-th view as an eval pose (the "
                        "reference's committed run evaluates 86 poses); "
                        "0 = last view only")
    p.add_argument("--out-dir", type=str, default="./out/torch",
                   help="results directory; the default keeps the port's "
                        "reports apart from the JAX package's in ./out")
    p.add_argument("--data-path", type=str, default=None,
                   help="write/reuse the generated dataset here")
    p.add_argument("--testname", type=str, default="synth_trial")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    height, width, focal = (160, 220, 200.0) if args.quick else (240, 320, 300.0)
    n_views = 7 if args.quick else args.n_views

    data_dir = args.data_path or tempfile.mkdtemp(prefix="synth_trial_")
    num_objects = 5 if args.quick else args.num_objects
    scene = default_scene(num_objects=num_objects, seed=3)
    write_synth_dataset(data_dir, scene, n_views=n_views,
                        height=height, width=width, focal_length=focal)
    print(f"Synthetic dataset at {data_dir}")

    if args.eval_every > 0:
        eval_indices = [str(i) for i in range(1, n_views, args.eval_every)]
    else:
        eval_indices = [str(n_views - 1)]
    trial_args = localisation_trial.make_parser().parse_args([
        "--convention", "synth",
        "--data-path", data_dir,
        "--embeddings", "color",
        "--detector", "color",
        "--focal-length", str(focal),
        "-e", *eval_indices,
        "--consider-floor",
        "--min-points", "200",
        "--downsample-voxel-size", "0.02",
        "--dbscan-eps", "0.1",
        "--dbscan-min-points", "40",
        "--no-outlier-removal",
        "--testname", args.testname,
        "--out-dir", args.out_dir,
        "--device", args.device,
    ])
    trial_args = localisation_trial.apply_convention_defaults(trial_args)
    detector = ColorRegionDetector(min_area=80,
                                   floor_colors=[scene.floor_color])
    return localisation_trial.main(trial_args, detector=detector)


if __name__ == "__main__":
    main()
