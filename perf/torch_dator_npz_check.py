"""The committed DATOR checkpoint in both packages, on the CPU.

1. Loads the flat npz (default `out/dator_params_latest.npz`) into the JAX
   package's DATOR embedder and the port's, both in fp32, and embeds the
   detections of the neural quality loop's scene
   (`scripts/neural_quality_loop.py` stage 1: `textured_scene(9, seed 3,
   id_seed 0)`, 24 ring views at 240x320, focal 300, the depth detector) on
   a few views; prints the cosine and max |diff| of the two packages'
   embeddings per crop.
2. Runs the port's trial CLI on that scene with the loop's flags
   (`--embeddings dator --embedder-checkpoint <npz> --detector depth`, the
   odd views held out) on the CPU in fp32 (IBL_MODEL_DTYPE=float32), and
   prints k/12 of the eval views within the reference's gate, beside the
   JAX package's `out/neural_loop_r5_results.txt` (12/12).

Too slow for the test suite (two ViT-B towers per crop batch on the CPU):

    JAX_PLATFORMS=cpu python perf/torch_dator_npz_check.py [--npz PATH]
        [--views 0 5 10] [--skip-cli]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["IBL_MODEL_DTYPE"] = "float32"


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--npz", default="out/dator_params_latest.npz")
    p.add_argument("--views", type=int, nargs="+", default=[0, 5, 10])
    p.add_argument("--skip-cli", action="store_true")
    p.add_argument("--out-dir", default="out/torch")
    args = p.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from instance_based_loc_tpu.memory.detection import (
        Detections as JaxDetections)
    from instance_based_loc_tpu.models.dator import (
        fourdnet as jfd, transreid_vit as jvit)
    from instance_based_loc_tpu.models.dator.embedder import (
        build_dator_embedder as jax_embedder)
    from instance_based_loc_tpu_torch.cli import localisation_trial as lt
    from instance_based_loc_tpu_torch.data.synthetic import (
        render_scene, ring_poses, textured_scene, write_synth_dataset)
    from instance_based_loc_tpu_torch.memory import DepthRegionDetector
    from instance_based_loc_tpu_torch.models.dator.embedder import (
        build_dator_embedder, default_config)
    from instance_based_loc_tpu_torch.utils.metrics import is_success

    scene = textured_scene(num_objects=9, seed=3, id_seed=0)
    jcfg = jfd.FourDNetConfig(
        backbone=jvit.TransReIDConfig(local_feature=True, dtype=jnp.float32),
        dtype=jnp.float32)
    jembed = jax_embedder(args.npz, model_cfg=jcfg)
    tembed = build_dator_embedder(args.npz,
                                  model_cfg=default_config(torch.float32),
                                  device="cpu")
    detector = DepthRegionDetector(300.0, 300.0, min_area=400)
    poses = ring_poses(24)
    worst_cos, worst_diff, n = 1.0, 0.0, 0
    for view in args.views:
        rgb, depth, _ = render_scene(scene, poses[view], 240, 320, 300.0)
        det = detector.find(rgb, True, depth=depth)
        jdet = JaxDetections(det.crops, det.boxes_xyxy, det.masks,
                             det.phrases)
        ref = np.asarray(jembed(jdet, full_rgb_image=rgb,
                                full_depth_image=depth))
        out = tembed(det, full_rgb_image=rgb, full_depth_image=depth)
        cos = np.sum(ref * out, -1) / (np.linalg.norm(ref, axis=-1)
                                       * np.linalg.norm(out, axis=-1))
        diff = np.abs(ref - out).max(-1) / np.abs(ref).max(-1)
        print(f"view {view}: {len(det)} crops; port against JAX, same npz, "
              f"fp32: cosine min {cos.min():.7f}, max |diff| "
              f"{diff.max():.3g} of max |JAX|", flush=True)
        worst_cos, worst_diff = min(worst_cos, cos.min()), max(worst_diff,
                                                              diff.max())
        n += len(det)
    print(f"embeddings of {n} crops: cosine min {worst_cos:.7f}, max |diff| "
          f"{worst_diff:.3g} of max |JAX|", flush=True)
    if args.skip_cli:
        return

    with tempfile.TemporaryDirectory() as data:
        write_synth_dataset(data, scene=scene, n_views=24, height=240,
                            width=320, focal_length=300.0)
        eval_idx = list(range(1, 24, 2))
        targs = lt.apply_convention_defaults(lt.make_parser().parse_args(
            ["--convention", "synth", "--data-path", data,
             "--embeddings", "dator", "--embedder-checkpoint", args.npz,
             "--detector", "depth", "-e", *map(str, eval_idx),
             "--consider-floor", "--min-points", "500",
             "--no-outlier-removal", "--testname", "neural_loop_port",
             "--out-dir", args.out_dir, "--device", "cpu", "--quiet"]))
        trans, rot = lt.main(targs)
    ok = sum(is_success(t, r) for t, r in zip(trans, rot))
    print(f"port CLI, neural loop scene, dator npz in fp32 on the CPU: "
          f"{ok}/{len(eval_idx)} eval views within the gate (JAX package: "
          f"out/neural_loop_r5_results.txt)", flush=True)


if __name__ == "__main__":
    main()
