"""clip_loc localisation trial (counterpart of
`instance_based_loc_tpu/cli/clip_loc_trial.py`; reference
`synth_clip_loc_trial.py`): ObjectMemory -> ClipLocObjectMemory -> detect
and match -> P3P-RANSAC localisation, from one command, with the JAX CLI's
flags and defaults plus `--device` (the card by default; `--device cpu`
runs on the CPU). Reports go to `out/torch/` unless `--out-dir` says
otherwise.

Example (weights-free):
    python -m instance_based_loc_tpu_torch.cli.clip_loc_trial \\
        --convention synth --data-path <dir> --embeddings color \\
        --detector depth -e 4 --no-outlier-removal

`--detector class` queries with the GroundingDINO-backed COCO-class
detector (the reference's YOLOv8 role, clip_loc/yolo_utils.py:27-57), and
`--clip-text-checkpoint` stores CLIP text embeddings of the object names in
the memory (clip_loc/clip_utils.py:30-54).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .. import resolve_device
from ..data.loader import RGBDDataset, load_rgb
from ..memory import ObjectMemory
from ..memory.clip_loc import ClipLocObjectMemory
from ..models.embedders import get_embedder
from ..utils.metrics import format_results_report, is_success, pose_errors
from .localisation_trial import (apply_convention_defaults, build_detector,
                                 build_memory, make_parser)


def build_clip_loc_detector(args):
    """The query-side detector: the COCO-class detector on GroundingDINO
    (`--detector class`, needs `--gdino-checkpoint`), else the trial's
    region detectors."""
    if args.detector == "class":
        from ..models.class_detector import build_class_detector
        if not args.gdino_checkpoint:
            raise SystemExit("--detector class needs --gdino-checkpoint "
                             "(weights-free: use --detector color/depth)")
        return build_class_detector(gdino_checkpoint=args.gdino_checkpoint,
                                    gdino_vocab=args.gdino_vocab,
                                    device=args.device)
    return build_detector(args)


def main(args, query_detector=None, memory_detector=None):
    """Build (or load) the memory, convert it, localise the eval views from
    RGB alone, write the report; returns (translation errors, rotation
    errors)."""
    device = resolve_device(args.device)
    # the memory is built with a mask-producing detector; clip_loc queries
    # are RGB only (the reference's localize takes no depth), so the depth
    # detector serves the memory side and the colour detector the queries
    if query_detector is None:
        query_detector = build_clip_loc_detector(
            args if args.detector != "depth"
            else argparse.Namespace(**{**vars(args), "detector": "color"}))
    if memory_detector is None:
        memory_detector = (build_detector(args) if args.detector != "class"
                           else build_detector(argparse.Namespace(
                               **{**vars(args), "detector": "color"})))
    embed = get_embedder(args.embeddings, device=device,
                         **({"checkpoint_path": args.embedder_checkpoint}
                            if getattr(args, "embedder_checkpoint", None)
                            else {}))

    dataloader = RGBDDataset(
        data_path=args.data_path,
        evaluation_indices=args.eval_img_inds,
        convention=args.convention,
        focal_length_x=args.focal_length_x,
        focal_length_y=args.focal_length_y,
        start_file_index=args.start_file_index,
        last_file_index=args.last_file_index,
        sampling_period=args.sampling_period,
        map_pointcloud_cache_path=args.map_pcd_cache_path,
        build_map=args.build_map,
        device=device,
    )
    if args.clip_loc_load_path:
        clip_mem = ClipLocObjectMemory.load(args.clip_loc_load_path,
                                            log_enabled=not args.quiet,
                                            device=device)
    else:
        memory = ObjectMemory(
            detector=memory_detector,
            camera_focal_lenth_x=args.focal_length_x,
            camera_focal_lenth_y=args.focal_length_y,
            get_embeddings_func=embed,
            log_enabled=not args.quiet,
            device=device)
        if args.load_memory and args.memory_load_path:
            memory.load(args.memory_load_path)
        else:
            outlier_cfg = None if args.no_outlier_removal else {
                "radius_nb_points": 12, "radius": 0.05}
            build_memory(args, memory, dataloader, outlier_cfg,
                         recluster="dbscan")

        text_embed_fn = None
        if args.clip_text_checkpoint:
            from ..models.clip_text import build_clip_text_embedder
            text_embed_fn = build_clip_text_embedder(
                args.clip_text_checkpoint, vocab_path=args.clip_bpe_vocab,
                merges_path=args.clip_bpe_merges, device=device)
        clip_mem = ClipLocObjectMemory.from_object_memory(
            memory, text_embed_fn=text_embed_fn,
            log_enabled=not args.quiet)
        if args.clip_loc_save_path:
            clip_mem.save(args.clip_loc_save_path)

    print(f"clip_loc memory: {len(clip_mem)} objects")

    trans_errors, rot_errors, assignments = [], [], []
    for idx in args.eval_img_inds:
        rgb_path, _, target_pose = dataloader.get_image_data(idx)
        rgb = load_rgb(rgb_path)
        h, w = rgb.shape[:2]
        # the loader's camera frame has y up while pixel rows grow down,
        # so the CV-style intrinsics flip fy (ops/backprojection.py grid)
        k_cv = np.array([[args.focal_length_x, 0, w / 2],
                         [0, -args.focal_length_y, h / 2],
                         [0, 0, 1]], np.float32)
        est = clip_mem.localize(rgb, k_cv, query_detector, embed,
                                k=args.top_k, rounds=args.ransac_rounds)
        if est is None:
            est = np.array([0., 0., 0., 0., 0., 0., 1.])
        te, re_ = pose_errors(target_pose, est)
        print(f"clip_loc localisation {idx}: trans={te:.3f} rot={re_:.3f} "
              f"{'SUCCESS' if is_success(te, re_) else 'MISALIGNED'}")
        trans_errors.append(te)
        rot_errors.append(re_)
        assignments.append([None, None])

    os.makedirs(args.out_dir, exist_ok=True)
    report = format_results_report(trans_errors, rot_errors, assignments)
    with open(os.path.join(args.out_dir, f"{args.testname}_results.txt"),
              "w") as f:
        f.write(report)
    print(report)
    return trans_errors, rot_errors


def make_clip_loc_parser() -> argparse.ArgumentParser:
    p = make_parser()
    p.add_argument("--clip-text-checkpoint", type=str, default=None,
                   help="HF CLIPTextModel checkpoint for the memory's text "
                        "embeddings (reference clip_utils.py role)")
    p.add_argument("--clip-bpe-vocab", type=str, default=None,
                   help="vocab.json for the CLIP byte-level BPE tokenizer")
    p.add_argument("--clip-bpe-merges", type=str, default=None,
                   help="merges.txt for the CLIP byte-level BPE tokenizer")
    p.add_argument("--clip-loc-save-path", type=str, default=None)
    p.add_argument("--clip-loc-load-path", type=str, default=None)
    p.add_argument("--top-k", type=int, default=3,
                   help="memory candidates per detection (reference k=3)")
    p.add_argument("--ransac-rounds", type=int, default=200,
                   help="P3P-RANSAC rounds (reference 100; all rounds solve "
                        "in one batched call)")
    return p


if __name__ == "__main__":
    main(apply_convention_defaults(make_clip_loc_parser().parse_args()))
