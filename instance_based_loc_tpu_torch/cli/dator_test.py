"""DATOR evaluation and embedding extraction (counterpart of
`instance_based_loc_tpu/cli/dator_test.py`; reference `dator/test.py` +
`dator/get_embeds.py:35-220`): load a trained checkpoint, embed a
dir-per-instance dataset, report CMC R1/5/10 and mAP (optionally
re-ranked), and write the pairwise cosine-similarity heatmap with
class-boundary lines.

    python -m instance_based_loc_tpu_torch.cli.dator_test \\
        --checkpoint out/torch/dator/step_240.pt data.root=./data/reid

`--checkpoint` takes the trainer's `step_N.pt`, a directory of them (the
latest is read) or a flat `.npz`. The heatmap is a PNG written by the
port's codec (viridis colours, red boundaries; no matplotlib). Runs on the
card by default; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# viridis at 0, 1/4, 1/2, 3/4 and 1 (matplotlib's table), interpolated
_VIRIDIS = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140],
                     [94, 201, 98], [253, 231, 37]], np.float64)


def cosine_heatmap(feats: np.ndarray, pids: np.ndarray, out_path: str,
                   cell: int = 4):
    """Pairwise cosine similarity of the features sorted by identity, in
    [-1, 1] on a viridis scale, each pair `cell` x `cell` pixels, with red
    lines between identities (get_embeds.py:165-220)."""
    from ..utils.png import write_png
    order = np.argsort(pids, kind="stable")
    f = feats[order]
    p = pids[order]
    f = f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)
    sim = np.clip(f @ f.T, -1.0, 1.0)
    t = (sim + 1.0) / 2.0 * (len(_VIRIDIS) - 1)
    lo = np.minimum(np.floor(t).astype(int), len(_VIRIDIS) - 2)
    frac = (t - lo)[..., None]
    img = _VIRIDIS[lo] * (1 - frac) + _VIRIDIS[lo + 1] * frac
    img = np.repeat(np.repeat(img, cell, axis=0), cell, axis=1)
    for b in np.nonzero(np.diff(p))[0] + 1:
        img[b * cell, :] = (255, 0, 0)
        img[:, b * cell] = (255, 0, 0)
    write_png(out_path, np.round(img).astype(np.uint8))


def load_checkpoint(model, path: str) -> None:
    """A `step_N.pt`, a directory of them (the latest), or a flat npz."""
    import torch
    from ..models.dator.train import load_params_npz
    if path.endswith(".npz"):
        model.load_state_dict(load_params_npz(model, path, strict=False))
        return
    if os.path.isdir(path):
        steps = [int(f[5:-3]) for f in os.listdir(path)
                 if f.startswith("step_") and f.endswith(".pt")
                 and f[5:-3].isdigit()]
        if not steps:
            raise SystemExit(f"no step_N.pt checkpoints under {path}")
        path = os.path.join(path, f"step_{max(steps)}.pt")
    ckpt = torch.load(path, map_location=next(model.parameters()).device,
                      weights_only=True)
    model.load_state_dict(ckpt["model"])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="step_N.pt, a directory of them, or a .npz")
    parser.add_argument("--heatmap", type=str, default=None,
                        help="write the cosine heatmap png here")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("opts", nargs="*")
    args = parser.parse_args(argv)

    from .. import resolve_device
    from ..config import load_config
    from ..models.dator.data import PKSampler, scan_instance_dirs
    from ..models.dator.train import create_train_state
    from .dator_train import embed_samples, model_config, rank_scores

    device = resolve_device(args.device)
    cfg = load_config(args.config, args.opts)
    samples = scan_instance_dirs(cfg.data.root)
    num_classes = len({s.pid for s in samples})
    state = create_train_state(model_config(cfg, num_classes), cfg.train,
                               device=device)
    model = state.model
    if args.checkpoint:
        load_checkpoint(model, os.path.abspath(args.checkpoint))

    sampler = PKSampler(samples, cfg.data.batch_size, cfg.data.num_instances)
    feats, pids = embed_samples(model, sampler, len(samples), cfg)
    cmc, mAP = rank_scores(feats, pids, cfg)
    print(f"Rank-1: {cmc[0]:.4f}  Rank-5: {cmc[min(4, len(cmc) - 1)]:.4f}  "
          f"Rank-10: {cmc[min(9, len(cmc) - 1)]:.4f}  mAP: {mAP:.4f}")

    if args.heatmap:
        cosine_heatmap(feats, pids, args.heatmap)
        print(f"heatmap -> {args.heatmap}")
    return cmc, mAP


if __name__ == "__main__":
    main()
