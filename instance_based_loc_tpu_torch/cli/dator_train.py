"""DATOR training entry point (counterpart of
`instance_based_loc_tpu/cli/dator_train.py`; reference `dator/train.py` +
`processor/processor_depth.py:do_train_4DNet`).

    python -m instance_based_loc_tpu_torch.cli.dator_train \\
        data.root=/path/to/reid/train data.val_root=/path/to/reid/val \\
        train.epochs=240

The JAX CLI's flags and config keys, plus `--device` (default cuda; it
raises without a card unless given `--device cpu`). One card runs both
towers: `n_model_shards` above 1 raises. Every `eval.period` epochs the
reference's three ablations run, zero-RGB, zero-depth and both, each
reporting CMC Rank-1/5/10 and mAP on the val split (and the train split
with `eval.train_split`); the best val rank-1 writes `best_params.npz`.
Every `eval.checkpoint_period` epochs, at the kill-gate and at the end,
`step_EPOCH.pt` (model, optimiser, update count) and `params_latest.npz`
(the flat npz the port's and the JAX package's `--embeddings dator` read)
go to `output_dir`. `IBL_DATOR_F32` forces fp32 compute.

With `data.device_dataset` on (by default while the quantised dataset is
under 512 MB) the whole dataset lives on the device as u8 / u16-valued
tensors and each step gathers its batch there by index. Each step's
random draws (modality dropout, augmentation) come from a generator
seeded by (epoch, batch).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def embed_samples(model, sampler, n: int, cfg, ablation: str = "both"):
    """Embeddings (n, r) and pids (n,) of the sampler's first n samples in
    batches of cfg.data.batch_size, with a modality ablation: "zero_rgb",
    "zero_depth" or "both" (processor_depth.py:132-250)."""
    import torch
    dev = next(model.parameters()).device
    feats, pids = [], []
    bs = cfg.data.batch_size
    with torch.no_grad():
        for start in range(0, n, bs):
            rgb, depth, pid = sampler.load_batch(
                list(range(start, min(start + bs, n))), cfg.data.height,
                cfg.data.width)
            if ablation == "zero_rgb":
                rgb = np.zeros_like(rgb)
            elif ablation == "zero_depth":
                depth = np.zeros_like(depth)
            _, feat = model(torch.from_numpy(rgb).to(dev),
                            torch.from_numpy(depth).to(dev))
            feats.append(feat.float().cpu().numpy())
            pids.append(pid)
    return np.concatenate(feats), np.concatenate(pids)


def rank_scores(feats, pids, cfg):
    """(CMC curve, mAP) with each identity's first sample as its query and
    the rest as the gallery, or None without a gallery."""
    from ..models.dator.metrics import (cmc_map, cosine_distmat,
                                        k_reciprocal_rerank)
    q_idx, g_idx, seen = [], [], set()
    for i, p in enumerate(pids):
        (q_idx if p not in seen else g_idx).append(i)
        seen.add(int(p))
    if not g_idx:
        return None
    if cfg.eval.re_ranking:
        dist = k_reciprocal_rerank(feats[q_idx], feats[g_idx])
    else:
        dist = cosine_distmat(feats[q_idx], feats[g_idx])
    return cmc_map(dist, pids[q_idx], pids[g_idx],
                   max_rank=min(cfg.eval.max_rank, len(g_idx)))


def evaluate(model, sampler, samples, cfg, ablation: str = "both") -> dict:
    """Rank-1/5/10 and mAP of `samples` with a modality ablation."""
    scores = rank_scores(*embed_samples(model, sampler, len(samples), cfg,
                                        ablation), cfg)
    if scores is None:
        return {}
    cmc, mAP = scores
    return {"rank1": float(cmc[0]),
            "rank5": float(cmc[min(4, len(cmc) - 1)]),
            "rank10": float(cmc[min(9, len(cmc) - 1)]),
            "mAP": mAP}


def model_config(cfg, num_classes: int):
    """cfg.model with the dataset's class count; IBL_DATOR_F32 forces fp32
    compute (dotted overrides cannot express a dtype)."""
    import torch
    model_cfg = dataclasses.replace(cfg.model, num_classes=num_classes)
    if os.environ.get("IBL_DATOR_F32"):
        model_cfg = dataclasses.replace(
            model_cfg, dtype=torch.float32,
            backbone=dataclasses.replace(model_cfg.backbone,
                                         dtype=torch.float32))
        print("IBL_DATOR_F32: compute dtype forced to float32")
    return model_cfg


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None,
                        help="YAML config (needs the yaml package)")
    parser.add_argument("--pretrained", type=str, default=None,
                        help="HF ViTModel .bin/.pth to init both towers")
    parser.add_argument("--resume", type=int, default=None, metavar="EPOCH",
                        help="restore model, optimiser and update count "
                             "from output_dir/step_EPOCH.pt and continue")
    parser.add_argument("--init-npz", type=str, default=None,
                        help="warm-start params from a flat .npz (either "
                             "package's save_params_npz); fresh optimiser")
    parser.add_argument("--resume-epoch", type=int, default=0,
                        help="with --init-npz: the epoch to continue from "
                             "(shifts the cosine schedule)")
    parser.add_argument("--init-npz-filter", type=str, default=None,
                        help="comma-separated substrings; with --init-npz "
                             "load only params whose key contains one")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "CPU path)")
    parser.add_argument("opts", nargs="*", help="dotted overrides a.b=c")
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)

    import torch
    from .. import resolve_device
    from ..config import device_dataset_on, load_config
    from ..models.dator.data import PKSampler, scan_instance_dirs
    from ..models.dator.train import (create_train_state, load_params_npz,
                                      make_step_draws, restore_checkpoint,
                                      save_checkpoint, save_params_npz,
                                      train_step)

    device = resolve_device(args.device)
    cfg = load_config(args.config, args.opts)
    if cfg.n_model_shards != 1:
        raise ValueError(f"n_model_shards={cfg.n_model_shards}: the port "
                         f"trains on one card (both towers on it)")
    os.makedirs(cfg.output_dir, exist_ok=True)

    samples = scan_instance_dirs(cfg.data.root)
    num_classes = len({s.pid for s in samples})
    print(f"ReID dataset: {len(samples)} samples / {num_classes} identities")
    model_cfg = model_config(cfg, num_classes)
    sampler = PKSampler(samples, cfg.data.batch_size, cfg.data.num_instances,
                        seed=cfg.data.seed)

    # steps per epoch follow the data (PKSampler drops ragged P x K
    # remainders): the cosine horizon and any warm-start offset use them
    actual_spe = len(sampler.epoch_batches(0))
    if actual_spe != cfg.train.steps_per_epoch:
        print(f"steps_per_epoch: config {cfg.train.steps_per_epoch} -> "
              f"actual {actual_spe} (cosine horizon follows the data)")
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, steps_per_epoch=actual_spe))
    if args.init_npz and args.resume_epoch:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, schedule_offset_steps=args.resume_epoch
            * cfg.train.steps_per_epoch))

    eval_sets = [("train", sampler, samples)]
    if cfg.data.val_root:
        val_samples = scan_instance_dirs(cfg.data.val_root)
        val_sampler = PKSampler(val_samples, cfg.data.batch_size,
                                cfg.data.num_instances, seed=cfg.data.seed)
        print(f"val split: {len(val_samples)} samples / "
              f"{len({s.pid for s in val_samples})} identities")
        eval_sets = [("val", val_sampler, val_samples)]
        if cfg.eval.train_split:
            eval_sets.append(("train", sampler, samples))

    state = create_train_state(model_cfg, cfg.train, seed=0,
                               pretrained_path=args.pretrained, device=device)
    model = state.model
    start_epoch = 0
    if args.resume is not None:
        restore_checkpoint(state, cfg.output_dir, args.resume)
        start_epoch = args.resume
        print(f"resumed from {cfg.output_dir}/step_{args.resume}.pt "
              f"(step={state.step})")
    elif args.init_npz:
        filt = (args.init_npz_filter.split(",")
                if args.init_npz_filter else None)
        model.load_state_dict(load_params_npz(model, args.init_npz,
                                              strict=False, key_filter=filt))
        start_epoch = args.resume_epoch
        print(f"warm-started params from {args.init_npz}; continuing at "
              f"epoch {start_epoch} (schedule offset "
              f"{cfg.train.schedule_offset_steps} steps, fresh optimizer)")

    ds_mb = len(samples) * cfg.data.height * cfg.data.width * 5 / 2 ** 20
    use_device_ds = device_dataset_on(cfg.data.device_dataset, ds_mb,
                                      cfg.data.device_dataset_max_mb)
    if use_device_ds:
        print(f"device-resident dataset: {ds_mb:.1f} MB quantized")
        ds_rgb, ds_depth, ds_pids = sampler.load_all(cfg.data.height,
                                                     cfg.data.width)
        ds_rgb = torch.from_numpy(ds_rgb).to(device)
        # u16 depth values held as int32 (torch's uint16 lacks CUDA ops)
        ds_depth = torch.from_numpy(ds_depth.astype(np.int32)).to(device)
        ds_pids = torch.from_numpy(ds_pids).to(device)

    def batch_tensors(batch_idxs):
        if use_device_ds:
            idx = torch.as_tensor(batch_idxs, device=device)
            return ds_rgb[idx], ds_depth[idx], ds_pids[idx]
        rgb, depth, pids = sampler.load_batch(
            batch_idxs, cfg.data.height, cfg.data.width,
            quantize=cfg.data.quantize_upload)
        if depth.dtype == np.uint16:
            depth = depth.astype(np.int32)
        return (torch.from_numpy(rgb).to(device),
                torch.from_numpy(depth).to(device),
                torch.from_numpy(pids).to(device))

    def checkpoint(epoch):
        save_checkpoint(state, cfg.output_dir, epoch)
        save_params_npz(model, os.path.join(cfg.output_dir,
                                            "params_latest.npz"))

    best_rank1 = -1.0
    for epoch in range(start_epoch, cfg.train.epochs):
        t0 = time.time()
        batches = sampler.epoch_batches(epoch)
        step_metrics = []
        for bi, batch_idxs in enumerate(batches):
            gen = torch.Generator(device=device).manual_seed(
                epoch * 10000 + bi)
            draws = make_step_draws(gen, len(batch_idxs),
                                    model_cfg.modality_dropout,
                                    cfg.train.augment)
            rgb, depth, pids = batch_tensors(batch_idxs)
            step_metrics.append(train_step(state, rgb, depth, pids, draws))
        # one read of the epoch's metrics: the steps ran without host syncs
        read = [{k: float(v) for k, v in m.items()} for m in step_metrics]
        dt = time.time() - t0
        sps = len(batches) * cfg.data.batch_size / max(dt, 1e-9)
        losses = [m["loss"] for m in read]
        mean_id = (float(np.mean([m["id_loss"] for m in read]))
                   if read else float("nan"))
        aux = " ".join(f"{k}={v:.3f}" for k, v in sorted(read[-1].items())
                       if k != "loss") if read else ""
        print(f"epoch {epoch}: loss={np.mean(losses):.4f} "
              f"epoch_id_loss={mean_id:.4f} "
              f"({dt:.1f}s, {sps:.1f} samples/s) {aux}", flush=True)

        # kill-gate: a flat id_loss at gate_epoch means the fusion
        # embedding is dead; the rest of the schedule would be wasted
        if (cfg.train.gate_epoch and epoch + 1 == cfg.train.gate_epoch
                and mean_id > cfg.train.gate_id_loss):
            save_checkpoint(state, cfg.output_dir, epoch + 1)
            print(f"KILL-GATE: epoch_id_loss={mean_id:.4f} > "
                  f"{cfg.train.gate_id_loss} at epoch {epoch + 1} "
                  f"(uniform floor ln(C)={np.log(num_classes):.3f}). "
                  f"The fusion head is not learning: aborting the "
                  f"schedule; checkpoint saved for diagnosis.")
            sys.exit(3)

        if (epoch + 1) % cfg.eval.period == 0:
            for split, e_sampler, e_samples in eval_sets:
                for ablation in ("zero_rgb", "zero_depth", "both"):
                    m = evaluate(model, e_sampler, e_samples, cfg, ablation)
                    print(f"  eval[{split}/{ablation}]: " + " ".join(
                        f"{k}={v:.4f}" for k, v in m.items()), flush=True)
                    if (split == "val" and ablation == "both"
                            and m.get("rank1", -1) > best_rank1):
                        best_rank1 = m["rank1"]
                        path = os.path.join(cfg.output_dir,
                                            "best_params.npz")
                        save_params_npz(model, path)
                        print(f"  best val rank1={best_rank1:.4f} -> "
                              f"{path} (epoch {epoch + 1})")
        if (epoch + 1) % cfg.eval.checkpoint_period == 0:
            checkpoint(epoch + 1)
            print(f"  checkpoint @ epoch {epoch + 1}")
    checkpoint(cfg.train.epochs)
    return state


if __name__ == "__main__":
    main()
