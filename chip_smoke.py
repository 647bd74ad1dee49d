#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (instance_based_loc_tpu_torch).

Drives the port's main path on one CUDA card, in phases that each print a
progress line and raise on failure:

  1. build    nvcc builds the attention kernel into the package's _build/.
  2. kernel   the kernel against its plain PyTorch version on the card: at the
              DINOv2-base embedder's shape (16, 12, 257, 64) in bf16 (the
              tensor-core path), also with valid_len < S, and at a small
              shape in fp32 (the CUDA-core path); times the
              kernel, the plain version and torch's scaled_dot_product_attention
              (a yardstick only; the port never calls it).
  3. color    bench.py's e2e scene (9 objects, 640x480, focal 525): build an
              object memory from views 0-5 with the `color` embedder,
              downsample, recluster with DBSCAN, localise views 6-8; each view
              must meet the reference's 0.6 m / 0.3 rad success thresholds, as
              the JAX package does on this scene.
  4. dino     the same flow with the full-width DINOv2-base embedder (seeded
              random weights), whose every ViT block runs the attention
              kernel: the kernel's launch count over the run must be 12 per
              embedded crop batch, and every pose finite. Then the trunk on the
              card (bf16, kernel) is held against the same weights in fp32 on
              the CPU (plain attention) on a few crops.

The last lines are the card's name and power limit, a JSON line describing
each kernel, and {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, it exits non-zero before printing any result.

Run from the repository root: python3 chip_smoke.py
"""

import dataclasses
import json
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOP_PER_S = 989e12   # dense bf16 tensor cores, H100 SXM data sheet
SUCCESS_TRANS_M, SUCCESS_ROT_RAD = 0.6, 0.3


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T_START:7.1f}s] {msg}",
          flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def gpu_name_and_power_limit() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from instance_based_loc_tpu_torch.ops import attention, cuda_build
    t0 = time.perf_counter()
    info = cuda_build.build(attention.SOURCE)
    log(f"build: nvcc {info['seconds']:.1f} s -> {info['path']}")
    print(info["log"], flush=True)
    log(f"build done in {time.perf_counter() - t0:.1f} s")


def phase_kernel():
    import torch
    import torch.nn.functional as F
    from instance_based_loc_tpu_torch.ops import attention
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(shape, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for _ in range(3)]

    # |diff| <= atol + rtol |ref|. bf16: both sides round an fp32 result to
    # bf16, so they may differ by one bf16 step, 2^-8 to 2^-7 of the value
    # (outputs are about 0.1 in size here); fp32: the same sums reordered.
    bf16_tol, fp32_tol = (1e-4, 2 ** -7), (1e-5, 0.0)
    errs = {}
    for shape, dtype, valid, (atol, rtol) in [
            ((16, 12, 257, 64), torch.bfloat16, None, bf16_tol),
            ((16, 12, 257, 64), torch.bfloat16, 200, bf16_tol),
            ((2, 3, 70, 32), torch.float32, None, fp32_tol),
            ((2, 3, 70, 32), torch.float32, 33, fp32_tol)]:
        q, k, v = qkv(shape, dtype)
        out = attention.vit_attention(q, k, v, valid_len=valid)
        torch.cuda.synchronize()
        ref = attention.vit_attention_reference(q, k, v, valid_len=valid)
        rows = shape[2] if valid is None else valid   # padded query rows are
        out = out.float()[:, :, :rows]                 # the caller's to drop
        ref = ref.float()[:, :, :rows]
        diff = (out - ref).abs()
        err = diff.max().item()
        excess = (diff - atol - rtol * ref.abs()).max().item()
        log(f"kernel {shape} {str(dtype)[6:]} valid_len={valid}: "
            f"max|diff| {err:.3g}, max|ref| {ref.abs().max().item():.3g} "
            f"(tolerance {atol} + {rtol:.3g} |ref|)")
        check(excess <= 0, f"kernel disagrees at {shape} {dtype} "
                           f"valid_len={valid}: max|diff| {err}, "
                           f"{excess} past the tolerance")
        errs[(dtype, valid)] = err

    b, h, s, d = 16, 12, 257, 64
    q, k, v = qkv((b, h, s, d), torch.bfloat16)
    kernel_ms = time_ms(lambda: attention.vit_attention(q, k, v))
    plain_ms = time_ms(lambda: attention.vit_attention_reference(q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    bytes_moved = 4 * b * h * s * d * q.element_size()
    flops = 4 * b * h * s * s * d
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"kernel timing at ({b}, {h}, {s}, {d}) bf16: kernel {kernel_ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.2f} us ({bytes_moved / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP)")
    log(f"kernel phase done in {time.perf_counter() - t0:.1f} s")
    return {"name": "vit_attention", "route": "cuda",
            "source": "instance_based_loc_tpu_torch/csrc/vit_attention.cu",
            "replaces": "instance_based_loc_tpu/ops/pallas/attention.py:31",
            "launches": None,
            "max_abs_err": errs[(torch.bfloat16, None)],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def bench_scene():
    from instance_based_loc_tpu_torch.data.synthetic import (
        default_scene, render_scene, ring_poses)
    focal, h, w = 525.0, 480, 640
    scene = default_scene(num_objects=9, seed=3)
    poses = ring_poses(9, radius=4.5, height=1.3, target=(0, 0.4, 0))
    frames = [render_scene(scene, p, h, w, focal) for p in poses]
    return scene, poses, frames, focal


def build_and_localise(name, embedder, scene, poses, frames, focal,
                       workdir=None):
    """Build from views 0-5, consolidate, localise views 6-8; returns the
    per-view (trans_err, rot_err, pose) and the memory."""
    import numpy as np
    import torch
    from instance_based_loc_tpu_torch.memory import (
        ColorRegionDetector, ObjectMemory)
    from instance_based_loc_tpu_torch.ops.transforms import quaternion_error

    detector = ColorRegionDetector(min_area=500,
                                   floor_colors=[scene.floor_color])
    memory = ObjectMemory(detector=detector, camera_focal_lenth_x=focal,
                          camera_focal_lenth_y=focal,
                          get_embeddings_func=embedder, log_enabled=False,
                          device="cuda")
    t0 = time.perf_counter()
    for i in range(6):
        rgb, depth, _ = frames[i]
        memory.process_image(rgb, depth, poses[i], consider_floor=True,
                             min_points=200, outlier_removal_config=None)
    memory.downsample_all_objects(voxel_size=0.02)
    memory.recluster_objects_with_dbscan(eps=0.1, min_points_per_cluster=40)
    torch.cuda.synchronize()
    log(f"{name}: memory of {len(memory.memory)} objects built in "
        f"{time.perf_counter() - t0:.2f} s")
    check(len(memory.memory) > 0, f"{name}: empty memory")
    if workdir is not None:
        path = f"{workdir}/{name}_memory.pkl"
        memory.save_to_pkl(path)
        fresh = ObjectMemory(detector=detector, camera_focal_lenth_x=focal,
                             camera_focal_lenth_y=focal,
                             get_embeddings_func=embedder, log_enabled=False,
                             device="cuda")
        fresh.load(path)
        check(len(fresh.memory) == len(memory.memory)
              and all(np.array_equal(a.pts, b.pts)
                      for a, b in zip(fresh.memory, memory.memory)),
              f"{name}: pkl round trip changed the memory")
    results = []
    for i in (6, 7, 8):
        rgb, depth, _ = frames[i]
        t1 = time.perf_counter()
        est, (assn, _) = memory.localise(rgb, depth,
                                         outlier_removal_config=None)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        te = float(np.linalg.norm(est[:3] - poses[i][:3]))
        re_ = float(quaternion_error(
            torch.as_tensor(poses[i][3:], dtype=torch.float64),
            torch.as_tensor(est[3:], dtype=torch.float64)))
        log(f"{name}: view {i} localised in {dt * 1e3:.1f} ms: trans_err "
            f"{te:.4f} m, rot_err {re_:.4f} rad, assn {assn}")
        results.append((te, re_, est))
    return results, memory


def phase_color(scene_data, workdir):
    from instance_based_loc_tpu_torch.models.embedders import get_embedder
    t0 = time.perf_counter()
    results, _ = build_and_localise("color", get_embedder("color"),
                                    *scene_data, workdir=workdir)
    for view, (te, re_, _) in zip((6, 7, 8), results):
        check(te < SUCCESS_TRANS_M and re_ < SUCCESS_ROT_RAD,
              f"color: view {view} misses the success thresholds "
              f"({te:.3f} m, {re_:.3f} rad)")
    log(f"color phase done in {time.perf_counter() - t0:.1f} s")


def phase_dino(scene_data):
    import numpy as np
    import torch
    from instance_based_loc_tpu_torch.ops import attention
    from instance_based_loc_tpu_torch.models.embedders import get_embedder
    t0 = time.perf_counter()
    embed = get_embedder("dino", device="cuda")
    cfg = embed.model.cfg
    check((cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.mlp_dim,
           cfg.patch_size, cfg.image_size) == (768, 12, 12, 3072, 14, 224),
          f"dino embedder is not DINOv2-base: {cfg}")
    log(f"dino: DINOv2-base embedder built in {time.perf_counter() - t0:.1f} s")

    # the main path: every count from zero just before, read just after
    attention.launches = 0
    embed.batches = 0
    results, _ = build_and_localise("dino", embed, *scene_data)
    launches, batches = attention.launches, embed.batches
    log(f"dino: attention kernel launches {launches} over {batches} crop "
        f"batches of {cfg.num_layers} blocks")
    check(batches > 0 and launches == cfg.num_layers * batches,
          f"dino: {launches} kernel launches for {batches} batches")
    for view, (_, _, est) in zip((6, 7, 8), results):
        check(est.shape == (7,) and bool(np.all(np.isfinite(est))),
              f"dino: view {view} pose not finite: {est}")

    # the trunk on the card (bf16, kernel) against the same weights in fp32
    # on the CPU (plain attention), on crops of the scene
    from instance_based_loc_tpu_torch.memory import ColorRegionDetector
    from instance_based_loc_tpu_torch.models.vit import ViT
    from instance_based_loc_tpu_torch.models.vit_embedder import (
        preprocess_crop)
    frames = scene_data[2]
    det = ColorRegionDetector(min_area=500).find(frames[6][0], False)
    crops = det.crops[:4]
    batch = torch.stack([preprocess_crop(c, "dino", 224, "cuda")
                         for c in crops])
    with torch.no_grad():
        card, _ = embed.model(batch)
        cpu_model = ViT(dataclasses.replace(cfg, dtype=torch.float32))
        cpu_model.load_state_dict({k: v.float().cpu() for k, v in
                                   embed.model.state_dict().items()})
        ref, _ = cpu_model(batch.cpu())
    # the cls embedding is post-LayerNorm (unit scale): entries ~ N(0, 1);
    # bf16 matmuls across 12 blocks leave |diff| ~ 1e-2
    cos = torch.nn.functional.cosine_similarity(card.cpu(), ref, dim=-1)
    diff = (card.cpu() - ref).abs().max().item()
    log(f"dino: trunk on the card (bf16) vs fp32 on the CPU, {len(crops)} "
        f"crops: cosine similarity min {cos.min().item():.6f}, max|diff| "
        f"{diff:.4f} (tolerances 0.999, 0.1)")
    check(bool(torch.all(cos > 0.999)) and diff < 0.1,
          f"dino: trunk disagrees with its fp32 CPU run: cosine "
          f"{cos.tolist()}, max|diff| {diff}")
    log(f"dino phase done in {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # the package must sit beside this script
    import instance_based_loc_tpu_torch  # noqa: F401

    card = gpu_name_and_power_limit()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    kernel = phase_kernel()
    scene_data = bench_scene()
    with tempfile.TemporaryDirectory() as workdir:
        phase_color(scene_data, workdir)
    kernel["launches"] = phase_dino(scene_data)
    log(f"all phases passed in {time.perf_counter() - T_START:.1f} s")

    print(card, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
