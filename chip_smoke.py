#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (instance_based_loc_tpu_torch).

Drives the port's main path on one CUDA card, in phases that each print a
progress line and raise on failure:

  1. build    nvcc builds the three kernels into the package's _build/, in
              parallel, and logs each kernel's registers and spills
              (ptxas) and the attention kernels' shared memory.
  2. kernel   the ViT attention kernel against its plain PyTorch version on
              the card: at the DINOv2-base embedder's shape (16, 12, 257, 64)
              in bf16 (the TMA + wgmma path), also with valid_len < S, and
              at a small shape in fp32 (the CUDA-core path); times the
              kernel and torch's scaled_dot_product_attention (a yardstick
              only; the port never calls it) on the device with
              torch.profiler (the kernel is shorter than its wrapper's
              launch), beside CUDA events per call and the plain version.
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
  5. sam_kernel   SAM's global-block attention kernel against its plain
              version at SAM-H (1, 16, 4096, 80), SAM-B (1, 12, 4096, 64) and
              48x64 and 48x48 grids, bf16; times the kernel, the plain
              version and scaled_dot_product_attention with the bias as a
              mask (a yardstick only; the port never calls it), with CUDA
              events and on the device (torch.profiler), at SAM-H, SAM-B
              and 48x48, whose key-grid rows are not 64 keys (the kernel's
              general bias path).
  6. msda_kernel  the MSDA level-gather kernel against its plain version at
              GroundingDINO@800's level 0 (S = 100 x 100, H = 8, D = 32, bf16
              values) with encoder (Q = 13294) and decoder (Q = 900) queries,
              taps from sampling points that spill outside the map; its
              device time comes from torch.profiler (the kernel is shorter
              than its wrapper's launch).
  7. cascade  the full-width RAM (Swin-L/384, 4585 tags from a tag list
              the phase writes: tag0 ... tag4584) -> GroundingDINO (Swin-B,
              BERT-base, 900 queries, 6 + 6 layers, 800 px) -> SAM-H (1024
              px) cascade with seeded random weights in bf16 builds an object
              memory of tests/test_neural_e2e.py's scene (views 0 and 2, floor
              on) and localises view 1; RAM must tag every frame, every SAM
              image encode must launch the attention kernel once per global
              block and every GroundingDINO forward the gather kernel once per
              level and deformable layer. Random weights can tag thousands of
              the 4585 tags, and GroundingDINO takes at most 256 text tokens,
              so the cascade grounds the first RAM_MAX_KEYWORDS tags of each
              frame (vocabulary order): RAM still runs on every frame. Logs
              the tags per frame and RAM's ms per frame.
  8. cascade_vs_cpu  one frame through GroundingDINO (1 + 1 layers), SAM
              (SAM-H width, 4 blocks, one global) and RAM (Swin-L widths, 1
              block per stage, 2 decoder layers, 4585 tags) on the card in
              bf16 with the kernels, and in fp32 on the CPU with the plain
              versions, same weights: embedding cosine, mask logits,
              GroundingDINO logits and boxes, RAM's tag probabilities within
              the thresholds written below.
  9. cli      the port's trial CLIs on the card, on datasets that the port's
              writers write (PNG through the port's codec):
              (a) synth_localisation_trial with its defaults (6 objects, 8
                  views at 240x320, focal 300, the last view held out):
                  every eval view within 0.6 m / 0.3 rad;
              (b) localisation_trial on a TUM-layout dataset of the bench
                  scene (9 views at 480x640, focal 525, 16-bit depth /5000)
                  with the full-width DINOv2-base embedder, the map build
                  (full-frame radius outliers, device voxel grid), ply
                  dumps and the memory pkl: 12 ViT kernel launches per crop
                  batch, finite poses, the pkl and ply files read back, a
                  non-empty map;
              (c) localisation_trial with phase 7's random-weight cascade on
                  phase 7's scene (views 0-2, -e 1, --detect-batch 2) and
                  the CLI's reclustering: 4 SAM kernel launches per encode,
                  48 gather launches per GroundingDINO forward, a finite
                  pose, and the IoU matrix of the reclustering's staged
                  clouds on the card against the CPU (gates below).
              Each part logs its wall time and the memory's stage timer;
              (b) also times the PNG decode of 640x480 frames and the map
              build's outlier and voxel steps, (c) the IoU matrix.
 10. serve    bench.py's serving stream on phase 3's memory (the `color`
              embedder): views 6-8 x 24, 72 queries, no outlier removal,
              through ObjectMemory.localise_many at batch 1, 6 and 12 as
              CUDA-graph replays of the query program, and at 6 and 12
              eagerly (eager batch 1 is cut for time). Every
              row must give its frame the assignment `localise` gives it
              and a pose within 1e-5 (bitwise or not is logged), each graph
              run must equal the eager run of its batch bit for bit, and
              each view must be localised within 0.6 m / 0.3 rad on as many
              of its 24 streams as the JAX package is, within stream luck
              (SERVE_MIN_WINS below). Logs frames/s of the five
              runs, the host's launch calls and the device's kernels per
              query, and device busy ms and idle share over one chunk,
              eager (torch.profiler, batch 1) and graph (the replay timed
              with CUDA events; batch 1, 6 and 12).
 11. dator    the DATOR (FourDNet) embedder at full width with seeded random
              weights in bf16: two ViT-B/16 towers at 256x128, 11 blocks
              each, reduced_dim 128, BNNeck. Embeds the bench scene's crops;
              the towers share one ViT attention launch per block, so the
              kernel must launch 11 times per 16-crop batch. The kernel at
              the towers' shape (32, 12, 129, 64) bf16 (S = 129: one key
              past two 64-key TMA tiles) against its plain version, timed
              beside SDPA; the model on the card (bf16, kernel) against the
              same weights in fp32 on the CPU (plain attention); then the
              trial CLI with `--embeddings dator --serve-batch 6` on phase
              9 (b)'s TUM dataset: finite poses and 11 launches per crop
              batch.
 12. clip_loc the port's clip_loc_trial CLI on phase 9 (b)'s TUM dataset of
              the bench scene (memory from views 0-5 with the depth detector,
              DBSCAN reclustering, views 6-8 localised from RGB alone):
              (a) weights-free (`--embeddings color --detector depth
                  --no-outlier-removal`): every view within the JAX CLI
                  test's 1.5 m (tests/test_clip_loc.py), the clip_loc pkl
                  reads back;
              (b) `--embeddings clip` (full-width CLIP ViT-B/32, random
                  weights, bf16) with a random full-width CLIP text tower
                  saved in the HF layout as `--clip-text-checkpoint`: 12 ViT
                  kernel launches per crop batch, finite poses;
              each logs ms per `localize` and the RANSAC samples per call;
              (c) the ViT kernel at CLIP-B/32's shape (16, 12, 50, 64) bf16
                  (S = 50, less than one 64-key TMA tile) against its plain
                  version with phase 2's tolerance, timed beside SDPA.

The last lines are the card's name and power limit, a JSON line describing
each kernel, and {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, it exits non-zero before printing any result.

Run from the repository root: python3 chip_smoke.py
"""

import contextlib
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


def device_ms(fn, kernel: str | None = None, iters: int = 50,
              windows: int = 5) -> float:
    """Mean device time per call of fn() from torch.profiler: of the kernel
    named `kernel` (one launch per call), or of every kernel the call
    launches (kernel=None, e.g. a library call that launches several). Each
    kernel's mean duration times its launches per call (its count over the
    calls, rounded), so the few launches the profiler drops in most windows
    (1-13 of 50 on an H100) do not bias the figure. For a kernel shorter
    than its Python wrapper's launch, back-to-back CUDA events time the
    host instead.

    Now and then the profiler drops most launches (it once kept 5 of 20):
    a window that kept a kernel fewer times than half the calls is
    profiled again, up to `windows` times. If every window lost that many,
    a named kernel's time is the mean duration of the launches the
    profiler kept (one launch per call), and a library call's comes from
    CUDA events; the log says which. A named kernel seen more than once
    per call, or never, fails the check."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = collections.defaultdict(list)
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and (kernel is None or kernel in e.name)):
                by_name[e.name].append(e.time_range.elapsed_us())
        seen = {name: len(t) for name, t in by_name.items()}
        if kernel is not None:
            check(sum(seen.values()) <= iters,
                  f"{kernel} launched more than once per call: the profiler "
                  f"saw {seen} for {iters} calls")
        if seen and all(round(n / iters) >= 1 for n in seen.values()):
            break
        log(f"device_ms: the profiler saw kernels {seen} for {iters} calls; "
            f"profiling again")
    else:
        if kernel is None:
            ms = time_ms(fn, iters=iters)
            log(f"device_ms: the profiler lost most launches in all "
                f"{windows} windows; {ms:.4f} ms per call from CUDA events "
                f"instead")
            return ms
        check(bool(seen), f"the profiler never saw {kernel} in {windows} "
                          f"windows of {iters} calls")
        times = [t for ts in by_name.values() for t in ts]
        log(f"device_ms: the profiler lost most launches of {kernel} in all "
            f"{windows} windows; the mean of the {len(times)} it kept in the "
            f"last")
        return sum(times) / len(times) / 1e3
    per_call = {name: round(len(t) / iters) for name, t in by_name.items()}
    return sum(sum(t) / len(t) * per_call[name]
               for name, t in by_name.items()) / 1e3


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel of an `nvcc -Xptxas -v` log: registers, spills,
    and the stack frame."""
    lines, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spills = line.split("'")[1], ""
        elif "spill stores" in line and name is not None:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name is not None:
            regs = line.split("Used", 1)[1].strip()
            lines.append(f"{name}: {regs}; {spills}")
            name = None
    return lines


def phase_build():
    """nvcc for every kernel source, all started together; logs each
    kernel's registers and spills (ptxas) and shared memory."""
    from concurrent.futures import ThreadPoolExecutor
    from instance_based_loc_tpu_torch.ops import (
        attention, cuda_build, msda_gather, sam_attention)
    t0 = time.perf_counter()
    sources = [attention.SOURCE, sam_attention.SOURCE, msda_gather.SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:
        infos = list(pool.map(cuda_build.build, sources))
    for source, info in zip(sources, infos):
        log(f"build: {source}: nvcc {info['seconds']:.1f} s -> "
            f"{info['path']}")
        for line in ptxas_summary(info["log"]):
            log(f"build: ptxas {line}")
        print(info["log"], flush=True)
    log(f"build done in {time.perf_counter() - t0:.1f} s; dynamic shared "
        f"memory per block: vit_attention at (S = 257, bf16) "
        f"{attention._smem_bytes(64, 257, 2)} B, sam_attention at SAM-H "
        f"{sam_attention._smem_bytes(80, 64, 64)} B, at a 48x48 grid "
        f"{sam_attention._smem_bytes(80, 48, 48)} B")


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
    call_ms = time_ms(lambda: attention.vit_attention(q, k, v))
    plain_ms = time_ms(lambda: attention.vit_attention_reference(q, k, v))
    sdpa_call_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    # the kernel is shorter than its wrapper's launch: its time, and SDPA's,
    # are device times from the profiler
    kernel_ms = device_ms(lambda: attention.vit_attention(q, k, v),
                          "vit_attention")
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    bytes_moved = 4 * b * h * s * d * q.element_size()
    flops = 4 * b * h * s * s * d
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"kernel timing at ({b}, {h}, {s}, {d}) bf16: kernel {kernel_ms:.4f} "
        f"ms on the device ({call_ms:.4f} ms per back-to-back call), plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms on the device "
        f"({sdpa_call_ms:.4f} ms per call), bound {bound_ms * 1e3:.2f} us "
        f"({bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
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
    results, memory = build_and_localise("color", get_embedder("color"),
                                         *scene_data, workdir=workdir)
    for view, (te, re_, _) in zip((6, 7, 8), results):
        check(te < SUCCESS_TRANS_M and re_ < SUCCESS_ROT_RAD,
              f"color: view {view} misses the success thresholds "
              f"({te:.3f} m, {re_:.3f} rad)")
    log(f"color phase done in {time.perf_counter() - t0:.1f} s")
    return memory


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


# SAM attention: |diff| <= 2e-3 + 2^-7 |ref|, the TPU kernel's own figure
# against fp32 attention plus one bf16 step of the output
SAM_TOL = (2e-3, 2 ** -7)
MSDA_TOL = 1e-5          # 16 fp32 products of the same values, reordered
H100_FP32_FLOP_PER_S = 67e12   # CUDA cores, H100 SXM data sheet
# phase 8 gates, bf16 on the card against fp32 on the CPU (set before the
# first run on the card): SAM embedding cosine; SAM mask logits and
# GroundingDINO logits as a share of the reference's largest |value|;
# GroundingDINO boxes (normalised cxcywh) absolute; the share of the CPU's
# selected queries the card also selects
SAM_EMB_COS_MIN = 0.99
SAM_LOGIT_REL_MAX = 0.05
GDINO_LOGIT_REL_MAX = 0.05
GDINO_BOX_MAX = 0.02
GDINO_QUERY_OVERLAP_MIN = 0.9
FOCAL_E2E, H_E2E, W_E2E = 200.0, 240, 320     # tests/test_neural_e2e.py
KEYWORDS = ["object", "floor", "ground"]
# RAM: the official tag list's length; phase 7 grounds the first
# RAM_MAX_KEYWORDS tags of a frame; phase 8 holds the tag probabilities of
# the card (bf16) to the CPU (fp32) within RAM_PROB_MAX (absolute; set before
# the first run on the card: random-weight logits are O(1), a bf16 error
# near 1e-2 moves a sigmoid by at most a quarter of that)
RAM_TAGS = 4585
RAM_MAX_KEYWORDS = 3
RAM_PROB_MAX = 0.05


def write_vocab(directory: str) -> str:
    """A synthetic WordPiece vocab with BERT-base-uncased's special ids
    ([PAD] 0, [UNK] 100, [CLS] 101, [SEP] 102, "." 1012, "?" 1029) and the
    cascade's keywords after them (no vocab ships with the repository)."""
    vocab = [f"[unused{i}]" for i in range(1030)]
    for i, tok in ((0, "[PAD]"), (100, "[UNK]"), (101, "[CLS]"),
                   (102, "[SEP]"), (103, "[MASK]"), (1012, "."), (1029, "?")):
        vocab[i] = tok
    path = f"{directory}/vocab.txt"
    with open(path, "w") as f:
        f.write("\n".join(vocab + KEYWORDS) + "\n")
    return path


def write_tag_list(directory: str) -> str:
    """A RAM tag list of RAM_TAGS lines, tag0 ... tag4584 (the official
    ram_tag_list.txt's length)."""
    path = f"{directory}/ram_tag_list.txt"
    with open(path, "w") as f:
        f.write("\n".join(f"tag{i}" for i in range(RAM_TAGS)) + "\n")
    return path


def cap_keywords(cascade, cap: int = RAM_MAX_KEYWORDS) -> list:
    """Makes the cascade ground only the first `cap` tags of each frame (RAM
    still tags every frame); returns the list that records RAM's number of
    tags per frame (0 where the cascade fell back to "object")."""
    counts = []
    inner = cascade.tagger

    def kept(tags):
        counts.append(0 if tags == ["object"] else len(tags))
        return tags[:cap]

    def tagger(img):
        return kept(inner(img))

    tagger.tag_batch = lambda frames: [kept(t)
                                       for t in inner.tag_batch(frames)]
    tagger.ram = inner.ram
    cascade.tagger = tagger
    return counts


def bound(bytes_moved: float, flops: float, flop_rate: float):
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_sam_kernel():
    import torch
    import torch.nn.functional as F
    from instance_based_loc_tpu_torch.ops import sam_attention as sa
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1)

    def inputs(b, h, hk, wk, d):
        s = hk * wk
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        bias_h, bias_w = (
            (0.3 * torch.randn((b, h, s, n), generator=gen, device="cuda"))
            .to(torch.bfloat16) for n in (hk, wk))
        return q, k, v, bias_h, bias_w

    errs = {}
    for name, shape in (("SAM-H", (1, 16, 64, 64, 80)),
                        ("SAM-B", (1, 12, 64, 64, 64)),
                        ("48x64 grid", (1, 16, 48, 64, 80)),
                        ("48x48 grid", (1, 16, 48, 48, 80))):
        args = inputs(*shape)
        out = sa.sam_attention(*args)
        torch.cuda.synchronize()
        ref = sa.sam_attention_reference(*args).float()
        diff = (out.float() - ref).abs()
        err = diff.max().item()
        excess = (diff - SAM_TOL[0] - SAM_TOL[1] * ref.abs()).max().item()
        log(f"sam_kernel {name} {tuple(args[0].shape)} bf16: max|diff| "
            f"{err:.3g}, max|ref| {ref.abs().max().item():.3g} (tolerance "
            f"{SAM_TOL[0]} + {SAM_TOL[1]:.3g} |ref|)")
        check(excess <= 0, f"sam kernel disagrees at {name}: max|diff| {err}")
        errs[name] = err
        del out, ref, diff

    def timing(name, args):
        q, k, v, bias_h, bias_w = args
        b, h, s, d = q.shape
        kernel_ms = time_ms(lambda: sa.sam_attention(*args), iters=20)
        kernel_dev_ms = device_ms(lambda: sa.sam_attention(*args),
                                  "sam_attention", iters=20)
        plain_ms = time_ms(lambda: sa.sam_attention_reference(*args),
                           iters=3, warmup=1)
        mask = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(
            b, h, s, s)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), iters=20)
        library_dev_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), iters=20)
        del mask
        bytes_moved = sum(x.numel() * x.element_size() for x in args) \
            + q.numel() * q.element_size()
        flops = 4 * b * h * s * s * d
        bound_ms, bound_by = bound(bytes_moved, flops, H100_BF16_FLOP_PER_S)
        log(f"sam_kernel timing at {name} ({b}, {h}, {s}, {d}) bf16: kernel "
            f"{kernel_ms:.4f} ms ({kernel_dev_ms:.4f} ms on the device), "
            f"plain {plain_ms:.4f} ms, sdpa with the bias as mask "
            f"{library_ms:.4f} ms ({library_dev_ms:.4f} ms on the device), "
            f"bound {bound_ms * 1e3:.2f} us by {bound_by} "
            f"({bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        return kernel_ms, plain_ms, library_ms, bound_ms, bound_by

    kernel_ms, plain_ms, library_ms, bound_ms, bound_by = timing(
        "SAM-H", inputs(1, 16, 64, 64, 80))
    timing("SAM-B", inputs(1, 12, 64, 64, 64))
    # WK != 64: the kernel's general bias path (bias_w from shared memory)
    timing("SAM-H width, 48x48 grid", inputs(1, 16, 48, 48, 80))
    log(f"sam_kernel phase done in {time.perf_counter() - t0:.1f} s")
    return {"name": "sam_attention", "route": "cuda",
            "source": "instance_based_loc_tpu_torch/csrc/sam_attention.cu",
            "replaces": "instance_based_loc_tpu/ops/pallas/sam_attention.py:44",
            "launches": None, "max_abs_err": errs["SAM-H"],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def phase_msda_kernel():
    import torch
    from instance_based_loc_tpu_torch.ops import msda, msda_gather as mg
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(2)
    hh = ww = 100                       # GroundingDINO@800's level 0
    heads, d = 8, 32
    vmap = torch.randn((hh * ww, heads, d), generator=gen,
                       device="cuda").to(torch.bfloat16)
    entry = None
    for name, q in (("encoder", 13294), ("decoder", 900)):
        # sampling points spill outside the map: their taps weigh 0
        loc = torch.rand((q, heads, 4, 2), generator=gen,
                         device="cuda") * 1.1 - 0.05
        w = torch.softmax(torch.randn((q, heads, 4), generator=gen,
                                      device="cuda"), dim=-1)
        lin, coeff = msda._level_rows(loc, w, hh, ww)
        out = mg.msda_level_gather(vmap, lin, coeff)
        torch.cuda.synchronize()
        ref = mg.msda_level_gather_reference(vmap, lin, coeff)
        err = (out - ref).abs().max().item()
        zero = (coeff == 0).float().mean().item()
        log(f"msda_kernel {name} Q={q} S={hh * ww} H={heads} D={d} bf16: "
            f"max|diff| {err:.3g}, max|ref| {ref.abs().max().item():.3g}, "
            f"zero-weight taps {zero:.3f} (tolerance {MSDA_TOL})")
        check(err <= MSDA_TOL, f"msda kernel disagrees at {name}: {err}")
        call_ms = time_ms(lambda: mg.msda_level_gather(vmap, lin, coeff))
        kernel_ms = device_ms(lambda: mg.msda_level_gather(vmap, lin, coeff),
                              "msda_gather")
        plain_ms = time_ms(lambda: mg.msda_level_gather_reference(
            vmap, lin, coeff), iters=10)
        bytes_moved = (lin.numel() * 4 + coeff.numel() * 4
                       + vmap.numel() * vmap.element_size() + q * heads * d * 4)
        flops = 2 * q * heads * mg.TAPS * d
        bound_ms, bound_by = bound(bytes_moved, flops, H100_FP32_FLOP_PER_S)
        log(f"msda_kernel timing {name}: kernel {kernel_ms:.4f} ms on the "
            f"device ({call_ms:.4f} ms per back-to-back call), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us by {bound_by} "
            f"({bytes_moved / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); no "
            f"single PyTorch call computes this function")
        if entry is None:           # the encoder shape at level 0
            entry = {"name": "msda_gather", "route": "cuda",
                     "source": "instance_based_loc_tpu_torch/csrc/"
                               "msda_gather.cu",
                     "replaces": "instance_based_loc_tpu/ops/pallas/"
                                 "msda_gather.py:37",
                     "launches": None, "max_abs_err": err, "ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None}
    log(f"msda_kernel phase done in {time.perf_counter() - t0:.1f} s")
    return entry


class RecordingDetector:
    """Passes `find` to the cascade and records each frame's detections."""

    def __init__(self, inner):
        self.inner = inner
        self.frames = []

    def find(self, rgb, consider_floor):
        det = self.inner.find(rgb, consider_floor)
        self.frames.append(list(det.phrases))
        return det


def e2e_frames():
    from instance_based_loc_tpu_torch.data.synthetic import (
        default_scene, render_scene, ring_poses)
    scene = default_scene(num_objects=4, seed=5)
    poses = ring_poses(4, radius=4.5, height=1.3, target=(0, 0.4, 0))
    return [render_scene(scene, p, H_E2E, W_E2E, FOCAL_E2E)
            for p in poses], poses


def sync_ms(fn, reps: int = 3) -> float:
    """Mean host time of fn() with the card synchronised, after one run."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_cascade(workdir, frames, poses):
    import collections
    import numpy as np
    import torch
    from instance_based_loc_tpu_torch.memory import ObjectMemory
    from instance_based_loc_tpu_torch.models.cascade import (
        build_cascade_detector)
    from instance_based_loc_tpu_torch.models.embedders import get_embedder
    from instance_based_loc_tpu_torch.models.gdino import GDinoConfig
    from instance_based_loc_tpu_torch.models.sam import SamConfig, canvas
    from instance_based_loc_tpu_torch.ops import msda_gather, sam_attention
    t0 = time.perf_counter()
    cascade = build_cascade_detector(
        gdino_vocab=write_vocab(workdir), ram_tag_list=write_tag_list(workdir),
        random_init=True, sam_cfg=SamConfig(), gdino_cfg=GDinoConfig(),
        compute_dtype="bfloat16", device="cuda")
    seg, gd, ram = cascade.segmenter, cascade.grounder, cascade.tagger.ram
    scfg, gcfg, rcfg = seg.model.cfg, gd.model.cfg, ram.model.cfg
    rb = rcfg.backbone
    check((rb.embed_dim, rb.depths, rb.num_heads, rb.window, rb.img_size,
           rb.adapt_window, rcfg.num_tags, rcfg.layers, rcfg.hidden,
           ram.model.fc.weight.dtype)
          == (192, (2, 2, 18, 2), (6, 12, 24, 48), 12, 384, True, RAM_TAGS,
              2, 768, torch.bfloat16),
          f"RAM is not the bf16 Swin-L/384 tagger of {RAM_TAGS} tags: {rcfg}")
    tag_counts = cap_keywords(cascade)
    check((scfg.encoder_dim, scfg.encoder_depth, scfg.encoder_heads,
           scfg.img_size) == (1280, 32, 16, 1024), f"SAM is not SAM-H: {scfg}")
    check((gcfg.backbone.embed_dim, gcfg.backbone.depths, gcfg.backbone.window,
           gcfg.text.num_layers, gcfg.num_queries, gcfg.encoder_layers,
           gcfg.decoder_layers, gcfg.img_size)
          == (128, (2, 2, 18, 2), 12, 12, 900, 6, 6, 800),
          f"GroundingDINO is not the deployment config: {gcfg}")
    log(f"cascade: RAM (Swin-L/384, {RAM_TAGS} tags), GroundingDINO "
        f"(Swin-B, BERT-base) and SAM-H built with random weights in "
        f"{time.perf_counter() - t0:.1f} s")

    detector = RecordingDetector(cascade)
    memory = ObjectMemory(detector=detector,
                          camera_focal_lenth_x=FOCAL_E2E,
                          camera_focal_lenth_y=FOCAL_E2E,
                          get_embeddings_func=get_embedder("color"),
                          log_enabled=False, device="cuda")
    # the main path: every count from zero just before, read just after
    sam_attention.launches = msda_gather.launches = 0
    seg.encodes = gd.forwards = ram.forwards = 0
    t1 = time.perf_counter()
    for i in (0, 2):
        rgb, depth, _ = frames[i]
        memory.process_image(rgb, depth, poses[i], consider_floor=True,
                             min_points=50, outlier_removal_config=None)
    memory.downsample_all_objects(voxel_size=0.02)
    memory.recluster_objects_with_dbscan(eps=0.1, min_points_per_cluster=40)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t1) * 1e3
    rgb, depth, _ = frames[1]
    t2 = time.perf_counter()
    est, (assn, _) = memory.localise(rgb, depth, outlier_removal_config=None)
    torch.cuda.synchronize()
    query_ms = (time.perf_counter() - t2) * 1e3
    sam_launches, msda_launches = sam_attention.launches, msda_gather.launches
    encodes, forwards, tagged = seg.encodes, gd.forwards, ram.forwards

    for view, phrases in zip((0, 2, 1), detector.frames):
        log(f"cascade: view {view}: {len(phrases)} detections "
            f"{dict(collections.Counter(phrases))}")
    n_floor = 0 if memory.floors is None else memory.floors.num_points()
    log(f"cascade: memory of {len(memory.memory)} objects and "
        f"{n_floor} floor points built in {build_ms:.1f} ms (2 frames, "
        f"first use included); view 1 localised in {query_ms:.1f} ms: "
        f"pose {np.round(est, 4).tolist()}, assn {assn}")
    n_global = len(scfg.global_blocks)
    n_deform = (gcfg.encoder_layers + gcfg.decoder_layers) \
        * gcfg.num_feature_levels
    log(f"cascade: sam_attention launches {sam_launches} over {encodes} "
        f"image encodes ({n_global} global blocks); msda_gather launches "
        f"{msda_launches} over {forwards} GroundingDINO forwards "
        f"({n_deform} levels x deformable layers)")
    log(f"cascade: RAM tagged {tagged} frames: {tag_counts} of "
        f"{RAM_TAGS} tags above the 0.68 threshold; the first "
        f"{RAM_MAX_KEYWORDS} of each grounded")
    check(tagged == len(detector.frames) == 3,
          f"cascade: RAM ran {tagged} times for {len(detector.frames)} "
          f"frames")
    check(encodes > 0 and sam_launches == n_global * encodes,
          f"cascade: {sam_launches} SAM kernel launches for {encodes} encodes")
    check(forwards > 0 and msda_launches == n_deform * forwards,
          f"cascade: {msda_launches} gather launches for {forwards} forwards")
    est = np.asarray(est, np.float64)
    check(est.shape == (7,) and bool(np.all(np.isfinite(est)))
          and abs(np.linalg.norm(est[3:]) - 1.0) < 1e-3,
          f"cascade: pose not finite with a unit quaternion: {est}")

    # stage times (after the counted run)
    ram_ms = time_ms(lambda: ram(frames[0][0]), iters=5, warmup=1)
    raw = torch.as_tensor(frames[0][0], device="cuda")[None]
    gdino_ms = sync_ms(lambda: gd.detect_all(frames[0][0], KEYWORDS))
    with torch.no_grad():
        img = canvas(raw, scfg.img_size, torch.bfloat16)
        encode_ms = sync_ms(lambda: seg.model.image_encoder(img))
        emb = seg.model.image_encoder(img)[0]
        boxes = torch.tensor([[40.0, 60.0, 500.0, 700.0]] * 16,
                             device="cuda")
        decode_ms = sync_ms(lambda: seg.model.decode(emb, boxes))
    log(f"cascade timing: RAM {ram_ms:.1f} ms per frame (CUDA events; "
        f"preprocessing and the probabilities' copy to the host included), "
        f"GroundingDINO forward (detect_all) {gdino_ms:.1f} "
        f"ms, SAM encode {encode_ms:.1f} ms, SAM decode of 16 boxes "
        f"{decode_ms:.1f} ms, memory build {build_ms:.1f} ms, query "
        f"{query_ms:.1f} ms")
    log(f"cascade phase done in {time.perf_counter() - t0:.1f} s")
    return sam_launches, msda_launches, cascade


def phase_cascade_vs_cpu(workdir, frames):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from instance_based_loc_tpu_torch.models import gdino as G, ram as R
    from instance_based_loc_tpu_torch.models import sam as S
    from instance_based_loc_tpu_torch.models.cascade import cxcywh_to_xyxy
    from instance_based_loc_tpu_torch.models.wordpiece import (
        WordPieceTokenizer)
    from instance_based_loc_tpu_torch.ops import msda_gather, sam_attention
    t0 = time.perf_counter()

    def pair(model, init, seed, cast):
        """The same random weights on the card (cast to bf16 as the
        model's builder casts them) and the CPU (fp32)."""
        card = model.to("cuda")
        init(card, torch.Generator(device="cuda").manual_seed(seed))
        cpu = type(model)(model.cfg)
        cpu.load_state_dict({k: v.float().cpu()
                             for k, v in card.state_dict().items()})
        return cast(card, torch.bfloat16).eval(), cpu.eval()

    rgb = frames[0][0]
    raw = torch.as_tensor(rgb, device="cuda")[None]

    # GroundingDINO, 1 encoder + 1 decoder layer, full width
    gcfg = G.GDinoConfig(encoder_layers=1, decoder_layers=1)
    gcard, gcpu = pair(G.GroundingDino(gcfg), G.init_params, 8,
                       G.cast_for_inference)
    tok = WordPieceTokenizer(write_vocab(workdir))
    ids = [tok.cls_id]
    for k in KEYWORDS:
        ids += tok.encode(k + ".", add_special_tokens=False)
    ids = np.asarray(ids + [tok.sep_id], np.int64)[None]
    t = ids.shape[1]
    ids = np.pad(ids, ((0, 0), (0, (-t) % 16)))
    allowed, pos = G.make_text_masks(ids)
    table = gcpu.model.text_backbone.embeddings.word_embeddings.weight
    text = [torch.as_tensor(x) for x in (ids, allowed, pos, ids != 0)]
    text.append(table[text[0]].detach())
    images = G.device_preprocess(raw, gcfg.img_size, G.IMAGENET_MEAN,
                                 G.IMAGENET_STD)
    with torch.no_grad():
        before = msda_gather.launches
        lc, bc = gcard(images.to(torch.bfloat16),
                       *[x.to("cuda") for x in text])
        torch.cuda.synchronize()
        check(msda_gather.launches == before + 2 * gcfg.num_feature_levels,
              "cascade_vs_cpu: GroundingDINO missed the gather kernel")
        qc = gcard.query_index.cpu()
        lr, br = gcpu(images.cpu(), *text, query_index=qc)
    overlap = len(set(qc[0].tolist()) & set(gcpu.query_index[0].tolist())) \
        / gcfg.num_queries
    lc, bc = lc.cpu()[..., :t], bc.cpu()
    lr = lr[..., :t]
    logit_rel = ((lc - lr).abs().max() / lr.abs().max()).item()
    box_err = (bc - br).abs().max().item()
    log(f"cascade_vs_cpu: GroundingDINO (1 + 1 layers, 800 px) card bf16 vs "
        f"CPU fp32 on the same queries: logits max|diff| "
        f"{(lc - lr).abs().max().item():.4g} = {logit_rel:.4f} of max|ref| "
        f"{lr.abs().max().item():.4g} (gate {GDINO_LOGIT_REL_MAX}), boxes "
        f"max|diff| {box_err:.4g} (gate {GDINO_BOX_MAX}); the CPU's own "
        f"query selection shares {overlap:.3f} of the card's (gate "
        f"{GDINO_QUERY_OVERLAP_MIN})")

    # SAM-H width, 4 blocks (one global), 1024 px, prompted with the card's
    # 8 best-scoring GroundingDINO boxes
    scfg = S.SamConfig(encoder_depth=4, global_blocks=(3,))
    scard, scpu = pair(S.Sam(scfg), S.init_params, 9,
                       lambda m, dt: m.to(dt))
    best = torch.sigmoid(lc).amax(dim=-1)[0].argsort(descending=True)[:8]
    h, w = rgb.shape[:2]
    boxes = torch.as_tensor(cxcywh_to_xyxy(bc[0, best].numpy(), w, h)
                            * (scfg.img_size / max(h, w)), dtype=torch.float32)
    with torch.no_grad():
        before = sam_attention.launches
        emb_c = scard.image_encoder(S.canvas(raw, scfg.img_size,
                                             torch.bfloat16))[0]
        mc, _ = scard.decode(emb_c, boxes.to("cuda"))
        torch.cuda.synchronize()
        check(sam_attention.launches == before + 1,
              "cascade_vs_cpu: SAM missed the attention kernel")
        emb_r = scpu.image_encoder(S.canvas(raw.cpu(), scfg.img_size,
                                            torch.float32))[0]
        mr, _ = scpu.decode(emb_r, boxes)
    emb_c = emb_c.float().cpu()
    cos = F.cosine_similarity(emb_c.flatten(), emb_r.flatten(), dim=0).item()
    cos_px = F.cosine_similarity(emb_c, emb_r, dim=-1).min().item()
    mask_rel = ((mc.float().cpu() - mr).abs().max() / mr.abs().max()).item()
    log(f"cascade_vs_cpu: SAM (SAM-H width, 4 blocks, 1024 px) card bf16 vs "
        f"CPU fp32: embedding cosine {cos:.6f} (per pixel min {cos_px:.6f}; "
        f"gate {SAM_EMB_COS_MIN}), mask logits max|diff| "
        f"{(mc.float().cpu() - mr).abs().max().item():.4g} = {mask_rel:.4f} "
        f"of max|ref| {mr.abs().max().item():.4g} (gate {SAM_LOGIT_REL_MAX})")
    # RAM: Swin-L widths, 1 block per stage, 2 decoder layers, 4585 tags
    rcfg = R.RamConfig(backbone=dataclasses.replace(R.RAM_SWIN_L,
                                                    depths=(1, 1, 1, 1)),
                       num_tags=RAM_TAGS)
    rcard, rcpu = pair(R.Ram(rcfg), R.init_params, 10,
                       lambda m, dt: m.to(dt))
    img = G.device_preprocess(raw, rcfg.backbone.img_size, G.IMAGENET_MEAN,
                              G.IMAGENET_STD)
    with torch.no_grad():
        pc = torch.sigmoid(rcard(img.to(torch.bfloat16)).float()).cpu()
        pr = torch.sigmoid(rcpu(img.cpu()))
    ram_err = (pc - pr).abs().max().item()
    flips = int(((pc > 0.68) != (pr > 0.68)).sum())
    log(f"cascade_vs_cpu: RAM (Swin-L widths, 1 block per stage, 2 decoder "
        f"layers, {RAM_TAGS} tags, 384 px) card bf16 vs CPU fp32: tag "
        f"probabilities max|diff| {ram_err:.4g} (gate {RAM_PROB_MAX}); "
        f"{int((pr > 0.68).sum())} tags above 0.68 on the CPU, {flips} "
        f"decided otherwise on the card")
    check(ram_err <= RAM_PROB_MAX, f"cascade_vs_cpu: RAM probabilities "
                                   f"{ram_err}")
    check(cos >= SAM_EMB_COS_MIN, f"cascade_vs_cpu: SAM cosine {cos}")
    check(mask_rel <= SAM_LOGIT_REL_MAX,
          f"cascade_vs_cpu: SAM mask logits {mask_rel}")
    check(logit_rel <= GDINO_LOGIT_REL_MAX,
          f"cascade_vs_cpu: GroundingDINO logits {logit_rel}")
    check(box_err <= GDINO_BOX_MAX,
          f"cascade_vs_cpu: GroundingDINO boxes {box_err}")
    check(overlap >= GDINO_QUERY_OVERLAP_MIN,
          f"cascade_vs_cpu: query selections share only {overlap}")
    log(f"cascade_vs_cpu phase done in {time.perf_counter() - t0:.1f} s")


# phase 9 (c): the IoU matrix of the reclustering's staged clouds on the card
# against the same fp32 function on the CPU (set before the first run on the
# card): the same agglomerative labels from both matrices, and at most 0.1 %
# of the pairs more than 1e-3 apart (both sum volume tetrahedra reaching
# from the world origin in fp32, in their own orders: ~1e-4 on the CPU
# against JAX; a near-degenerate box fit can move one pair further)
IOU_DIFF, IOU_DIFF_SHARE_MAX = 1e-3, 1e-3


@contextlib.contextmanager
def recording_memories():
    """Records (memory, staged IoU clouds) each time an ObjectMemory stages
    its reclustering clouds: the CLIs build their memories inside `main`."""
    from instance_based_loc_tpu_torch.memory.object_memory import ObjectMemory
    seen = []
    original = ObjectMemory._iou_clouds

    def recording(self):
        out = original(self)
        seen.append((self, out))
        return out
    ObjectMemory._iou_clouds = recording
    try:
        yield seen
    finally:
        ObjectMemory._iou_clouds = original


@contextlib.contextmanager
def working_directory(path):
    """The CLIs write their debug dumps under ./pcds."""
    import os
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def adaptive_png(path, image):
    """A PNG whose rows each take the filter of smallest sum of |signed
    bytes|, the heuristic of libpng and PIL's encoder (so Average and Paeth
    rows appear), to time the port's decoder on such files; the card's
    machine has no PIL."""
    import struct
    import zlib
    import numpy as np
    image = np.asarray(image)
    if image.dtype == np.uint16:
        data = image.astype(">u2").view(np.uint8).reshape(image.shape[0], -1)
        colour, depth, bpp = 0, 16, 2
    else:
        data = image.reshape(image.shape[0], -1)
        colour, depth, bpp = 2, 8, 3
    rows, prev = [], np.zeros(data.shape[1], np.int32)
    for row in data.astype(np.int32):
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pa, pb, pc = np.abs(prev - c), np.abs(a - c), np.abs(a + prev - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        cands = [(row - p) & 0xFF for p in
                 (0, a, prev, (a + prev) // 2, paeth)]
        cost = [np.abs(x.astype(np.int8).astype(np.int32)).sum()
                for x in cands]
        best = int(np.argmin(cost))
        rows.append(bytes([best]) + cands[best].astype(np.uint8).tobytes())
        prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", image.shape[1],
                                             image.shape[0], depth, colour,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))
    return np.bincount([r[0] for r in rows], minlength=5).tolist()


def log_memory(tag, memory):
    n_pts = sum(o.num_points() for o in memory.memory)
    log(f"{tag}: memory of {len(memory.memory)} objects, {n_pts} points; "
        f"stage timer:")
    for line in memory.timer.report().splitlines():
        log(f"{tag}:   {line}")


def phase_cli_synth(workdir):
    """(a) synth_localisation_trial with its defaults."""
    from instance_based_loc_tpu_torch.cli import synth_localisation_trial
    t0 = time.perf_counter()
    with recording_memories() as seen, working_directory(workdir):
        trans, rot = synth_localisation_trial.main([
            "--out-dir", f"{workdir}/a_out", "--data-path", f"{workdir}/a"])
    log_memory("cli (a) synth", seen[-1][0])
    log(f"cli (a) synth: eval views translation errors {trans}, rotation "
        f"errors {rot}; {time.perf_counter() - t0:.1f} s")
    check(len(trans) >= 1 and all(
        te < SUCCESS_TRANS_M and re_ < SUCCESS_ROT_RAD
        for te, re_ in zip(trans, rot)),
        f"cli (a): an eval view misses the success thresholds: {trans}, "
        f"{rot}")


def phase_cli_tum(workdir):
    """(b) localisation_trial on the bench scene in the TUM layout, with
    full-width DINOv2-base, the map build, ply dumps and the pkl."""
    import os
    import numpy as np
    import torch
    from instance_based_loc_tpu_torch.cli import localisation_trial as lt
    from instance_based_loc_tpu_torch.data import loader
    from instance_based_loc_tpu_torch.data.synthetic import (
        default_scene, ring_poses, write_tum_dataset)
    from instance_based_loc_tpu_torch.memory import (ColorRegionDetector,
                                                     ObjectMemory)
    from instance_based_loc_tpu_torch.ops import attention
    from instance_based_loc_tpu_torch.ops.backprojection import backproject
    from instance_based_loc_tpu_torch.ops.outliers import (
        DEFAULT_OUTLIER_REMOVAL_CONFIG as OUT, radius_outlier_keep_mask)
    from instance_based_loc_tpu_torch.ops.transforms import (
        transform_points_kinect)
    from instance_based_loc_tpu_torch.ops.voxel import voxel_downsample
    from instance_based_loc_tpu_torch.utils.ply import read_ply
    from instance_based_loc_tpu_torch.utils.png import read_png
    t0 = time.perf_counter()
    data = f"{workdir}/tum"
    scene = default_scene(num_objects=9, seed=3)
    write_tum_dataset(data, scene, height=480, width=640, focal_length=525.0,
                      poses=ring_poses(9, radius=4.5, height=1.3,
                                       target=(0, 0.4, 0)))
    log(f"cli (b) tum: dataset written in {time.perf_counter() - t0:.1f} s")

    # the PNG decoder on the written frames (every row Sub-filtered) and on
    # frames whose rows take PIL's kind of adaptive filters
    rgb_path = f"{data}/rgb/frame_0000.png"
    depth_path = f"{data}/depth/frame_0000.png"
    for name, path in (("rgb", rgb_path), ("16-bit depth", depth_path)):
        image = read_png(path)
        t1 = time.perf_counter()
        for _ in range(5):
            read_png(path)
        own_ms = (time.perf_counter() - t1) / 5 * 1e3
        mixed = f"{workdir}/adaptive.png"
        filters = adaptive_png(mixed, image)
        check(np.array_equal(read_png(mixed), image),
              f"cli (b): adaptive-filter {name} PNG decodes wrongly")
        t1 = time.perf_counter()
        for _ in range(3):
            read_png(mixed)
        mixed_ms = (time.perf_counter() - t1) / 3 * 1e3
        log(f"cli (b) png decode 640x480 {name}: {own_ms:.1f} ms (rows "
            f"Sub-filtered, the port's writer), {mixed_ms:.1f} ms (adaptive "
            f"filters, rows None/Sub/Up/Average/Paeth = {filters})")

    # the map build's steps on one full frame, timed with the card synced
    rgb = loader.load_rgb(rgb_path)
    depth = torch.as_tensor(loader.load_depth(depth_path) / 5000.0,
                            device="cuda")
    pts, valid = backproject(depth, 525.0, 525.0)
    pose = torch.as_tensor(ring_poses(9, radius=4.5, height=1.3,
                                      target=(0, 0.4, 0))[0], device="cuda")
    p = transform_points_kinect(pts, pose)[valid]
    cols = (torch.as_tensor(rgb, device="cuda").float() / 255).reshape(
        -1, 3)[valid]
    ones = torch.ones(len(p), dtype=torch.bool, device="cuda")
    out_ms = sync_ms(lambda: radius_outlier_keep_mask(
        p, ones, OUT["radius"], OUT["radius_nb_points"]))
    vox_ms = sync_ms(lambda: voxel_downsample(p, cols, ones, 0.025))
    log(f"cli (b) map build steps on one 640x480 frame ({len(p)} points): "
        f"radius outliers {out_ms:.1f} ms, voxel grid (0.025) "
        f"{vox_ms:.1f} ms")
    # the voxel grid sums each voxel in sorted order: the same bits on
    # every run, and the CPU's values
    vox = voxel_downsample(p, cols, ones, 0.025)
    check(all(torch.equal(a, b) for a, b in
              zip(vox, voxel_downsample(p, cols, ones, 0.025))),
          "cli (b): the device voxel grid differs between two runs")
    vox_cpu = voxel_downsample(p.cpu(), cols.cpu(), ones.cpu(), 0.025)
    check(torch.equal(vox[2].cpu(), vox_cpu[2]),
          "cli (b): the device voxel grid's mask differs from the CPU's")
    vox_err = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(vox[:2], vox_cpu[:2]))
    log(f"cli (b) voxel grid: card against CPU max |diff| {vox_err:.3g} "
        f"(held to 1e-5), bit-identical "
        f"{all(torch.equal(a.cpu(), b) for a, b in zip(vox, vox_cpu))}")
    check(vox_err <= 1e-5,
          f"cli (b): the device voxel grid is {vox_err} off the CPU's")

    scene_flags = ["--convention", "tum", "--data-path", data,
                   "--embeddings", "dino", "--detector", "color",
                   "-e", "6", "7", "8", "--consider-floor",
                   "--min-points", "200", "--no-outlier-removal",
                   "--focal-length", "525", "--sampling-period", "1",
                   "--downsample-voxel-size", "0.02", "--dbscan-eps", "0.1",
                   "--dbscan-min-points", "40",
                   "--fpfh-global-dist-factor", "2.0",
                   "--fpfh-local-dist-factor", "0.4",
                   "--build-map", "--map-pcd-cache-path", f"{workdir}/map.npz",
                   "--save-point-clouds",
                   "--memory-save-path", f"{workdir}/tum_mem.pkl",
                   "--out-dir", f"{workdir}/b_out", "--testname", "tum_dino",
                   "--quiet"]
    args = lt.apply_convention_defaults(lt.make_parser().parse_args(
        scene_flags))
    detector = ColorRegionDetector(min_area=500,
                                   floor_colors=[scene.floor_color])
    # the main path: every count from zero just before, read just after
    attention.launches = 0
    t1 = time.perf_counter()
    with recording_memories() as seen, working_directory(workdir):
        trans, rot = lt.main(args, detector=detector)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = attention.launches
    memory = seen[-1][0]
    batches = memory.get_embeddings_func.batches
    log_memory("cli (b) tum", memory)
    log(f"cli (b) tum: CLI run {run_s:.1f} s; views 6-8 translation errors "
        f"{np.round(trans, 4).tolist()}, rotation errors "
        f"{np.round(rot, 4).tolist()} (random weights: not gated); "
        f"vit_attention launches {launches} over {batches} crop batches")
    check(batches > 0 and launches == 12 * batches,
          f"cli (b): {launches} ViT kernel launches for {batches} batches")
    check(len(trans) == 3 and bool(np.all(np.isfinite(trans + rot))),
          f"cli (b): poses not finite: {trans}, {rot}")
    check(os.path.exists(f"{workdir}/b_out/tum_dino_results.txt"),
          "cli (b): no results file")
    fresh = ObjectMemory(detector=detector, camera_focal_lenth_x=525.0,
                         camera_focal_lenth_y=525.0,
                         get_embeddings_func=memory.get_embeddings_func,
                         log_enabled=False, device="cuda")
    fresh.load(f"{workdir}/tum_mem.pkl")
    check(len(fresh.memory) == len(memory.memory) > 0 and all(
        np.array_equal(a.pts, b.pts) and np.array_equal(a.cols, b.cols)
        for a, b in zip(fresh.memory, memory.memory)),
        "cli (b): the memory pkl does not load back equal")
    dumps = 0
    for root, _, names in os.walk(f"{workdir}/pcds/tum_dino"):
        for name in names:
            ply_pts, _ = read_ply(os.path.join(root, name))
            check(len(ply_pts) > 0 and bool(np.isfinite(ply_pts).all()),
                  f"cli (b): bad ply dump {name}")
            dumps += 1
    check(dumps >= 2, f"cli (b): {dumps} ply dumps")
    map_pts = np.load(f"{workdir}/map.npz")["points"]
    log(f"cli (b) tum: {dumps} ply dumps read back; map of {len(map_pts)} "
        f"points; part done in {time.perf_counter() - t0:.1f} s")
    check(len(map_pts) > 1000, f"cli (b): map of {len(map_pts)} points")
    return launches


def phase_cli_cascade(workdir, cascade):
    """(c) localisation_trial with phase 7's cascade, chunked detection and
    the CLI's reclustering; the IoU matrix on the card against the CPU."""
    import numpy as np
    import torch
    from instance_based_loc_tpu_torch.cli import localisation_trial as lt
    from instance_based_loc_tpu_torch.data.synthetic import (
        default_scene, ring_poses, write_synth_dataset)
    from instance_based_loc_tpu_torch.ops import msda_gather, sam_attention
    from instance_based_loc_tpu_torch.ops.clustering import (
        agglomerative_precomputed)
    from instance_based_loc_tpu_torch.ops.iou3d import pairwise_obb_iou
    t0 = time.perf_counter()
    data = f"{workdir}/neural"
    write_synth_dataset(data, default_scene(num_objects=4, seed=5),
                        height=H_E2E, width=W_E2E, focal_length=FOCAL_E2E,
                        poses=ring_poses(4, radius=4.5, height=1.3,
                                         target=(0, 0.4, 0))[:3])
    args = lt.apply_convention_defaults(lt.make_parser().parse_args([
        "--convention", "synth", "--data-path", data,
        "--embeddings", "color", "--detector", "cascade",
        "-e", "1", "--consider-floor", "--detect-batch", "2",
        "--focal-length", str(FOCAL_E2E), "--min-points", "50",
        "--no-outlier-removal", "--downsample-voxel-size", "0.02",
        "--dbscan-eps", "0.1", "--dbscan-min-points", "40",
        "--out-dir", f"{workdir}/c_out", "--testname", "cascade",
        "--quiet"]))
    seg, gd, ram = cascade.segmenter, cascade.grounder, cascade.tagger.ram
    # the main path: every count from zero just before, read just after
    sam_attention.launches = msda_gather.launches = 0
    seg.encodes = gd.forwards = ram.forwards = 0
    t1 = time.perf_counter()
    with recording_memories() as seen, working_directory(workdir):
        trans, rot = lt.main(args, detector=cascade)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    sam_launches, msda_launches = sam_attention.launches, msda_gather.launches
    encodes, forwards, tagged = seg.encodes, gd.forwards, ram.forwards
    memory, (pts, msk) = seen[-1]
    log_memory("cli (c) cascade", memory)
    log(f"cli (c) cascade: CLI run {run_s:.1f} s; view 1 translation error "
        f"{trans}, rotation error {rot} (random weights: not gated); "
        f"sam_attention launches {sam_launches} over {encodes} encodes, "
        f"msda_gather launches {msda_launches} over {forwards} forwards, "
        f"{tagged} RAM forwards")
    check(tagged > 0, "cli (c): RAM tagged no frame")
    check(encodes > 0 and sam_launches == 4 * encodes,
          f"cli (c): {sam_launches} SAM kernel launches for {encodes} "
          f"encodes")
    check(forwards > 0 and msda_launches == 48 * forwards,
          f"cli (c): {msda_launches} gather launches for {forwards} forwards")
    check(bool(np.all(np.isfinite(trans + rot))),
          f"cli (c): pose not finite: {trans}, {rot}")

    k = len(pts)

    def on_card():
        return pairwise_obb_iou(torch.as_tensor(pts, device="cuda"),
                                torch.as_tensor(msk, device="cuda"))
    iou_ms = sync_ms(on_card, reps=1)
    card = on_card().cpu().numpy()
    t1 = time.perf_counter()
    cpu = pairwise_obb_iou(torch.as_tensor(pts), torch.as_tensor(msk)).numpy()
    cpu_s = time.perf_counter() - t1
    diff = np.abs(card - cpu)
    share = float((diff > IOU_DIFF).mean())

    def labels(iou):
        dist = 1.0 - iou
        np.fill_diagonal(dist, 0.0)
        return agglomerative_precomputed(dist, 1.0 - args.iou_threshold)
    same = bool(np.array_equal(labels(card), labels(cpu)))
    log(f"cli (c) cascade: IoU matrix over K = {k} objects "
        f"({int(msk.sum())} staged points, {k * (k - 1) // 2} pairs): card "
        f"{iou_ms:.1f} ms, CPU {cpu_s * 1e3:.1f} ms; card vs CPU max|diff| "
        f"{diff.max():.3g}, share of pairs beyond {IOU_DIFF}: {share:.2e} "
        f"(gate {IOU_DIFF_SHARE_MAX}); identical labels: {same}; part done "
        f"in {time.perf_counter() - t0:.1f} s")
    check(k >= 2 and share <= IOU_DIFF_SHARE_MAX and same,
          f"cli (c): the card's IoU matrix disagrees with the CPU's "
          f"(share {share}, labels equal {same})")
    return sam_launches, msda_launches


# phase 10: a batched row against `localise` of its frame; phase 11: the
# DATOR model in bf16 on the card against fp32 on the CPU, same weights
# (embeddings and class tokens, cosine per crop; set before the first run)
SERVE_POSE_TOL = 1e-5
DATOR_COS_MIN = 0.99
SERVE_REPEAT, SERVE_BATCHES = 24, (1, 6, 12)
# the (batch, graph) runs of phase 10: eager batch 1 is cut to keep the
# script near 180 s (an eager query is ~0.24 s of host launches; `localise`,
# the rows' reference, already runs batch 1 as a graph)
SERVE_RUNS = ((1, True), (6, False), (6, True), (12, False), (12, True))
# phase 10's quality gate, like for like: on this stream the JAX package
# itself localises views 6 / 7 / 8 on 24 / 20 / 24 of their 24 streams
# (perf/torch_serving_streams.py on a CPU, on a memory the port built;
# the port there: 24 / 19 / 24), so "every query within the gate" is not
# the reference's behaviour. Each view must reach the smallest count that
# Fisher's exact test (two-sided, 5 %) does not set below the JAX count.
SERVE_MIN_WINS = {6: 20, 7: 13, 8: 20}


def profile_chunk(fn):
    """Run fn() once under torch.profiler: (wall ms, device busy ms, host
    launch calls, device kernels). Busy is the sum of the kernels' and
    copies' durations (one stream: they do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, kernels, launches = 0.0, 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
            kernels += 1
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel", "cuLaunchKernelEx",
                        "cudaGraphLaunch", "cudaMemcpyAsync",
                        "cudaMemsetAsync"):
            launches += 1
    return wall_ms, busy_us / 1e3, launches, kernels


def phase_serve(memory, scene_data):
    """bench.py's 72-query serving stream through localise_many, eager and
    as CUDA-graph replays, at batch 1, 6 and 12."""
    import numpy as np
    import torch
    from instance_based_loc_tpu_torch.memory.object_memory import FETCHED
    from instance_based_loc_tpu_torch.ops.query_graph import QUERY_TENSORS
    from instance_based_loc_tpu_torch.ops.transforms import quaternion_error
    t0 = time.perf_counter()
    _, poses, frames, _ = scene_data
    views = [6, 7, 8] * SERVE_REPEAT
    stream = [(frames[v][0], frames[v][1]) for v in views]
    kw = dict(outlier_removal_config=None)
    base = memory._frame_counter
    # the reference results: `localise` per frame, frame j of the stream
    # drawing from seed base + j + 1
    singles = [memory.localise(rgb, depth, **kw) for rgb, depth in stream]

    def serve(batch, graph):
        memory._frame_counter = base
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = memory._localise_many_chunked(stream, batch, "vmap", True,
                                            graph=graph, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    # each view's successes over its streams: every run below gives the
    # rows of `singles` (checked), so they are counted once
    wins = {v: 0 for v in (6, 7, 8)}
    for view, (est, _) in zip(views, singles):
        te = float(np.linalg.norm(est[:3] - poses[view][:3]))
        re_ = float(quaternion_error(
            torch.as_tensor(poses[view][3:], dtype=torch.float32),
            torch.as_tensor(est[3:], dtype=torch.float32)))
        wins[view] += te < SUCCESS_TRANS_M and re_ < SUCCESS_ROT_RAD
    log(f"serve: views 6 / 7 / 8 within 0.6 m / 0.3 rad on "
        f"{' / '.join(str(wins[v]) for v in (6, 7, 8))} of their "
        f"{SERVE_REPEAT} streams (each at least "
        f"{' / '.join(str(SERVE_MIN_WINS[v]) for v in (6, 7, 8))})")
    check(all(wins[v] >= SERVE_MIN_WINS[v] for v in wins),
          f"serve: a view is localised on fewer streams than the JAX "
          f"package's count allows: {wins}")

    runs = {}
    for batch, graph in SERVE_RUNS:
        if graph:                               # first use: the capture
            memory._frame_counter = base
            memory._localise_many_chunked(stream[:batch], batch, "vmap",
                                          False, graph=True, **kw)
        out, secs = serve(batch, graph)
        runs[batch, graph] = out
        pose_err = max(float(np.abs(p - s[0]).max())
                       for (p, _), s in zip(out, singles))
        same_assn = all(a[0] == s[1][0] for (_, a), s in zip(out, singles))
        bitwise = all(np.array_equal(p, s[0])
                      for (p, _), s in zip(out, singles))
        log(f"serve: batch {batch} {'graph' if graph else 'eager'}: "
            f"{len(stream) / secs:.2f} frames/s ({secs:.3f} s for "
            f"{len(stream)} queries); against localise: same assignments "
            f"{same_assn}, max |pose diff| {pose_err:.3g}, bitwise "
            f"{bitwise}")
        check(same_assn and pose_err <= SERVE_POSE_TOL,
              f"serve: batch {batch} graph={graph} rows differ from "
              f"localise (assignments equal {same_assn}, pose {pose_err})")
    for batch in SERVE_BATCHES:
        if (batch, False) not in runs:
            continue
        eager, graph = runs[batch, False], runs[batch, True]
        same = all(np.array_equal(a[0], b[0]) and a[1][0] == b[1][0]
                   for a, b in zip(eager, graph))
        log(f"serve: batch {batch}: graph replay equals eager bitwise: "
            f"{same}")
        check(same, f"serve: batch {batch}: graph replay differs from eager")

    # one chunk per configuration: the wall time of the chunk alone, and
    # its device time. Eager: torch.profiler over a batch-1 chunk (larger
    # eager chunks repeat its program; under the profiler a 12-query chunk
    # takes ~30 s). A graph: the replay timed with CUDA events, since a
    # replay under torch.profiler ended the process (segfault, torch 2.11 +
    # CUDA 12.8 on the H100); its host launch calls are counted from the
    # dispatch (one graph launch, the staging and fetch copies)

    def chunk_wall_ms(batch, graph):
        memory._frame_counter = base
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        memory._localise_many_chunked(stream[:batch], batch, "vmap", False,
                                      graph=graph, **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3

    memory._frame_counter = base
    _, busy, launches, kernels = profile_chunk(
        lambda: memory._localise_many_chunked(stream[:1], 1, "vmap", False,
                                              graph=False, **kw))
    wall = chunk_wall_ms(1, False)
    log(f"serve: one chunk, batch 1 eager: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms (torch.profiler), idle share {1 - busy / wall:.3f}; "
        f"per query {launches} host launch calls, {kernels} device kernels")
    calls = 1 + 2 * len(QUERY_TENSORS) + len(FETCHED)
    for batch in SERVE_BATCHES:
        wall = chunk_wall_ms(batch, True)
        graph = [g for g in memory._pack["graphs"].values()
                 if len(g.generators) == batch][0]
        busy = time_ms(graph.graph.replay, iters=5, warmup=1)
        log(f"serve: one chunk, batch {batch} graph: wall {wall:.2f} ms, "
            f"device busy {busy:.2f} ms (the replay, CUDA events), idle "
            f"share {1 - busy / wall:.3f}; per query {calls / batch:.2f} "
            f"host launch calls (1 graph launch and {calls - 1} copies a "
            f"chunk)")
    log(f"serve phase done in {time.perf_counter() - t0:.1f} s")


def phase_dator(workdir, scene_data):
    """The DATOR embedder at full width: the kernel at the towers' shape,
    the launch count per crop batch, bf16 on the card against fp32 on the
    CPU, and the trial CLI with --embeddings dator --serve-batch 6."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from instance_based_loc_tpu_torch.cli import localisation_trial as lt
    from instance_based_loc_tpu_torch.data.synthetic import default_scene
    from instance_based_loc_tpu_torch.memory import ColorRegionDetector
    from instance_based_loc_tpu_torch.models.dator import fourdnet
    from instance_based_loc_tpu_torch.models.dator.data import (
        preprocess_depth, preprocess_rgb)
    from instance_based_loc_tpu_torch.models.embedders import get_embedder
    from instance_based_loc_tpu_torch.ops import attention
    t0 = time.perf_counter()
    embed = get_embedder("dator", device="cuda")
    cfg = embed.model.cfg
    bb = cfg.backbone
    check((bb.hidden_size, bb.num_blocks, bb.num_heads, bb.img_height,
           bb.img_width, bb.patch_size, cfg.reduced_dim, cfg.bnneck,
           bb.dtype) == (768, 11, 12, 256, 128, 16, 128, True,
                         torch.bfloat16),
          f"dator: not the full-width bf16 FourDNet: {cfg}")
    log(f"dator: FourDNet built in {time.perf_counter() - t0:.1f} s")

    # the kernel at the towers' shape: 2 towers x 16 crops, S = 129
    gen = torch.Generator(device="cuda").manual_seed(2)
    shape = (2 * 16, bb.num_heads, bb.num_patches + 1,
             bb.hidden_size // bb.num_heads)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out = attention.vit_attention(q, k, v)
    torch.cuda.synchronize()
    ref = attention.vit_attention_reference(q, k, v).float()
    diff = (out.float() - ref).abs()
    err = diff.max().item()
    atol, rtol = 1e-4, 2 ** -7                 # phase 2's bf16 tolerance
    log(f"dator: kernel {shape} bf16: max|diff| {err:.3g}, max|ref| "
        f"{ref.abs().max().item():.3g} (tolerance {atol} + {rtol:.3g} |ref|)")
    check((diff - atol - rtol * ref.abs()).max().item() <= 0,
          f"dator: kernel disagrees at {shape}: max|diff| {err}")
    kernel_ms = device_ms(lambda: attention.vit_attention(q, k, v),
                          "vit_attention")
    call_ms = time_ms(lambda: attention.vit_attention(q, k, v))
    plain_ms = time_ms(lambda: attention.vit_attention_reference(q, k, v))
    sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    b, h, s, d = shape
    bound_ms, bound_by = bound(4 * b * h * s * d * 2, 4 * b * h * s * s * d,
                               H100_BF16_FLOP_PER_S)
    log(f"dator: kernel timing at {shape} bf16: kernel {kernel_ms:.4f} ms "
        f"on the device ({call_ms:.4f} ms per back-to-back call), plain "
        f"{plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms on the device, bound "
        f"{bound_ms * 1e3:.2f} us by {bound_by} "
        f"({4 * b * h * s * d * 2 / 1e6:.1f} MB, "
        f"{4 * b * h * s * s * d / 1e9:.2f} GFLOP)")

    # the embedder on the bench scene's crops: one launch per block
    _, _, frames, _ = scene_data
    detector = ColorRegionDetector(min_area=500)
    attention.launches = 0
    embed.batches = 0
    crops = 0
    for view in (0, 3, 6):
        rgb, depth, _ = frames[view]
        det = detector.find(rgb, False)
        feats = embed(det, full_rgb_image=rgb, full_depth_image=depth)
        check(feats.shape == (len(det), cfg.reduced_dim)
              and bool(np.isfinite(feats).all()),
              f"dator: view {view} embeddings {feats.shape} not finite")
        crops += len(det)
    launches, batches = attention.launches, embed.batches
    log(f"dator: {crops} crops of 3 bench views in {batches} batches: "
        f"vit_attention launches {launches} ({bb.num_blocks} per batch "
        f"expected: the two towers share each block's launch)")
    check(batches > 0 and launches == bb.num_blocks * batches,
          f"dator: {launches} kernel launches for {batches} batches")

    # the model on the card (bf16, kernel) against the same weights in fp32
    # on the CPU (plain attention), 4 crops
    det = detector.find(frames[6][0], False)
    idx = range(min(4, len(det)))
    rgbs = torch.as_tensor(np.stack([preprocess_rgb(det.crops[i])
                                     for i in idx]))
    depths = []
    for i in idx:
        x1, y1, x2, y2 = det.boxes_xyxy[i].astype(int)
        depths.append(preprocess_depth(frames[6][1][y1:y2, x1:x2]))
    depths = torch.as_tensor(np.stack(depths))
    cpu_cfg = dataclasses.replace(
        cfg, dtype=torch.float32,
        backbone=dataclasses.replace(bb, dtype=torch.float32))
    cpu_model = fourdnet.FourDNet(cpu_cfg)
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in
                               embed.model.state_dict().items()})
    cpu_model.eval()
    with torch.no_grad():
        _, card, (card_rc, _) = embed.model(rgbs.cuda(), depths.cuda(),
                                            return_cls_tokens=True)
        _, ref, (ref_rc, _) = cpu_model(rgbs, depths, return_cls_tokens=True)
    cos = F.cosine_similarity(card.float().cpu(), ref, dim=-1)
    cos_cls = F.cosine_similarity(card_rc.float().cpu(), ref_rc, dim=-1)
    rel = ((card.float().cpu() - ref).abs().max() / ref.abs().max()).item()
    log(f"dator: model on the card (bf16) vs fp32 on the CPU, {len(idx)} "
        f"crops: embedding cosine min {cos.min().item():.6f} (max|diff| "
        f"{rel:.3g} of max|ref|), rgb class token cosine min "
        f"{cos_cls.min().item():.6f} (threshold {DATOR_COS_MIN})")
    check(bool(torch.all(cos > DATOR_COS_MIN))
          and bool(torch.all(cos_cls > DATOR_COS_MIN)),
          f"dator: the card disagrees with its fp32 CPU run: cosine "
          f"{cos.tolist()}, class tokens {cos_cls.tolist()}")

    # the trial CLI on phase 9 (b)'s TUM dataset, served in chunks of 6
    scene = default_scene(num_objects=9, seed=3)
    args = lt.apply_convention_defaults(lt.make_parser().parse_args([
        "--convention", "tum", "--data-path", f"{workdir}/tum",
        "--embeddings", "dator", "--detector", "color",
        "-e", "6", "7", "8", "--consider-floor", "--min-points", "200",
        "--no-outlier-removal", "--focal-length", "525",
        "--sampling-period", "1", "--downsample-voxel-size", "0.02",
        "--dbscan-eps", "0.1", "--dbscan-min-points", "40",
        "--fpfh-global-dist-factor", "2.0", "--fpfh-local-dist-factor", "0.4",
        "--serve-batch", "6", "--out-dir", f"{workdir}/d_out",
        "--testname", "tum_dator", "--quiet"]))
    detector = ColorRegionDetector(min_area=500,
                                   floor_colors=[scene.floor_color])
    # the main path: every count from zero just before, read just after
    attention.launches = 0
    t1 = time.perf_counter()
    with recording_memories() as seen, working_directory(workdir):
        trans, rot = lt.main(args, detector=detector)
    torch.cuda.synchronize()
    cli_launches = attention.launches
    memory = seen[-1][0]
    cli_batches = memory.get_embeddings_func.batches
    log_memory("dator cli", memory)
    log(f"dator cli: run {time.perf_counter() - t1:.1f} s; views 6-8 "
        f"translation errors {np.round(trans, 4).tolist()}, rotation errors "
        f"{np.round(rot, 4).tolist()} (random weights: not gated); "
        f"vit_attention launches {cli_launches} over {cli_batches} crop "
        f"batches")
    check(cli_batches > 0 and cli_launches == bb.num_blocks * cli_batches,
          f"dator cli: {cli_launches} kernel launches for {cli_batches} "
          f"batches")
    check(len(trans) == 3 and bool(np.all(np.isfinite(trans + rot))),
          f"dator cli: poses not finite: {trans}, {rot}")
    log(f"dator phase done in {time.perf_counter() - t0:.1f} s")
    return launches + cli_launches


# phase 12 (a): the JAX CLI test's translation gate (tests/test_clip_loc.py)
CLIP_LOC_TRANS_MAX = 1.5


def write_clip_text_checkpoint(path: str, seed: int = 0) -> None:
    """A random CLIP text tower at ClipTextConfig()'s width (512 wide, 12
    layers, 77 tokens) in the HF CLIPTextModelWithProjection layout, as
    `--clip-text-checkpoint` takes it (the card has no transformers)."""
    import torch
    from instance_based_loc_tpu_torch.models.clip_text import ClipTextConfig
    c = ClipTextConfig()
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, std):
        return std * torch.randn(shape, generator=gen)

    e, m = c.hidden_size, c.mlp_dim
    sd = {"text_model.embeddings.token_embedding.weight":
          normal(c.vocab_size, e, std=0.02),
          "text_model.embeddings.position_embedding.weight":
          normal(c.max_length, e, std=0.01),
          "text_projection.weight": normal(c.projection_dim, e, std=e ** -0.5)}
    for name in ("final_layer_norm",) + tuple(
            f"encoder.layers.{i}.layer_norm{j}"
            for i in range(c.num_layers) for j in (1, 2)):
        sd[f"text_model.{name}.weight"] = torch.ones(e)
        sd[f"text_model.{name}.bias"] = torch.zeros(e)
    for i in range(c.num_layers):
        for name, (n_out, n_in) in (
                ("self_attn.q_proj", (e, e)), ("self_attn.k_proj", (e, e)),
                ("self_attn.v_proj", (e, e)), ("self_attn.out_proj", (e, e)),
                ("mlp.fc1", (m, e)), ("mlp.fc2", (e, m))):
            pre = f"text_model.encoder.layers.{i}.{name}"
            sd[pre + ".weight"] = normal(n_out, n_in, std=n_in ** -0.5)
            sd[pre + ".bias"] = torch.zeros(n_out)
    torch.save(sd, path)


@contextlib.contextmanager
def recording_clip_loc():
    """Records each clip_loc conversion's ObjectMemory and result, and (ms,
    RANSAC samples) of each `localize`, the card synchronised."""
    import torch
    from instance_based_loc_tpu_torch.memory.clip_loc import (
        ClipLocObjectMemory as C)
    seen = {"memories": [], "converted": [], "calls": []}
    convert, localize = C.__dict__["from_object_memory"], C.localize

    def converting(object_memory, *args, **kwargs):
        seen["memories"].append(object_memory)
        seen["converted"].append(convert.__func__(object_memory, *args,
                                                  **kwargs))
        return seen["converted"][-1]

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = localize(self, *args, **kwargs)
        torch.cuda.synchronize()
        seen["calls"].append(((time.perf_counter() - t0) * 1e3,
                              self.ransac_samples))
        return out
    C.from_object_memory, C.localize = staticmethod(converting), timed
    try:
        yield seen
    finally:
        C.from_object_memory, C.localize = convert, localize


def phase_clip_loc(workdir):
    """The clip_loc CLI on phase 9 (b)'s TUM dataset, weights-free and with
    the CLIP embedder and text tower; the ViT kernel at CLIP-B/32's shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from instance_based_loc_tpu_torch.cli import clip_loc_trial as ct
    from instance_based_loc_tpu_torch.cli import localisation_trial as lt
    from instance_based_loc_tpu_torch.data.synthetic import default_scene
    from instance_based_loc_tpu_torch.memory import ColorRegionDetector
    from instance_based_loc_tpu_torch.memory.clip_loc import (
        ClipLocObjectMemory)
    from instance_based_loc_tpu_torch.ops import attention
    t0 = time.perf_counter()
    scene = default_scene(num_objects=9, seed=3)

    def run(tag, *flags):
        args = lt.apply_convention_defaults(ct.make_clip_loc_parser()
                                            .parse_args([
            "--convention", "tum", "--data-path", f"{workdir}/tum",
            "--detector", "depth", "-e", "6", "7", "8", "--consider-floor",
            "--min-points", "200", "--no-outlier-removal",
            "--focal-length", "525", "--sampling-period", "1",
            "--downsample-voxel-size", "0.02", "--dbscan-eps", "0.1",
            "--dbscan-min-points", "40",
            "--clip-loc-save-path", f"{workdir}/clip_loc_{tag}",
            "--out-dir", f"{workdir}/clip_out",
            "--testname", f"tum_clip_loc_{tag}", "--quiet", *flags]))
        query = ColorRegionDetector(min_area=500,
                                    floor_colors=[scene.floor_color])
        t1 = time.perf_counter()
        with recording_clip_loc() as seen, working_directory(workdir):
            trans, rot = ct.main(args, query_detector=query)
        torch.cuda.synchronize()
        ms = [round(c[0], 1) for c in seen["calls"]]
        log(f"clip_loc ({tag}): run {time.perf_counter() - t1:.1f} s; views "
            f"6-8 translation errors {np.round(trans, 4).tolist()}, "
            f"rotation errors {np.round(rot, 4).tolist()}; localize "
            f"{ms} ms, RANSAC samples {[c[1] for c in seen['calls']]}")
        check(len(trans) == 3 and bool(np.all(np.isfinite(trans + rot))),
              f"clip_loc ({tag}): poses not finite: {trans}, {rot}")
        return trans, seen["memories"][-1], seen["converted"][-1]

    # (a) weights-free
    trans, memory, converted = run("color", "--embeddings", "color")
    check(max(trans) < CLIP_LOC_TRANS_MAX,
          f"clip_loc (color): translation errors {trans} past "
          f"{CLIP_LOC_TRANS_MAX} m")
    loaded = ClipLocObjectMemory.load(f"{workdir}/clip_loc_color",
                                      log_enabled=False)
    check(len(loaded) == len(converted) > 0 and all(
        a.text == b.text and np.array_equal(a.points, b.points)
        and np.array_equal(a.ellipsoid_lengths, b.ellipsoid_lengths)
        for a, b in zip(loaded.memory, converted.memory)),
          "clip_loc (color): the pkl does not read back")
    log(f"clip_loc (color): memory of {len(memory.memory)} objects -> "
        f"{len(converted)} clip_loc objects; the pkl reads back")

    # (b) CLIP ViT-B/32 crops against CLIP text embeddings of the names
    text_ckpt = f"{workdir}/clip_text.bin"
    write_clip_text_checkpoint(text_ckpt)
    # the main path: the count from zero just before, read just after
    attention.launches = 0
    _, memory, _ = run("clip", "--embeddings", "clip",
                       "--clip-text-checkpoint", text_ckpt)
    launches, batches = attention.launches, memory.get_embeddings_func.batches
    cfg = memory.get_embeddings_func.model.cfg
    log(f"clip_loc (clip): vit_attention launches {launches} over {batches} "
        f"crop batches ({cfg.num_layers} per batch expected)")
    check((cfg.hidden_size, cfg.num_layers, cfg.patch_size, cfg.projection_dim,
           cfg.dtype) == (768, 12, 32, 512, torch.bfloat16),
          f"clip_loc (clip): not the full-width bf16 CLIP ViT-B/32: {cfg}")
    check(batches > 0 and launches == cfg.num_layers * batches,
          f"clip_loc (clip): {launches} kernel launches for {batches} "
          f"batches")

    # (c) the kernel at CLIP-B/32's shape: 16 crops, 12 heads, 50 tokens
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (16, 12, cfg.num_patches + 1, cfg.hidden_size // cfg.num_heads)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out = attention.vit_attention(q, k, v)
    torch.cuda.synchronize()
    ref = attention.vit_attention_reference(q, k, v).float()
    diff = (out.float() - ref).abs()
    err = diff.max().item()
    atol, rtol = 1e-4, 2 ** -7                 # phase 2's bf16 tolerance
    log(f"clip_loc: kernel {shape} bf16: max|diff| {err:.3g}, max|ref| "
        f"{ref.abs().max().item():.3g} (tolerance {atol} + {rtol:.3g} |ref|)")
    check((diff - atol - rtol * ref.abs()).max().item() <= 0,
          f"clip_loc: kernel disagrees at {shape}: max|diff| {err}")
    kernel_ms = device_ms(lambda: attention.vit_attention(q, k, v),
                          "vit_attention")
    call_ms = time_ms(lambda: attention.vit_attention(q, k, v))
    plain_ms = time_ms(lambda: attention.vit_attention_reference(q, k, v))
    sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    b, h, n, d = shape
    bound_ms, bound_by = bound(4 * b * h * n * d * 2, 4 * b * h * n * n * d,
                               H100_BF16_FLOP_PER_S)
    log(f"clip_loc: kernel timing at {shape} bf16: kernel {kernel_ms:.4f} ms "
        f"on the device ({call_ms:.4f} ms per back-to-back call), plain "
        f"{plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms on the device, bound "
        f"{bound_ms * 1e3:.2f} us by {bound_by} "
        f"({4 * b * h * n * d * 2 / 1e6:.2f} MB, "
        f"{4 * b * h * n * n * d / 1e9:.3f} GFLOP)")
    log(f"clip_loc phase done in {time.perf_counter() - t0:.1f} s")
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
        color_memory = phase_color(scene_data, workdir)
    kernel["launches"] = phase_dino(scene_data)
    sam = phase_sam_kernel()
    msda = phase_msda_kernel()
    frames, poses = e2e_frames()
    with tempfile.TemporaryDirectory() as workdir:
        sam["launches"], msda["launches"], cascade = phase_cascade(
            workdir, frames, poses)
        phase_cascade_vs_cpu(workdir, frames)
    t9 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        phase_cli_synth(workdir)
        kernel["launches"] += phase_cli_tum(workdir)
        cli_sam, cli_msda = phase_cli_cascade(workdir, cascade)
        sam["launches"] += cli_sam
        msda["launches"] += cli_msda
        log(f"cli phase done in {time.perf_counter() - t9:.1f} s")
        phase_serve(color_memory, scene_data)
        kernel["launches"] += phase_dator(workdir, scene_data)
        kernel["launches"] += phase_clip_loc(workdir)
    log(f"all phases passed in {time.perf_counter() - T_START:.1f} s")

    print(card, flush=True)
    print(json.dumps({"kernels": [kernel, sam, msda]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
