"""Where one frame of the PyTorch port's perception cascade spends its time
on the card.

Builds chip_smoke.py's phase-7 cascade (GroundingDINO with Swin-B, BERT-base,
900 queries, 6 + 6 layers at 800 px -> SAM-H at 1024 px; seeded random
weights, bf16, no RAM checkpoint) and tests/test_neural_e2e.py's scene
(4 objects, 240x320, focal 200), warms up on view 0, then profiles
`CascadeDetector.find` on view 2 with torch.profiler. Prints: host wall
time, the summed device time of its kernels, the device's idle share
(1 - device time / wall time), the number of kernel launches and memory
copies, the hand-written kernels' launches and device time, and the kernels
that take the most device time.

Run on a machine with a CUDA card, from the repository root:
    python3 perf/torch_cascade_profile.py
"""

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_cascade_profile: needs a CUDA card")
    import chip_smoke
    from instance_based_loc_tpu_torch.models.cascade import (
        build_cascade_detector)
    from instance_based_loc_tpu_torch.models.gdino import GDinoConfig
    from instance_based_loc_tpu_torch.models.sam import SamConfig

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    frames, _ = chip_smoke.e2e_frames()
    with tempfile.TemporaryDirectory() as workdir:
        cascade = build_cascade_detector(
            gdino_vocab=chip_smoke.write_vocab(workdir), random_init=True,
            sam_cfg=SamConfig(), gdino_cfg=GDinoConfig(),
            compute_dtype="bfloat16", device="cuda")
    cascade.find(frames[0][0], True)                    # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det = cascade.find(frames[2][0], True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        sys.exit("torch_cascade_profile: the profiler recorded no device "
                 "events")
    kernels = [e for e in events if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    copies = [e for e in events if "memcpy" in e.name.lower()]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    print(f"one cascade frame ({len(det)} detections): wall {wall_ms:.2f} "
          f"ms, device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {len(kernels)} kernel launches, "
          f"{len(copies)} memory copies", flush=True)
    by_name: dict = {}
    for e in kernels:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    for mine in ("sam_attention_mma", "msda_gather"):
        tot = sum(v[0] for k, v in by_name.items() if mine in k)
        cnt = sum(v[1] for k, v in by_name.items() if mine in k)
        print(f"hand-written kernel {mine}: {cnt} launches, {tot / 1e3:.3f} "
              f"ms", flush=True)
    print("top kernels by device time (us, launches):", flush=True)
    for name, (tot, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:15]:
        print(f"  {tot:10.1f} us {cnt:6d}x  {name[:90]}", flush=True)


if __name__ == "__main__":
    main()
