"""Times of the port's two attention kernels on the card, beside SDPA
(`torch.nn.functional.scaled_dot_product_attention`, a yardstick the port
never calls), at the shapes of the main path:

* ViT attention at the DINOv2-base embedder's (16, 12, 257, 64), bf16;
* SAM attention at SAM-H (1, 16, 4096, 80), SAM-B (1, 12, 4096, 64) and a
  48x48 grid at SAM-H width (the general bias path), bf16; SDPA gets the
  expanded (S, S) bias as its mask.

For each: the mean device time of the call's kernels from torch.profiler
(`chip_smoke.device_ms`), the time per call from CUDA events over
back-to-back calls (`chip_smoke.time_ms`; for a kernel shorter than its
wrapper's launch, that is the host's time), and the host time per call.
Prints one JSON line.

`--root DIR` imports `instance_based_loc_tpu_torch` from DIR instead of this
repository, so that two trees can be compared in one chip call:

    python perf/torch_attention_timing.py --root path/to/older/tree --label before
    python perf/torch_attention_timing.py --label after
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import device_ms, time_ms  # noqa: E402


def host_us(fn, iters=200):
    """Host time per call, the card synchronised only at the ends."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def measure(fn):
    return {"device_ms": device_ms(fn), "events_ms": time_ms(fn),
            "host_us": host_us(fn)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from instance_based_loc_tpu_torch.ops import attention
    from instance_based_loc_tpu_torch.ops import sam_attention as sa
    assert attention.__file__.startswith(os.path.abspath(args.root))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"label": args.label, "card": card}

    q, k, v = (torch.randn((16, 12, 257, 64), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    result["vit"] = measure(lambda: attention.vit_attention(q, k, v))
    result["vit_sdpa"] = measure(
        lambda: F.scaled_dot_product_attention(q, k, v))

    for name, (b, h, hk, wk, d) in (("sam_h", (1, 16, 64, 64, 80)),
                                    ("sam_b", (1, 12, 64, 64, 64)),
                                    ("sam_48x48", (1, 16, 48, 48, 80))):
        s = hk * wk
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        bias_h, bias_w = (
            (0.3 * torch.randn((b, h, s, n), generator=gen, device="cuda"))
            .to(torch.bfloat16) for n in (hk, wk))
        result[name] = measure(
            lambda: sa.sam_attention(q, k, v, bias_h, bias_w))
        mask = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(
            b, h, s, s)
        result[name + "_sdpa"] = measure(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        del mask
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
