"""Device times of the port's MSDA level-gather kernel on the card at
GroundingDINO@800's level 0 with encoder queries (Q 13294, S 100 x 100,
H 8, D 32, bf16 values), taps spilling outside the map, for K = 2, 4 and 8
sampling points (T = 8, 16, 32 taps), K = 4 first, so that its inputs
and allocations are the same in every tree. A tree whose kernel takes
only K = 4 reports only that. Each time is the mean device time of the kernel
from torch.profiler (`chip_smoke.device_ms`) over `--windows` windows of
50 calls. Prints one JSON line.

`--root DIR` imports `instance_based_loc_tpu_torch` from DIR instead of this
repository, so that two trees can be compared in one chip call, in turns:

    python perf/torch_gather_timing.py --root path/to/older/tree --label before
    python perf/torch_gather_timing.py --label after
"""

import argparse
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import device_ms  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--windows", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from instance_based_loc_tpu_torch.ops import msda, msda_gather as mg
    assert mg.__file__.startswith(os.path.abspath(args.root))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    result = {"label": args.label, "card": card}
    hh = ww = 100
    heads, d, q = 8, 32, 13294
    for k in (4, 2, 8):             # K = 4 first: the same history in any tree
        gen = torch.Generator(device="cuda").manual_seed(k)
        vmap = torch.randn((hh * ww, heads, d), generator=gen,
                           device="cuda").to(torch.bfloat16)
        loc = torch.rand((q, heads, k, 2), generator=gen,
                         device="cuda") * 1.1 - 0.05
        w = torch.softmax(torch.randn((q, heads, k), generator=gen,
                                      device="cuda"), dim=-1)
        lin, coeff = msda._level_rows(loc, w, hh, ww)
        try:
            mg.msda_level_gather(vmap, lin, coeff)
        except ValueError:
            continue                # the tree's kernel takes only K = 4
        result[f"k{k}_device_ms"] = [
            device_ms(lambda: mg.msda_level_gather(vmap, lin, coeff),
                      "msda_gather") for _ in range(args.windows)]
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
