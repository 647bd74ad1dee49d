"""One DATOR training step on the card, as `chip_smoke.py` phase 13 (d)
runs it: the full-width FourDNet (two ViT-B/16 towers at 256x128, bf16,
LoRA-only, BNNeck, aux heads, Adam), batch 64 = 16 identities x 4, on
random crops made from a seed. Measures ms per step (CUDA events over
steps 5-19 of 20), then one step under torch.profiler: its wall and
device-busy ms, launch calls and device kernels, and the attention
backward kernels' launches a step. Prints one JSON line with the card's
name and power limit.

`--root` runs the package and `chip_smoke.py` of another checkout of the
repository (an older tree unpacked with `git archive`), so that two trees
can be timed in turns in one process each on one card:

    python perf/torch_dator_step_timing.py [--root TREE] [--label NAME]
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import chip_smoke
    from instance_based_loc_tpu_torch.models.dator import train
    from instance_based_loc_tpu_torch.ops import attention

    rng = np.random.default_rng(1)
    rgb = torch.as_tensor(rng.integers(0, 256, (64, 256, 128, 3))
                          .astype(np.uint8)).cuda()
    depth = torch.as_tensor(rng.integers(0, 65536, (64, 256, 128))
                            .astype(np.int32)).cuda()
    pids = torch.arange(16).repeat_interleave(4).cuda()
    tcfg = train.TrainConfig(optimizer="adam", base_lr=1e-3,
                             warmup_epochs=0, epochs=1, steps_per_epoch=20)
    mcfg = chip_smoke.full_width_dator(32, torch.bfloat16)
    state = train.create_train_state(mcfg, tcfg, seed=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def one_step():
        train.train_step(state, rgb, depth, pids,
                         train.make_step_draws(gen, 64, True, False))

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(20):
        if i == 5:
            start.record()
        one_step()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 15
    before = attention.backward_launches
    one_step()
    torch.cuda.synchronize()
    backward = attention.backward_launches - before
    wall_ms, busy_ms, host_calls, kernels = chip_smoke.profile_chunk(one_step)
    print(json.dumps({
        "label": args.label, "card": chip_smoke.gpu_name_and_power_limit(),
        "step_ms": step_ms, "samples_per_s": 64e3 / step_ms,
        "profiled_wall_ms": wall_ms, "busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms, "launch_calls": host_calls,
        "device_kernels": kernels, "backward_launches": backward}),
        flush=True)


if __name__ == "__main__":
    main()
