"""Whether the query program's reductions and matmuls give the same bits
when a leading query axis is added: each case computes one of the
program's operations at the bench scene's shapes once over G queries at
once (vectorised) and once per query, on the same inputs, and prints the
largest difference and whether the results are bitwise equal.

On the CPU every case is bitwise equal. On a card a reduction's or a
batched matmul's summation order can follow the batch size (the number of
outputs decides how the work is split), and registration amplifies a
last-bit difference: a normal's orientation, RANSAC's pick and ICP's
basin follow from it. That is why `localise_frames_batched` runs each
query's own program rather than one vectorised over the query axis.

    python3 perf/torch_batch_invariance.py --device cuda --batch 6
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=6)
    args = p.parse_args()

    import torch
    from instance_based_loc_tpu_torch.ops.icp import evaluate_transform_arrays
    from instance_based_loc_tpu_torch.ops.kabsch import kabsch_solve
    from instance_based_loc_tpu_torch.ops.normals import estimate_normals
    from instance_based_loc_tpu_torch.ops.pointcloud import masked_mean

    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    g_n = args.batch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rand_mask(*shape):
        return torch.rand(shape, generator=gen, device=dev) < 0.3

    pts = 3.0 * randn(g_n, 480 * 640, 3)          # a frame's backprojection
    masks = rand_mask(g_n, 7, 480 * 640)          # top_n = 7 detections
    src, tgt = randn(g_n, 8, 1024, 3), randn(g_n, 8, 1024, 3)   # A = 8 lanes
    w = torch.rand((g_n, 8, 1024), generator=gen, device=dev)
    smsk, tmsk = rand_mask(g_n, 8, 1024), rand_mask(g_n, 8, 1024)
    T = torch.eye(4, device=dev).expand(g_n, 8, 4, 4).contiguous()
    fpts = 0.2 * randn(g_n, 8, 256, 3)
    fmsk = rand_mask(g_n, 8, 256) | True
    cases = {
        "masked_mean over a frame's 307200 points (detection centroids)":
            lambda s: masked_mean(pts[s][:, None], masks[s]),
        "kabsch_solve, fp32, 1024 weighted pairs per lane (an ICP step)":
            lambda s: kabsch_solve(src[s], tgt[s], weights=w[s]),
        "evaluate_transform_arrays, 1024 x 1024 (rmse and fitness)":
            lambda s: torch.stack(evaluate_transform_arrays(
                src[s], smsk[s], tgt[s], tmsk[s], T[s], 0.5), dim=-1),
        "estimate_normals, 256 points, 30 neighbours":
            lambda s: estimate_normals(fpts[s], fmsk[s], 0.1, max_nn=30),
    }
    for name, fn in cases.items():
        batched = fn(slice(None))
        per_query = torch.cat([fn(slice(g, g + 1)) for g in range(g_n)])
        diff = (batched.double() - per_query.double()).abs().max().item()
        print(f"{args.device}, G = {g_n}: {name}: max |vectorised - per "
              f"query| {diff:.3g}, bitwise {torch.equal(batched, per_query)}",
              flush=True)


if __name__ == "__main__":
    main()
