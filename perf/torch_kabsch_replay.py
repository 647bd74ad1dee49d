"""The synthetic trial CLI with the port's Kabsch solves in a chosen
precision.

As shipped, the port solves Kabsch in float64 for RANSAC's hypotheses and
the centroid init (`ops/kabsch.py:kabsch_transform`) and in fp32 in each
ICP step (`kabsch_solve`, the reference's arithmetic). This runs
`cli/synth_localisation_trial.py` with the flags given, as shipped
(`--kabsch shipped`), with all three solves in float64 (`--kabsch
float64`) or all in fp32 (`--kabsch fp32`), so the choices can be compared
pose by pose on one card, e.g. on the 86-pose replay:

    python3 perf/torch_kabsch_replay.py --kabsch fp32 -- --num-objects 12 \\
        --n-views 172 --eval-every 2 --testname synth_86pose_fp32 \\
        --out-dir replay

Prints one JSON line: the precision, successes, poses and wall seconds.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from instance_based_loc_tpu_torch.cli import synth_localisation_trial  # noqa: E402
from instance_based_loc_tpu_torch.ops import (  # noqa: E402
    icp, kabsch, localise_kernels, ransac)
from instance_based_loc_tpu_torch.utils.metrics import is_success  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--kabsch", choices=["shipped", "float64", "fp32"],
                   required=True)
    p.add_argument("cli_args", nargs=argparse.REMAINDER,
                   help="after --: the synth trial CLI's flags")
    args = p.parse_args()
    cli_args = [a for a in args.cli_args if a != "--"]
    if args.kabsch == "float64":
        icp.kabsch_solve = kabsch.kabsch_transform
    elif args.kabsch == "fp32":
        for module in (ransac, localise_kernels):
            module.kabsch_transform = kabsch.kabsch_solve
    t0 = time.perf_counter()
    trans, rot = synth_localisation_trial.main(cli_args)
    ok = sum(is_success(t, r) for t, r in zip(trans, rot))
    print(json.dumps({"kabsch": args.kabsch, "successes": ok,
                      "poses": len(trans),
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
