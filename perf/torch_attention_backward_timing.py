"""Device times of the ViT attention's backward kernels, the forward kernel
and SDPA's backward (`scaled_dot_product_attention` under autograd, a
yardstick the port never calls), on the card, at the training batch
(128 x 12 heads, D = 64, bf16) over head lengths S. The two passes run at
every S (forced where the fused kernel would take it), the fused kernel
at S <= S_max (attention.FUSED_MAX_S, 144):

* 128: whole 64-row tiles only;
* 129: the DATOR towers' length, one query row and one key past the last
  tile (in the two passes the producer warpgroup's fp32 path; in the fused
  kernel a third row tile and 16 tail keys);
* 136: eight rows and keys past the tiles;
* 144: a remainder of 16, S_max;
* 192 / 193 and 257 (DINOv2-base's length): the two passes only.

Each time is the mean device time of one kernel (or, for SDPA, of every
kernel its backward launches) from torch.profiler (`chip_smoke.device_ms`).
Prints one JSON line with the card's name and power limit:

    python perf/torch_attention_backward_timing.py
"""

import json
import os
import sys

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import device_ms, gpu_name_and_power_limit  # noqa: E402

LENGTHS = (128, 129, 136, 144, 192, 193, 257)


def main():
    from instance_based_loc_tpu_torch.ops import attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": gpu_name_and_power_limit()}
    for s in LENGTHS:
        q, k, v, g = (torch.randn((128, 12, s, 64), generator=gen,
                                  device="cuda").to(torch.bfloat16)
                      for _ in range(4))

        def two_pass():
            attention._attention_backward(q, k, v, g, None, kernel="two_pass")

        def fused():
            attention._attention_backward(q, k, v, g, None, kernel="fused")

        sq, sk, sv = (x.clone().requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(sq, sk, sv)
        row = result[f"S={s}"] = {
            "forward_ms": device_ms(lambda: attention.vit_attention(q, k, v),
                                    "vit_attention_wgmma"),
            "dq_ms": device_ms(two_pass, "vit_attention_bwd_dq"),
            "dkdv_ms": device_ms(two_pass, "vit_attention_bwd_dkdv"),
            "sdpa_backward_ms": device_ms(lambda: torch.autograd.grad(
                out, (sq, sk, sv), g, retain_graph=True)),
        }
        if s <= attention.FUSED_MAX_S:
            row["fused_ms"] = device_ms(fused, "vit_attention_bwd_fused")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
