"""Multi-scale deformable attention (MSDA), GroundingDINO's sampling op
(counterpart of `instance_based_loc_tpu/ops/msda.py`).

For each query, head and level, sample K bilinear points of that level's
value map at `sampling_locations` (normalised [0, 1], align_corners=False,
zero padding) and reduce them with the softmaxed attention weights:

    out[q, h] = sum_{l, k} w[q, h, l, k] * bilinear(value_l[..., h], loc[q, h, l, k])

Each level folds its 4 bilinear taps x K points into per-(query, head) row
indices and coefficients and sums the coefficient-weighted rows: the
contract of the JAX package's `_level_gather`, which here is the
hand-written CUDA kernel (`ops.msda_gather`) on the card for every level,
and its plain version on the CPU. (The JAX package splits levels at 4096
rows between that gather and a one-hot matrix product for the TPU's matrix
unit; both compute this function.) The coefficients stay fp32 (the Pallas
kernel's contract), so in bf16 the port differs from the JAX package, which
rounds them and the per-term products to the value type; in fp32 the two
are the same function.
"""

from __future__ import annotations

import torch

from .msda_gather import msda_level_gather


def _tap_index_weights(loc, hh: int, ww: int):
    """Bilinear taps of one level: loc (..., 2) in [0, 1] -> (yi, xi, w),
    each (..., 4), tap t = (dy, dx) = (t >> 1, t & 1); out-of-range taps
    get weight 0 and a clamped index (grid_sample zero padding,
    align_corners=False)."""
    x = loc[..., 0] * ww - 0.5
    y = loc[..., 1] * hh - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1 = (x - x0)[..., None]
    wy1 = (y - y0)[..., None]
    t = torch.arange(4, device=loc.device)
    is_x1 = (t & 1) == 1
    is_y1 = (t >> 1) == 1
    yy = y0[..., None] + is_y1.to(y0.dtype)
    xx = x0[..., None] + is_x1.to(x0.dtype)
    inside = (xx >= 0) & (xx <= ww - 1) & (yy >= 0) & (yy <= hh - 1)
    wgt = (torch.where(is_x1, wx1, 1.0 - wx1)
           * torch.where(is_y1, wy1, 1.0 - wy1)) * inside
    yi = yy.clamp(0, hh - 1).to(torch.int32)
    xi = xx.clamp(0, ww - 1).to(torch.int32)
    return yi, xi, wgt


def _level_rows(loc, attn_w, hh: int, ww: int):
    """One level's (Q, H, 4K) row indices (int32) and fp32 coefficients
    (bilinear tap weight x attention weight), point-major."""
    q, h, k, _ = loc.shape
    yi, xi, wts = _tap_index_weights(loc.float(), hh, ww)        # (Q,H,K,4)
    lin = (yi * ww + xi).reshape(q, h, 4 * k)
    coeff = (wts * attn_w.float()[..., None]).reshape(q, h, 4 * k)
    return lin, coeff


def _level_gather(vmap_l, loc, attn_w, hh: int, ww: int):
    """One level: the gather kernel on the card (its plain version on the
    CPU); K = 4 points, 16 taps.

    vmap_l (S_l, H, D); loc (Q, H, K, 2); attn_w (Q, H, K) -> (Q, H, D) fp32."""
    return msda_level_gather(vmap_l, *_level_rows(loc, attn_w, hh, ww))


def multi_scale_deformable_attention(value, spatial_shapes,
                                     sampling_locations, attention_weights):
    """value (B, S, H, D), S = sum(h * w) over `spatial_shapes`
    ((h1, w1), ...); sampling_locations (B, Q, H, L, K, 2) in [0, 1] (x, y);
    attention_weights (B, Q, H, L, K). Returns (B, Q, H * D) fp32."""
    b, s, h, d = value.shape
    q, l = sampling_locations.shape[1], sampling_locations.shape[3]
    if l != len(spatial_shapes):
        raise ValueError(f"{l} levels of sampling locations for "
                         f"{len(spatial_shapes)} spatial shapes")
    if sum(hh * ww for hh, ww in spatial_shapes) != s:
        raise ValueError(f"spatial shapes {spatial_shapes} do not cover the "
                         f"{s} value rows")
    value = value.contiguous()
    outs = []
    for bi in range(b):
        out = torch.zeros((q, h, d), dtype=torch.float32, device=value.device)
        start = 0
        for lvl, (hh, ww) in enumerate(spatial_shapes):
            vmap_l = value[bi, start:start + hh * ww]
            start += hh * ww
            out = out + _level_gather(vmap_l, sampling_locations[bi, :, :, lvl],
                                      attention_weights[bi, :, :, lvl], hh, ww)
        outs.append(out.reshape(q, h * d))
    return torch.stack(outs)
