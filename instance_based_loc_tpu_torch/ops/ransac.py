"""Feature-matching RANSAC for coarse registration (counterpart of
`instance_based_loc_tpu/ops/ransac.py`; replaces Open3D's
`registration_ransac_based_on_feature_matching` with mutual filtering,
point-to-point estimation over 3 samples, the 0.9 edge-length checker and
the distance checker).

A fixed batch of hypotheses is drawn and scored all at once: nearest
neighbours in FPFH space give the correspondences, each hypothesis solves a
3-pair Kabsch, the checkers mask bad ones, and the best is picked by inlier
count, then rmse. Batched over leading dimensions.
"""

from __future__ import annotations

import torch

from .distance import f32_sq, masked_nearest
from .kabsch import apply_transform, kabsch_transform
from .pointcloud import gather_rows, gather_values


def feature_correspondences(feat_src, mask_src, feat_tgt, mask_tgt,
                            mutual: bool = True):
    """(idx_tgt (..., N), valid (..., N)): each source point's nearest
    target in feature space; with mutual filtering only mutual pairs."""
    idx_st, _ = masked_nearest(feat_src, feat_tgt, mask_tgt)
    valid = mask_src
    if mutual:
        idx_ts, _ = masked_nearest(feat_tgt, feat_src, mask_src)
        n = feat_src.shape[-2]
        valid = valid & (gather_values(idx_ts, idx_st)
                         == torch.arange(n, device=idx_st.device))
    return idx_st, valid


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (*lead, H, *rest), idx (*lead,) -> x[..., idx, ...] (*lead, *rest)."""
    dim = idx.dim()
    rest = x.shape[dim + 1:]
    ix = idx.reshape(idx.shape + (1,) * (1 + len(rest)))
    ix = ix.expand(idx.shape + (1,) + rest)
    return torch.gather(x, dim, ix).squeeze(dim)


def draw_samples(corr_valid: torch.Tensor, num_hypotheses: int, ransac_n: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Sample indices (..., H, ransac_n), with replacement and in proportion
    to validity (the reference's `jax.random.choice(..., p=valid)`). A set
    with no valid correspondence samples uniformly; every such hypothesis
    then fails the validity check."""
    probs = corr_valid.to(torch.float32)
    n = probs.shape[-1]
    probs = probs.reshape(-1, n)
    probs = torch.where(probs.sum(-1, keepdim=True) > 0, probs,
                        torch.ones_like(probs))
    samples = torch.multinomial(probs, num_hypotheses * ransac_n,
                                replacement=True, generator=generator)
    return samples.reshape(corr_valid.shape[:-1] + (num_hypotheses, ransac_n))


def ransac_registration(src_pts, src_mask, tgt_pts, corr_idx, corr_valid,
                        distance_threshold: float,
                        generator: torch.Generator | None = None,
                        num_hypotheses: int = 4096, ransac_n: int = 3,
                        edge_length_ratio: float = 0.9,
                        samples: torch.Tensor | None = None):
    """Returns (T (..., 4, 4), fitness (...), inlier_rmse (...)) over the
    correspondence set. `samples` (..., H, ransac_n) replaces the random
    draw, so a test can feed in the reference's draws."""
    thr2 = f32_sq(distance_threshold)
    if samples is None:
        samples = draw_samples(corr_valid, num_hypotheses, ransac_n,
                               generator)
    s = gather_rows(src_pts, samples)                        # (..., H, n, 3)
    t = gather_rows(tgt_pts, gather_values(corr_idx, samples))

    def edge_ok(a, b):
        ea = torch.linalg.norm(a - torch.roll(a, 1, dims=-2), dim=-1)
        eb = torch.linalg.norm(b - torch.roll(b, 1, dims=-2), dim=-1)
        lo, hi = torch.minimum(ea, eb), torch.maximum(ea, eb)
        return torch.all((lo > edge_length_ratio * hi) & (hi > 1e-9), dim=-1)

    sample_valid = (torch.all(gather_values(corr_valid, samples), dim=-1)
                    & edge_ok(s, t))
    transforms = kabsch_transform(s, t)                      # (..., H, 4, 4)
    s_tf = apply_transform(s, transforms)
    pair_ok = torch.all(torch.sum((s_tf - t) ** 2, dim=-1) <= thr2, dim=-1)
    sample_valid = sample_valid & pair_ok

    # score every hypothesis over the full correspondence set
    corr_tgt = gather_rows(tgt_pts, corr_idx)                # (..., N, 3)
    moved = apply_transform(src_pts[..., None, :, :], transforms)
    d2 = torch.sum((moved - corr_tgt[..., None, :, :]) ** 2, dim=-1)
    inlier = (d2 <= thr2) & corr_valid[..., None, :]
    counts = torch.sum(inlier.to(torch.float32), dim=-1)     # (..., H)
    rmses = torch.sqrt(torch.sum(torch.where(inlier, d2, torch.zeros_like(d2)),
                                 dim=-1) / torch.clamp(counts, min=1.0))
    counts = torch.where(sample_valid, counts, torch.full_like(counts, -1.0))
    # maximise count; tie-break on rmse
    rank = counts - rmses / (torch.amax(rmses, dim=-1, keepdim=True) + 1.0)
    best = torch.argmax(rank, dim=-1)
    T = _take(transforms, best)
    n_corr = torch.clamp(torch.sum(corr_valid.to(torch.float32), dim=-1),
                         min=1.0)
    fitness = torch.clamp(_take(counts, best), min=0.0) / n_corr
    none_valid = torch.amax(counts, dim=-1) < 0
    eye = torch.eye(4, dtype=T.dtype, device=T.device).expand_as(T)
    T = torch.where(none_valid[..., None, None], eye, T)
    return T, fitness, _take(rmses, best)
