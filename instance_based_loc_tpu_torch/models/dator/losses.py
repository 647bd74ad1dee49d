"""ReID losses (counterpart of `instance_based_loc_tpu/models/dator/losses.py`,
reference `dator/loss/`): cross-entropy with optional label smoothing, the
batch-hard soft-margin triplet loss, the margin-classifier family (Arcface,
Cosface, AMSoftmax, CircleLoss: cosine logits with a margin at the target
class, scaled by s) and center loss. All batched torch in fp32.

The hardest positive and negative are `torch.amax` / `torch.amin`, whose
gradient is split evenly among tied entries, as `jnp.max` / `jnp.min` split
it; `max(dim)` would route it to one index. Ties occur: `PKSampler` pads an
identity with fewer than K samples by resampling, so a batch can hold one
image twice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / num_classes
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def euclidean_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Clamped sqrt pairwise distances (triplet_loss.py:16-31)."""
    xx = torch.sum(x * x, dim=1)[:, None]
    yy = torch.sum(y * y, dim=1)[None, :]
    d2 = xx + yy - 2.0 * (x @ y.T)
    return torch.sqrt(torch.clamp(d2, min=1e-12))


def batch_hard_triplet(features: torch.Tensor, labels: torch.Tensor,
                       margin: float | None = None,
                       normalize_feature: bool = False) -> torch.Tensor:
    """Hardest-positive / hardest-negative triplet loss
    (triplet_loss.py:51-150); margin=None gives the soft margin
    softplus(d_ap - d_an)."""
    if normalize_feature:
        features = features / (torch.linalg.norm(features, dim=-1,
                                                 keepdim=True) + 1e-12)
    dist = euclidean_dist(features, features)
    same = labels[:, None] == labels[None, :]
    big = torch.tensor(1e12, dtype=dist.dtype, device=dist.device)
    dist_ap = torch.amax(torch.where(same, dist, -big), dim=1)
    dist_an = torch.amin(torch.where(same, big, dist), dim=1)
    if margin is None:
        return torch.mean(F.softplus(dist_ap - dist_an))
    return torch.mean(torch.clamp(dist_ap - dist_an + margin, min=0.0))


def _cosine_logits(features: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """cos(theta) between L2-normalised features and class weights; weight
    is (num_classes, feat)."""
    f = features / torch.clamp(torch.linalg.norm(features, dim=-1,
                                                 keepdim=True), min=1e-12)
    w = weight / torch.clamp(torch.linalg.norm(weight, dim=-1, keepdim=True),
                             min=1e-12)
    return f @ w.T


def _onehot(labels: torch.Tensor, num_classes: int, like: torch.Tensor):
    return F.one_hot(labels.long(), num_classes).to(like.dtype)


def arcface_logits(features, weight, labels, s: float = 30.0, m: float = 0.50,
                   easy_margin: bool = False, ls_eps: float = 0.0):
    """Additive-angular-margin logits: the target class gets
    s cos(theta + m), with the th / mm fallback past pi."""
    cos = _cosine_logits(features, weight)
    sin = torch.sqrt(torch.clamp(1.0 - cos * cos, 0.0, 1.0))
    phi = cos * math.cos(m) - sin * math.sin(m)
    if easy_margin:
        phi = torch.where(cos > 0, phi, cos)
    else:
        th = math.cos(math.pi - m)
        mm = math.sin(math.pi - m) * m
        phi = torch.where(cos > th, phi, cos - mm)
    onehot = _onehot(labels, weight.shape[0], cos)
    if ls_eps > 0:
        onehot = onehot * (1 - ls_eps) + ls_eps / weight.shape[0]
    return s * (onehot * phi + (1.0 - onehot) * cos)


def cosface_logits(features, weight, labels, s: float = 30.0, m: float = 0.30):
    """Additive-cosine-margin logits: the target class gets
    s (cos(theta) - m). AMSoftmax is the same function."""
    cos = _cosine_logits(features, weight)
    return s * (cos - _onehot(labels, weight.shape[0], cos) * m)


am_softmax_logits = cosface_logits


def circle_logits(features, weight, labels, s: float = 256.0, m: float = 0.25):
    """CircleLoss logits: adaptive weights alpha_p / alpha_n on the
    similarity without its gradient, optima 1 - m and m."""
    sim = _cosine_logits(features, weight)
    sim_d = sim.detach()
    alpha_p = torch.clamp(-sim_d + 1 + m, min=0.0)
    alpha_n = torch.clamp(sim_d + m, min=0.0)
    s_p = s * alpha_p * (sim - (1 - m))
    s_n = s * alpha_n * (sim - m)
    onehot = _onehot(labels, weight.shape[0], sim)
    return onehot * s_p + (1.0 - onehot) * s_n


MARGIN_HEADS = {"arcface": arcface_logits, "cosface": cosface_logits,
                "amsoftmax": am_softmax_logits, "circle": circle_logits}


def margin_logits(kind: str, features, weight, labels, **kwargs):
    """Dispatch over the reference's cfg.MODEL.ID_LOSS_TYPE options."""
    if kind not in MARGIN_HEADS:
        raise ValueError(f"unknown margin head {kind!r}; "
                         f"options: {sorted(MARGIN_HEADS)}")
    return MARGIN_HEADS[kind](features, weight, labels, **kwargs)


def center_loss(features: torch.Tensor, labels: torch.Tensor,
                centers: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of each feature to its class centre
    (loss/center_loss.py:36-53, clamp kept)."""
    diff2 = torch.sum((features - centers[labels.long()]) ** 2, dim=1)
    return torch.mean(torch.clamp(diff2, 1e-12, 1e12))


def reid_loss(cls_score, features, labels, id_weight: float = 1.0,
              triplet_weight: float = 1.0, label_smoothing: float = 0.0,
              triplet_margin: float | None = None):
    """CE + triplet (loss/make_loss.py:41-93 softmax_triplet); returns
    (total, {"id_loss", "triplet_loss"})."""
    id_loss = cross_entropy(cls_score, labels, label_smoothing)
    tri_loss = batch_hard_triplet(features, labels, margin=triplet_margin)
    total = id_weight * id_loss + triplet_weight * tri_loss
    return total, {"id_loss": id_loss, "triplet_loss": tri_loss}
