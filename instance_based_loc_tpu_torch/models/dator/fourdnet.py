"""FourDNet, the DATOR dual-tower RGB-D fusion ReID model, for inference
(counterpart of `instance_based_loc_tpu/models/dator/fourdnet.py`,
reference `dator/model/make_model.py:424-843`):

* two TransReID towers in `local_feature` mode (RGB and depth), stacked on
  a leading tower axis as in the JAX package (`TransReIDViT(towers=2)`), so
  their attention runs as one kernel launch per block;
* global (class) and local tokens projected to `reduced_dim` and merged;
* four deformable-sampling fusion blocks, r2r / d2d (self) and d2r / r2d
  (cross): a sigmoid selector proposes m*k sample locations per token, a
  softmax head weights them, values are sampled bilinearly from the token
  map (`bilinear_sample`, grid_sample with align_corners=True) and summed,
  then a projection, a residual and a LayerNorm;
* a convolutional hypernet gives a per-patch 2-way softmax gate over the
  modalities, which gates the cross contributions and the final sum;
* the token mean is the embedding; with `bnneck` a BatchNorm (no bias)
  follows, and a bias-free classifier gives the class scores.

`forward(..., training=True)` is the training graph of the JAX module:
modality dropout from the explicit draws `modality_p` (p in {0, 2} zeroes
a sample's RGB, {1, 3} its depth), the stop-gradient of `detach_fusion`
between the towers and the fusion head, the BNNeck (and the token
bottleneck of `token_ce`) normalising with the batch's mean and biased
variance and updating its running statistics as flax does
(ra = 0.9 ra + 0.1 batch), the auxiliary class heads on the towers' class
tokens and the per-token classifier of `token_ce`.

Every parameter keeps its flax name and shape (the state-dict key is the
flax path joined by dots; BatchNorm statistics are buffers), so
`train.params_from_jax` and the npz loader map one to one. The training
heads (`aux_norm_*`, `aux_classifier_*`, and with `token_ce`
`token_bottleneck` / `token_classifier`) are registered after the served
ones, so a seeded init draws the served weights as before.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.pointcloud import gather_rows
from .transreid_vit import Dense, Norm, TransReIDConfig, TransReIDViT


@dataclasses.dataclass(frozen=True)
class FourDNetConfig:
    backbone: TransReIDConfig = dataclasses.field(
        default_factory=lambda: TransReIDConfig(local_feature=True))
    reduced_dim: int = 128
    num_classes: int = 100
    deform_m: int = 8
    deform_k: int = 3
    # training only: per-sample modality dropout p ~ U{0..4}
    modality_dropout: bool = True
    # BNNeck before the classifier (the JAX config explains why)
    bnneck: bool = True
    # training only: stop the gradient between the towers and the fusion head
    detach_fusion: bool = False
    # training only: per-token CE on the fused token map
    token_ce: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def grid_hw(self) -> tuple[int, int]:
        return self.backbone.num_y, self.backbone.num_x   # (16, 8) at 256x128/16


def bilinear_sample(value_map: torch.Tensor, gx: torch.Tensor,
                    gy: torch.Tensor) -> torch.Tensor:
    """torch's grid_sample(align_corners=True, padding_mode='zeros') as the
    JAX package computes it. value_map (..., H, W, C); gx, gy in [-1, 1] of
    shape (..., S...) with the same leading dims; returns (..., S..., C).
    gx indexes width, gy height."""
    h, w, c = value_map.shape[-3:]
    lead = value_map.shape[:-3]
    flat = value_map.reshape(lead + (h * w, c))
    x = (gx + 1.0) * 0.5 * (w - 1)
    y = (gy + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1

    def gather(yy, xx):
        inside = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
        xi = torch.clamp(xx, 0, w - 1).to(torch.int64)
        yi = torch.clamp(yy, 0, h - 1).to(torch.int64)
        vals = gather_rows(flat, yi * w + xi)
        return vals * inside[..., None]

    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    return (gather(y0, x0) * (wx0 * wy0)[..., None]
            + gather(y0, x1) * (wx1 * wy0)[..., None]
            + gather(y1, x0) * (wx0 * wy1)[..., None]
            + gather(y1, x1) * (wx1 * wy1)[..., None])


class DeformableFusionBlock(nn.Module):
    """One selector / attention / sample / projection unit
    (make_model.py:509-567)."""

    def __init__(self, cfg: FourDNetConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        mk = c.deform_m * c.deform_k
        self.selector = Dense(c.reduced_dim, 2 * mk, dtype=c.dtype)
        self.attn_weights = Dense(c.reduced_dim, mk, dtype=c.dtype)
        self.ffn = Dense(c.reduced_dim, c.reduced_dim, dtype=c.dtype)

    def forward(self, queries, value_tokens):
        c = self.cfg
        mk = c.deform_m * c.deform_k
        sel = torch.sigmoid(self.selector(queries).float())
        weights = torch.softmax(self.attn_weights(queries).float(), dim=-1)
        gx = sel[..., :mk] * 2.0 - 1.0                       # (B, N, mk)
        gy = sel[..., mk:] * 2.0 - 1.0
        h, w = c.grid_hw
        b, _, d = value_tokens.shape
        sampled = bilinear_sample(value_tokens.reshape(b, h, w, d), gx, gy)
        feat = torch.sum(sampled * weights[..., None], dim=-2)   # (B, N, D)
        return self.ffn(feat).float()


class Conv(nn.Module):
    """flax `nn.Conv` with a 3x3 kernel (kh, kw, in, out), padding SAME, on
    NCHW input, in fp32."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias,
                        padding=1)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, use_bias=False)` over the last axis.
    Inference normalises with the running statistics; training with the
    batch's mean and biased variance (flax's E[x²] - E[x]², clipped at 0),
    and moves the running statistics by ra = 0.9 ra + 0.1 batch (the
    variance biased too, unlike `torch.nn.BatchNorm1d`)."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x, training: bool = False):
        if not training:
            mean, var = self.mean, self.var
        else:
            flat = x.float().reshape(-1, x.shape[-1])
            mean = flat.mean(dim=0)
            var = torch.clamp((flat * flat).mean(dim=0) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale)


class TrainOutputs(NamedTuple):
    """FourDNet's training forward: class scores (B, C), the served
    embedding (B, r, after the BNNeck), the auxiliary scores of the towers'
    class tokens (rgb, depth), the per-token scores (B, N, C) with
    `token_ce` else None, and the raw embedding before the BNNeck."""
    cls_score: torch.Tensor
    embedding: torch.Tensor
    aux_scores: tuple
    tok_scores: torch.Tensor | None
    embedding_raw: torch.Tensor


class FourDNet(nn.Module):
    def __init__(self, cfg: FourDNetConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        r = c.reduced_dim
        hidden = c.backbone.hidden_size
        self.towers = TransReIDViT(c.backbone, towers=2)
        for m in ("rgb", "depth"):
            self.add_module(f"project_global_{m}", Dense(hidden, r))
            self.add_module(f"project_local_{m}", Dense(hidden, r))
            self.add_module(f"merge_local_global_{m}", Dense(2 * r, r))
        for name, (d_in, d_out) in {"hyper1": (2 * r, 128),
                                    "hyper2": (128, 32), "hyper3": (32, 8),
                                    "hyper4": (8, 2)}.items():
            self.add_module(name, Conv(d_in, d_out))
        for name in ("Q_r", "V_r", "Q_d", "V_d"):
            self.add_module(name, Dense(r, r))
        for name in ("r2r", "d2d", "d2r", "r2d"):
            self.add_module(name, DeformableFusionBlock(c))
            self.add_module(f"{name}_norm", Norm(r))
        if c.bnneck:
            self.bottleneck = BatchNorm(r)
        self.classifier = Dense(r, c.num_classes, bias=not c.bnneck)
        # training heads (fourdnet.py of the JAX package explains them)
        for m in ("rgb", "depth"):
            self.add_module(f"aux_norm_{m}", Norm(hidden))
            self.add_module(f"aux_classifier_{m}", Dense(hidden,
                                                         c.num_classes))
        if c.token_ce:
            self.token_bottleneck = BatchNorm(r)
            self.token_classifier = Dense(r, c.num_classes, bias=False)

    def forward(self, rgb, depth, cam_ids=None, view_ids=None,
                return_cls_tokens: bool = False, training: bool = False,
                modality_p: torch.Tensor | None = None):
        """rgb / depth: (B, H, W, 3) preprocessed. Returns (class scores
        (B, num_classes), embedding (B, reduced_dim)); with
        return_cls_tokens also the towers' class tokens (rgb, depth), each
        (B, hidden). With training=True it returns `TrainOutputs`;
        `modality_p` (B,) integers in [0, 5) are then the modality-dropout
        draws, required when cfg.modality_dropout."""
        c = self.cfg
        b = rgb.shape[0]
        if training and c.modality_dropout:
            if modality_p is None:
                raise ValueError("training with modality_dropout needs the "
                                 "draws modality_p (B,) in [0, 5)")
            p = modality_p.reshape(b, 1, 1, 1)
            rgb = torch.where((p == 0) | (p == 2), torch.zeros_like(rgb), rgb)
            depth = torch.where((p == 1) | (p == 3), torch.zeros_like(depth),
                                depth)
        tokens = self.towers(torch.stack([rgb, depth]), cam_ids, view_ids)
        rgb_tokens, depth_tokens = tokens[0], tokens[1]
        # the fusion head's input; the auxiliary heads read the raw tokens
        if training and c.detach_fusion:
            fus_rgb, fus_depth = rgb_tokens.detach(), depth_tokens.detach()
        else:
            fus_rgb, fus_depth = rgb_tokens, depth_tokens

        def project(tok, m):
            glob = getattr(self, f"project_global_{m}")(tok[:, 0])
            loc = getattr(self, f"project_local_{m}")(tok[:, 1:])
            merged = torch.cat([glob[:, None].expand(loc.shape), loc], dim=-1)
            return getattr(self, f"merge_local_global_{m}")(merged)

        rgb_path = project(fus_rgb, "rgb")                   # (B, N, r)
        depth_path = project(fus_depth, "depth")

        # hypernet gate (make_model.py:583-593,703-714)
        h, w = c.grid_hw
        g = torch.cat([depth_path, rgb_path], dim=-1).reshape(b, h, w, -1)
        g = g.permute(0, 3, 1, 2)
        for name in ("hyper1", "hyper2", "hyper3"):
            g = torch.relu(getattr(self, name)(g))
        filters = torch.softmax(self.hyper4(g), dim=1)       # (B, 2, h, w)
        rgb_filter = filters[:, 0].reshape(b, h * w)
        depth_filter = filters[:, 1].reshape(b, h * w)

        q_r, v_r = self.Q_r(rgb_path), self.V_r(rgb_path)
        q_d, v_d = self.Q_d(depth_path), self.V_d(depth_path)

        # self paths
        rgb_path = self.r2r_norm(rgb_path + self.r2r(q_r, v_r))
        depth_path = self.d2d_norm(depth_path + self.d2d(q_d, v_d))
        # cross paths, gated by the hypernet filters (make_model.py:789-821)
        rgb_path = self.d2r_norm(rgb_path + self.d2r(q_d, v_r)
                                 * rgb_filter[..., None])
        depth_path = self.r2d_norm(depth_path + self.r2d(q_r, v_d)
                                   * depth_filter[..., None])

        final = (depth_path * depth_filter[..., None]
                 + rgb_path * rgb_filter[..., None])
        embedding_raw = torch.mean(final, dim=-2)            # (B, r)
        embedding = embedding_raw
        if c.bnneck:
            embedding = self.bottleneck(embedding, training)
        cls_score = self.classifier(embedding)
        if training:
            aux = tuple(
                getattr(self, f"aux_classifier_{m}")(
                    getattr(self, f"aux_norm_{m}")(tok[:, 0]))
                for m, tok in (("rgb", rgb_tokens), ("depth", depth_tokens)))
            tok_scores = None
            if c.token_ce:
                tok_scores = self.token_classifier(
                    self.token_bottleneck(final, training))
            return TrainOutputs(cls_score, embedding, aux, tok_scores,
                                embedding_raw)
        if return_cls_tokens:
            return cls_score, embedding, (rgb_tokens[:, 0], depth_tokens[:, 0])
        return cls_score, embedding


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights drawn with `generator` on the model's device,
    by the JAX package's training init (`host_train_init`): lecun-normal
    kernels (fan-in per tower), zero biases, unit scales, BatchNorm
    statistics mean 0 / var 1, N(0, 0.02) class token, position and SIE
    embeddings, N(0, 1) LoRA down and zero LoRA up projections."""
    towers = {id(m.kernel) for m in model.modules()
              if isinstance(m, Dense) and m.towers is not None}
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("bias", "lora_up"):
                p.zero_()
            elif leaf == "scale":
                p.fill_(1.0)
            elif leaf == "lora_down":
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device))
            elif leaf == "kernel":
                if name == "towers.patch_embed.kernel":
                    fan_in = p[0, ..., 0].numel()
                elif id(p) in towers:
                    fan_in = p.shape[-2]
                else:
                    fan_in = p[..., 0].numel()
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device) * fan_in ** -0.5)
            else:                 # cls_token, pos_embed, sie_embed
                p.copy_(0.02 * torch.randn(p.shape, generator=generator,
                                           device=p.device))
