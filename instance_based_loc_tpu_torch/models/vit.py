"""One ViT trunk for the three embedder backbones (counterpart of
`instance_based_loc_tpu/models/vit.py`): HF ViT-B/16, DINOv2-base and the
open_clip ViT-B/32 visual tower differ only in small flags.

| variant | patch | quirks |
|---|---|---|
| vit    | 16 | pre-LN blocks, final LayerNorm (eps 1e-12) |
| dinov2 | 14 | + LayerScale per block (eps 1e-6) |
| clip   | 32 | + ln_pre before the blocks, ln_post + linear projection |

Matmuls and the patch convolution run in `cfg.dtype` (bf16 by default);
LayerNorm, LayerScale, the class token and the position embedding keep fp32
parameters, and LayerNorm computes in fp32, as in the JAX module. The
attention of every block is `ops.attention.vit_attention`: the CUDA kernel
for a tensor on the card, its plain version on the CPU.

Images are NHWC, as in the JAX package. `params_from_jax` turns the JAX
module's parameter tree (numpy arrays) into this module's state dict;
`port_hf_vit_params`, `port_hf_dinov2_params` and
`port_hf_clip_vision_params` do the same for the HF `transformers` state
dicts the reference loads (ViTModel, Dinov2Model, CLIPVisionModel).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import vit_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    layernorm_eps: float = 1e-12
    use_layerscale: bool = False      # dinov2
    use_ln_pre: bool = False          # clip
    use_quick_gelu: bool = False      # openai clip
    projection_dim: Optional[int] = None  # clip visual projection
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


VARIANTS = {
    "vit": ViTConfig(patch_size=16, layernorm_eps=1e-12),
    "dinov2": ViTConfig(patch_size=14, layernorm_eps=1e-6, use_layerscale=True),
    "clip": ViTConfig(patch_size=32, layernorm_eps=1e-5, use_ln_pre=True,
                      projection_dim=512),
}


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 parameters that computes in fp32 and returns
    fp32, whatever the input type (flax `LayerNorm(dtype=float32)`)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.qkv = nn.Linear(c.hidden_size, 3 * c.hidden_size, dtype=c.dtype)
        self.out = nn.Linear(c.hidden_size, c.hidden_size, dtype=c.dtype)

    def forward(self, x):
        c = self.cfg
        b, s, _ = x.shape
        d_head = c.hidden_size // c.num_heads
        qkv = self.qkv(x.to(c.dtype)).reshape(b, s, 3, c.num_heads, d_head)
        q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        out = vit_attention(q, k, v)                   # (B, H, S, D)
        out = out.transpose(1, 2).reshape(b, s, c.hidden_size)
        return self.out(out)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.mlp_dim, dtype=cfg.dtype)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.hidden_size, dtype=cfg.dtype)

    def forward(self, x):
        x = self.fc1(x.to(self.cfg.dtype))
        if self.cfg.use_quick_gelu:
            x = x * torch.sigmoid(1.702 * x)
        else:
            x = F.gelu(x, approximate="none")
        return self.fc2(x)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = LayerNorm(cfg.hidden_size, eps=cfg.layernorm_eps)
        self.attn = Attention(cfg)
        self.ln2 = LayerNorm(cfg.hidden_size, eps=cfg.layernorm_eps)
        self.mlp = Mlp(cfg)
        if cfg.use_layerscale:
            self.layerscale1 = nn.Parameter(torch.ones(cfg.hidden_size))
            self.layerscale2 = nn.Parameter(torch.ones(cfg.hidden_size))

    def forward(self, x):
        h = self.attn(self.ln1(x))
        if self.cfg.use_layerscale:
            h = h * self.layerscale1       # fp32 scale: h is promoted to fp32
        x = x + h
        h = self.mlp(self.ln2(x))
        if self.cfg.use_layerscale:
            h = h * self.layerscale2
        return x + h


class ViT(nn.Module):
    """images (B, H, W, 3) -> (cls_embedding (B, E) fp32, tokens (B, S, E)
    fp32). cls_embedding is post-final-LN (and post-projection for clip),
    what the reference extracts (`last_hidden_state[:, 0]` /
    `encode_image`)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.patch_embed = nn.Conv2d(3, c.hidden_size, c.patch_size,
                                     stride=c.patch_size, dtype=c.dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size))
        self.pos_embed = nn.Parameter(torch.zeros(1, c.num_patches + 1,
                                                  c.hidden_size))
        if c.use_ln_pre:
            self.ln_pre = LayerNorm(c.hidden_size, eps=c.layernorm_eps)
        self.blocks = nn.ModuleList(Block(c) for _ in range(c.num_layers))
        self.ln_final = LayerNorm(c.hidden_size, eps=c.layernorm_eps)
        if c.projection_dim is not None:
            self.proj = nn.Linear(c.hidden_size, c.projection_dim, bias=False,
                                  dtype=c.dtype)

    def forward(self, images):
        c = self.cfg
        b = images.shape[0]
        x = self.patch_embed(images.permute(0, 3, 1, 2).to(c.dtype))
        x = x.flatten(2).transpose(1, 2)                       # (B, N, E)
        cls = self.cls_token.expand(b, 1, c.hidden_size).to(c.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(c.dtype)
        if c.use_ln_pre:
            x = self.ln_pre(x)
        for block in self.blocks:
            x = block(x)
        x = self.ln_final(x)
        cls_out = x[:, 0]
        if c.projection_dim is not None:
            cls_out = self.proj(cls_out.to(c.dtype))
        return cls_out.float(), x.float()


def init_params(model: ViT, generator: torch.Generator) -> None:
    """Seeded random weights, drawn on the model's device with `generator`:
    lecun-normal weights and zero biases for the linear maps and the patch
    convolution, unit LayerNorm scales and LayerScales, a zero class token
    and a N(0, 0.02) position embedding (the JAX module's initialisers)."""
    def normal(p, std):
        return std * torch.randn(p.shape, generator=generator, device=p.device)

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, (nn.Linear, nn.Conv2d)):
                fan_in = int(np.prod(module.weight.shape[1:]))
                module.weight.copy_(normal(module.weight, fan_in ** -0.5))
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, Block) and module.cfg.use_layerscale:
                module.layerscale1.fill_(1.0)
                module.layerscale2.fill_(1.0)
        model.cls_token.zero_()
        model.pos_embed.copy_(normal(model.pos_embed, 0.02))


def params_from_jax(flax_params: dict, cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """The JAX ViT's parameter tree (`{"params": ...}` or its inner dict,
    numpy or jax arrays) as this module's fp32 state dict."""
    p = flax_params.get("params", flax_params)

    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32))

    e = cfg.hidden_size
    sd = {
        # flax Conv kernel (kh, kw, cin, cout) -> torch (cout, cin, kh, kw)
        "patch_embed.weight": t(np.transpose(np.asarray(p["patch_embed"]["kernel"]),
                                             (3, 2, 0, 1))),
        "patch_embed.bias": t(p["patch_embed"]["bias"]),
        "cls_token": t(p["cls_token"]),
        "pos_embed": t(p["pos_embed"]),
    }

    def ln(prefix, leaf):
        sd[f"{prefix}.weight"] = t(leaf["scale"])
        sd[f"{prefix}.bias"] = t(leaf["bias"])

    def dense(prefix, leaf, in_dim):
        kernel = np.asarray(leaf["kernel"], np.float32).reshape(in_dim, -1)
        sd[f"{prefix}.weight"] = t(kernel.T)
        if "bias" in leaf:
            sd[f"{prefix}.bias"] = t(np.asarray(leaf["bias"]).reshape(-1))

    if cfg.use_ln_pre:
        ln("ln_pre", p["ln_pre"])
    for i in range(cfg.num_layers):
        blk, pre = p[f"block{i}"], f"blocks.{i}"
        ln(f"{pre}.ln1", blk["ln1"])
        ln(f"{pre}.ln2", blk["ln2"])
        # DenseGeneral (E, 3, H, Dh) -> Linear (3*H*Dh, E);
        # DenseGeneral over (H, Dh) -> Linear (E, H*Dh)
        dense(f"{pre}.attn.qkv", blk["attn"]["qkv"], e)
        dense(f"{pre}.attn.out", blk["attn"]["out"], e)
        dense(f"{pre}.mlp.fc1", blk["mlp"]["fc1"], e)
        dense(f"{pre}.mlp.fc2", blk["mlp"]["fc2"], cfg.mlp_dim)
        if cfg.use_layerscale:
            sd[f"{pre}.layerscale1"] = t(blk["layerscale1"])
            sd[f"{pre}.layerscale2"] = t(blk["layerscale2"])
    ln("ln_final", p["ln_final"])
    if cfg.projection_dim is not None:
        dense("proj", p["proj"], e)
    return sd



# ---------------------------------------------------------------------------
# HF torch checkpoints -> this module's state dict
# ---------------------------------------------------------------------------

def _f32(x) -> torch.Tensor:
    """A checkpoint value (a torch tensor of any float type, or numpy) as
    an fp32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def _hf_blocks(sd: dict, cfg: ViTConfig, names: dict, layers: str) -> dict:
    """The blocks of an HF encoder: q, k and v Linears stacked into one
    `qkv` Linear (rows q, then k, then v: the JAX package's `_split_qkv`
    order), every other Linear and LayerNorm taken as it is. `names` maps
    this module's leaf names to the HF ones under `{layers}.{i}.`."""
    out = {}
    for i in range(cfg.num_layers):
        src, dst = f"{layers}.{i}.", f"blocks.{i}."
        for part in ("weight", "bias"):
            out[f"{dst}attn.qkv.{part}"] = torch.cat(
                [_f32(sd[f"{src}{names[n]}.{part}"]) for n in "qkv"])
            for leaf in ("ln1", "ln2", "attn.out", "mlp.fc1", "mlp.fc2"):
                out[f"{dst}{leaf}.{part}"] = _f32(
                    sd[f"{src}{names[leaf]}.{part}"])
        if cfg.use_layerscale:
            for j in (1, 2):
                out[f"{dst}layerscale{j}"] = _f32(
                    sd[f"{src}{names[f'layerscale{j}']}"])
    return out


_HF_VIT_NAMES = {
    "q": "attention.attention.query", "k": "attention.attention.key",
    "v": "attention.attention.value", "attn.out": "attention.output.dense",
    "ln1": "layernorm_before", "ln2": "layernorm_after",
    "mlp.fc1": "intermediate.dense", "mlp.fc2": "output.dense",
}
_HF_DINOV2_NAMES = dict(_HF_VIT_NAMES, ln1="norm1", ln2="norm2",
                        layerscale1="layer_scale1.lambda1",
                        layerscale2="layer_scale2.lambda1",
                        **{"mlp.fc1": "mlp.fc1", "mlp.fc2": "mlp.fc2"})
_HF_CLIP_NAMES = {
    "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
    "attn.out": "self_attn.out_proj", "ln1": "layer_norm1",
    "ln2": "layer_norm2", "mlp.fc1": "mlp.fc1", "mlp.fc2": "mlp.fc2",
}


def _hf_vit_like(sd: dict, cfg: ViTConfig, names: dict) -> dict:
    out = {
        "patch_embed.weight": _f32(
            sd["embeddings.patch_embeddings.projection.weight"]),
        "patch_embed.bias": _f32(
            sd["embeddings.patch_embeddings.projection.bias"]),
        "cls_token": _f32(sd["embeddings.cls_token"]),
        "pos_embed": _f32(sd["embeddings.position_embeddings"]),
        "ln_final.weight": _f32(sd["layernorm.weight"]),
        "ln_final.bias": _f32(sd["layernorm.bias"]),
    }
    out.update(_hf_blocks(sd, cfg, names, "encoder.layer"))
    return out


def port_hf_vit_params(state_dict: dict, cfg: ViTConfig) -> dict:
    """A `transformers.ViTModel` state dict (no `vit.` prefix) as this
    module's fp32 state dict (JAX `port_hf_vit_params`); the pooler is
    dropped."""
    return _hf_vit_like(state_dict, cfg, _HF_VIT_NAMES)


def port_hf_dinov2_params(state_dict: dict, cfg: ViTConfig) -> dict:
    """A `transformers.Dinov2Model` state dict as this module's fp32 state
    dict (JAX `port_hf_dinov2_params`); the mask token is dropped."""
    return _hf_vit_like(state_dict, cfg, _HF_DINOV2_NAMES)


def port_hf_clip_vision_params(state_dict: dict, cfg: ViTConfig,
                               visual_projection=None) -> dict:
    """A `transformers.CLIPVisionModel` state dict (keys with or without
    `vision_model.`) as this module's fp32 state dict (JAX
    `port_hf_clip_vision_params`): no patch bias (zeros), `pre_layrnorm` ->
    `ln_pre`, `post_layernorm` -> `ln_final`. The projection is
    `visual_projection` if given, else the state dict's
    `visual_projection.weight` (a CLIPModel or
    CLIPVisionModelWithProjection file), else zeros, as in the JAX
    package, which never reads the file's projection."""
    sd = {k.removeprefix("vision_model."): v for k, v in state_dict.items()}
    e = cfg.hidden_size
    out = {
        "patch_embed.weight": _f32(sd["embeddings.patch_embedding.weight"]),
        "patch_embed.bias": _f32(sd.get("embeddings.patch_embedding.bias",
                                        np.zeros(e, np.float32))),
        "cls_token": _f32(sd["embeddings.class_embedding"]).reshape(1, 1, e),
        "pos_embed": _f32(sd["embeddings.position_embedding.weight"])[None],
        "ln_pre.weight": _f32(sd["pre_layrnorm.weight"]),
        "ln_pre.bias": _f32(sd["pre_layrnorm.bias"]),
        "ln_final.weight": _f32(sd["post_layernorm.weight"]),
        "ln_final.bias": _f32(sd["post_layernorm.bias"]),
    }
    out.update(_hf_blocks(sd, cfg, _HF_CLIP_NAMES, "encoder.layers"))
    if cfg.projection_dim is not None:
        if visual_projection is None:
            visual_projection = sd.get(
                "visual_projection.weight",
                np.zeros((cfg.projection_dim, e), np.float32))
        out["proj.weight"] = _f32(visual_projection)
    return out
