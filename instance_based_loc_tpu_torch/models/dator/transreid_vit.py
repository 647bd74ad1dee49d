"""TransReID-style ViT towers (counterpart of
`instance_based_loc_tpu/models/dator/transreid_vit.py`, reference
`dator/model/backbones/vit_pytorch.py`):

* overlapping patch embedding: a convolution with kernel = patch_size and a
  stride that may be smaller (PatchEmbed_overlap);
* class token + learned position embedding + the optional SIE camera/view
  embedding scaled by `sie_xishu`;
* pre-norm blocks, the last `lora_layers` carrying a rank-`lora_rank`
  adapter on the fused qkv projection (qkv(x) + x @ down @ up);
* `local_feature` mode runs all blocks but the last and no final norm,
  which is what FourDNet consumes.

The module holds T towers with their weights stacked on a leading tower
axis (FourDNet's RGB and depth towers, T = 2), in the JAX package's layout:
every parameter keeps its flax name and shape, so a state-dict key is the
flax path joined by dots and the npz checkpoint maps one to one. The
towers' batches run as one: the patch embedding is one grouped convolution,
each projection one batched matmul over the tower axis, and each block's
attention ONE call of `ops.attention.vit_attention` over (T * B) heads
batches, i.e. (32, 12, 129, 64) bf16 for two towers of a 16-crop batch at
256x128. On the card that is the hand-written kernel of
`csrc/vit_attention.cu`, and in training its gradient the hand-written
backward of `csrc/vit_attention_backward.cu` (through
`ops.attention.VitAttentionFunction`). The JAX tower computes its attention
with an einsum, not a Pallas call, and XLA differentiates it; routing it
through the ported ViT kernel and its backward is the port's design choice
(same function: softmax(q kᵀ / √D) v, no mask).

Precision follows the JAX module: the patch embedding, projections and
MLP compute in `cfg.dtype` (bf16 by default; their weights are stored in
it), the LayerNorms in fp32, the residual stream in `cfg.dtype`, the LoRA
term in fp32 then cast, and the tokens come back in fp32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import vit_attention


@dataclasses.dataclass(frozen=True)
class TransReIDConfig:
    img_height: int = 256
    img_width: int = 128
    patch_size: int = 16
    stride_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    lora_layers: int = 2
    lora_rank: int = 4
    sie_xishu: float = 3.0
    cameras: int = 0
    views: int = 0
    local_feature: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_y(self) -> int:
        return (self.img_height - self.patch_size) // self.stride_size + 1

    @property
    def num_x(self) -> int:
        return (self.img_width - self.patch_size) // self.stride_size + 1

    @property
    def num_patches(self) -> int:
        return self.num_x * self.num_y

    @property
    def num_blocks(self) -> int:
        """Blocks run: all but the last in local_feature mode."""
        return self.num_layers - (1 if self.local_feature else 0)


def _towers_view(p: torch.Tensor, dims: int) -> torch.Tensor:
    """A per-tower (T, C) parameter shaped to broadcast over (T, ..., C) of
    `dims` dimensions."""
    return p.reshape((p.shape[0],) + (1,) * (dims - 2) + (p.shape[-1],))


class Dense(nn.Module):
    """flax `nn.Dense`: kernel (in, out) and bias (out,), after an optional
    leading tower axis (then x is (T, ..., in)). With `dtype` the weights are
    stored and the product computed in it (flax's `dtype=`); else in fp32.
    Training keeps fp32 master copies of the weights it updates
    (`train.create_train_state`); the product still runs in `dtype`."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 towers: int | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        lead = () if towers is None else (towers,)
        self.towers = towers
        self.dtype = dtype
        dt = dtype or torch.float32
        self.kernel = nn.Parameter(torch.zeros(lead + (d_in, d_out), dtype=dt))
        self.bias = (nn.Parameter(torch.zeros(lead + (d_out,), dtype=dt))
                     if bias else None)

    def forward(self, x):
        dt = self.dtype or torch.float32
        x = x.to(dt)
        kernel = self.kernel.to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        if self.towers is None:
            y = x @ kernel
            return y if bias is None else y + bias
        t = x.shape[0]
        y = torch.bmm(x.reshape(t, -1, x.shape[-1]), kernel)
        y = y.reshape(x.shape[:-1] + (y.shape[-1],))
        return y if bias is None else y + _towers_view(bias, y.dim())


class Norm(nn.Module):
    """flax `nn.LayerNorm` computed in fp32 (scale and bias after an optional
    leading tower axis)."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 towers: int | None = None):
        super().__init__()
        lead = () if towers is None else (towers,)
        self.towers = towers
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(lead + (dim,)))
        self.bias = nn.Parameter(torch.zeros(lead + (dim,)))

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], eps=self.eps)
        if self.towers is None:
            return y * self.scale + self.bias
        return (y * _towers_view(self.scale, y.dim())
                + _towers_view(self.bias, y.dim()))


class LoRAAttention(nn.Module):
    def __init__(self, cfg: TransReIDConfig, towers: int, use_lora: bool):
        super().__init__()
        c = cfg
        d = c.hidden_size
        self.cfg = cfg
        self.use_lora = use_lora
        self.qkv = Dense(d, 3 * d, towers=towers, dtype=c.dtype)
        if use_lora:
            # rank-r adapter on the fused qkv projection
            self.lora_down = nn.Parameter(torch.zeros(towers, d, c.lora_rank))
            self.lora_up = nn.Parameter(torch.zeros(towers, c.lora_rank, 3 * d))
        self.proj = Dense(d, d, towers=towers, dtype=c.dtype)

    def forward(self, x):                                    # (T, B, S, D)
        c = self.cfg
        t, b, s, d = x.shape
        qkv = self.qkv(x)
        if self.use_lora:
            lo = torch.bmm(torch.bmm(x.float().reshape(t, -1, d),
                                     self.lora_down), self.lora_up)
            qkv = qkv + lo.reshape(qkv.shape).to(qkv.dtype)
        d_head = d // c.num_heads
        qkv = qkv.reshape(t * b, s, 3, c.num_heads, d_head)
        q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous()
                   for i in range(3))                        # (T*B, H, S, Dh)
        out = vit_attention(q, k, v)
        out = out.transpose(1, 2).reshape(t, b, s, d)
        return self.proj(out)


class TransReIDBlock(nn.Module):
    def __init__(self, cfg: TransReIDConfig, towers: int, use_lora: bool):
        super().__init__()
        c = cfg
        self.norm1 = Norm(c.hidden_size, towers=towers)
        self.attn = LoRAAttention(c, towers, use_lora)
        self.norm2 = Norm(c.hidden_size, towers=towers)
        mlp = int(c.hidden_size * c.mlp_ratio)
        self.fc1 = Dense(c.hidden_size, mlp, towers=towers, dtype=c.dtype)
        self.fc2 = Dense(mlp, c.hidden_size, towers=towers, dtype=c.dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        h = F.gelu(self.fc1(self.norm2(x)), approximate="none")
        return x + self.fc2(h)


class TransReIDViT(nn.Module):
    """T stacked towers: images (T, B, H, W, 3) NHWC, optional cam_ids /
    view_ids (B,) -> tokens (T, B, 1 + num_patches, hidden) fp32, before
    the last block when cfg.local_feature (FourDNet mode), else after the
    final norm."""

    def __init__(self, cfg: TransReIDConfig, towers: int = 1):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.towers = towers
        d = c.hidden_size
        self.patch_embed = nn.Module()
        self.patch_embed.kernel = nn.Parameter(torch.zeros(
            towers, c.patch_size, c.patch_size, 3, d, dtype=c.dtype))
        self.patch_embed.bias = nn.Parameter(torch.zeros(towers, d,
                                                         dtype=c.dtype))
        self.cls_token = nn.Parameter(torch.zeros(towers, 1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(towers, 1,
                                                  c.num_patches + 1, d))
        if c.cameras > 0 or c.views > 0:
            num_sie = max(c.cameras, 1) * max(c.views, 1)
            self.sie_embed = nn.Parameter(torch.zeros(towers, num_sie, 1, d))
        for i in range(c.num_blocks):
            self.add_module(f"block{i}", TransReIDBlock(
                c, towers, use_lora=i >= c.num_layers - c.lora_layers))
        if not c.local_feature:
            self.norm = Norm(d, towers=towers)

    def forward(self, images, cam_ids=None, view_ids=None):
        c = self.cfg
        t, b = images.shape[:2]
        d = c.hidden_size
        # the towers' patch embeddings as one grouped convolution
        x = images.to(c.dtype).permute(1, 0, 4, 2, 3)        # (B, T, 3, H, W)
        x = x.reshape(b, t * 3, *images.shape[2:4])
        w = self.patch_embed.kernel.to(c.dtype).permute(0, 4, 3, 1, 2)
        w = w.reshape(t * d, 3, c.patch_size, c.patch_size)
        x = F.conv2d(x, w, self.patch_embed.bias.to(c.dtype).reshape(-1),
                     stride=c.stride_size, groups=t)          # (B, T*D, ny, nx)
        x = x.reshape(b, t, d, -1).permute(1, 0, 3, 2)        # (T, B, N, D)
        cls = self.cls_token.expand(t, b, 1, d).to(c.dtype)
        x = torch.cat([cls, x], dim=2) + self.pos_embed.to(c.dtype)

        # SIE camera/view embedding (vit_pytorch.py:422-436)
        if c.cameras > 0 or c.views > 0:
            if c.cameras > 0 and c.views > 0:
                idx = cam_ids * c.views + view_ids
            elif c.cameras > 0:
                idx = cam_ids
            else:
                idx = view_ids
            x = x + (c.sie_xishu * self.sie_embed[:, idx]).to(c.dtype)

        for i in range(c.num_blocks):
            x = getattr(self, f"block{i}")(x)
        if not c.local_feature:
            x = self.norm(x)
        return x.float()


def resize_pos_embed(pos: np.ndarray, num_y: int, num_x: int) -> np.ndarray:
    """Bilinear pos-embed grid resize (reference `vit_pytorch.py:484-499`):
    the class token kept, the square grid resized bilinearly with
    align_corners=False and no antialiasing (`jax.image.resize`'s
    "bilinear" when it enlarges, which is the pretrained use). pos
    (1, 1 + gs*gs, D) -> (1, 1 + num_y*num_x, D)."""
    tok, grid = pos[:, :1], pos[0, 1:]
    gs = int(np.sqrt(grid.shape[0]))
    g = torch.as_tensor(np.asarray(grid, np.float32).reshape(gs, gs, -1))
    g = F.interpolate(g.permute(2, 0, 1)[None], size=(num_y, num_x),
                      mode="bilinear", align_corners=False)
    g = g[0].permute(1, 2, 0).reshape(1, num_y * num_x, -1).numpy()
    return np.concatenate([tok, g], axis=1)


def port_hf_vit_to_transreid(state_dict, cfg: TransReIDConfig,
                             towers: int = 1) -> dict[str, torch.Tensor]:
    """Pretrained ViT weights in the HF ViTModel layout (e.g.
    google/vit-base-patch16-224-in21k, the ImageNet init the reference gives
    both DATOR towers) as a state dict of `TransReIDViT(cfg, towers)`, every
    tower the same: the fused qkv concatenated, the pos embedding resized to
    the (num_y, num_x) grid, the final norm only when not local_feature.
    LoRA adapters and the SIE embedding are not in the file: the caller
    keeps their init (`load_state_dict(..., strict=False)`)."""
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()}

    def put(name, arr):
        out[name] = torch.as_tensor(np.broadcast_to(
            arr, (towers,) + arr.shape).copy())

    def lin(prefix, key):
        put(f"{prefix}.kernel", sd[key + ".weight"].T)
        put(f"{prefix}.bias", sd[key + ".bias"])

    def ln(prefix, key):
        put(f"{prefix}.scale", sd[key + ".weight"])
        put(f"{prefix}.bias", sd[key + ".bias"])

    out: dict[str, torch.Tensor] = {}
    put("patch_embed.kernel", sd["embeddings.patch_embeddings.projection."
                                 "weight"].transpose(2, 3, 1, 0))
    put("patch_embed.bias", sd["embeddings.patch_embeddings.projection.bias"])
    put("cls_token", sd["embeddings.cls_token"])
    pos = sd["embeddings.position_embeddings"]
    if pos.shape[1] != cfg.num_patches + 1:
        pos = resize_pos_embed(pos, cfg.num_y, cfg.num_x)
    put("pos_embed", pos)
    for i in range(cfg.num_blocks):
        pre, blk = f"encoder.layer.{i}.", f"block{i}"
        names = ("query", "key", "value")
        qkv_w = np.concatenate([sd[pre + f"attention.attention.{n}.weight"]
                                for n in names], axis=0)
        qkv_b = np.concatenate([sd[pre + f"attention.attention.{n}.bias"]
                                for n in names], axis=0)
        ln(f"{blk}.norm1", pre + "layernorm_before")
        ln(f"{blk}.norm2", pre + "layernorm_after")
        put(f"{blk}.attn.qkv.kernel", qkv_w.T)
        put(f"{blk}.attn.qkv.bias", qkv_b)
        lin(f"{blk}.attn.proj", pre + "attention.output.dense")
        lin(f"{blk}.fc1", pre + "intermediate.dense")
        lin(f"{blk}.fc2", pre + "output.dense")
    if not cfg.local_feature and "layernorm.weight" in sd:
        ln("norm", "layernorm")
    return out
