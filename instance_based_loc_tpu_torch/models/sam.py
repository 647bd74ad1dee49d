"""Segment Anything (SAM), the cascade's box-prompted segmenter (counterpart
of `instance_based_loc_tpu/models/sam.py`).

* image encoder: ViT with 16x16 patches, windowed attention (window 14) in
  all but the global blocks, decomposed relative positions, and a conv neck
  to 256 channels. The global blocks' attention is `ops.sam_attention`: the
  CUDA kernel on the card, its plain version on the CPU. Windowed blocks
  (196 tokens) are plain PyTorch, as they are XLA in the JAX package. Runs
  of consecutive windowed blocks stay in window layout, with padded cells
  re-zeroed after each block's norm (the JAX encoder's `pre_partitioned`
  form, exact with the official semantics);
* prompt encoder: random-Fourier encoding of box corners plus the corner
  embeddings, computed in fp32 (bf16 would round 1024-scale pixels to
  ~4 px) and cast to the stream type;
* mask decoder: two-way transformer, 4x upscaling, hypernetwork heads, IoU
  head; `multimask_output=False` takes mask token 0.

Submodules carry the names of the official `sam_vit_*.pth` state dict, so a
checkpoint loads with `load_state_dict(strict=True)` once the dense-mask
prompt path (which the cascade never feeds) is dropped
(`official_state_dict`). `params_from_jax` maps the JAX module's tree.
Images are NHWC, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from .. import resolve_device
from ..ops.sam_attention import sam_attention
from .precision import resolve_compute_dtype


@dataclasses.dataclass(frozen=True)
class SamConfig:
    img_size: int = 1024
    patch_size: int = 16
    encoder_dim: int = 1280          # ViT-H
    encoder_depth: int = 32
    encoder_heads: int = 16
    window_size: int = 14
    global_blocks: tuple = (7, 15, 23, 31)
    prompt_dim: int = 256
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    iou_head_hidden: int = 256
    num_mask_tokens: int = 4

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


# the JAX package's weights-free default (ViT-B; H is 32 blocks deep)
SAM_B = SamConfig(encoder_dim=768, encoder_depth=12, encoder_heads=12,
                  global_blocks=(2, 5, 8, 11))
SAM_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_STD = np.array([58.395, 57.12, 57.375], np.float32)


def _window_partition(x, win):
    """(B, H, W, C) -> (B * nW, win, win, C), zero-padded to window
    multiples; also returns the padded size."""
    b, h, w, c = x.shape
    pad_h, pad_w = (-h) % win, (-w) % win
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // win, win, wp // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c), (hp, wp)


def _window_unpartition(x, win, padded, orig):
    hp, wp = padded
    h, w = orig
    b = x.shape[0] // (hp // win * wp // win)
    x = x.reshape(b, hp // win, wp // win, win, win, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _rel_pos_bias(q_size, k_size, rel_pos):
    """Decomposed relative-position lookup (SAM's get_rel_pos):
    (q_size, k_size, head_dim)."""
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(
        k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(
        q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


class Attention(nn.Module):
    """Multi-head attention with decomposed relative positions. Global
    blocks run `sam_attention` (the CUDA kernel on the card)."""

    def __init__(self, dim: int, heads: int, input_size: tuple,
                 is_global: bool):
        super().__init__()
        self.heads = heads
        self.is_global = is_global
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        d_head = dim // heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                  d_head))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                  d_head))

    def forward(self, x):
        b, h, w, dim = x.shape
        heads = self.heads
        d_head = dim // heads
        s = h * w
        qkv = self.qkv(x).reshape(b, s, 3, heads, d_head)
        q, k, v = qkv.unbind(2)                          # (B, S, heads, d)
        rh = _rel_pos_bias(h, h, self.rel_pos_h)         # (h, h, d)
        rw = _rel_pos_bias(w, w, self.rel_pos_w)         # (w, w, d)
        q_sp = q.reshape(b, h, w, heads, d_head)
        bias_h = torch.einsum("bhwnd,hkd->bnhwk", q_sp, rh)
        bias_w = torch.einsum("bhwnd,wkd->bnhwk", q_sp, rw)
        if self.is_global:
            out = sam_attention(
                q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(),
                bias_h.reshape(b, heads, s, h).contiguous(),
                bias_w.reshape(b, heads, s, w).contiguous())
            out = out.transpose(1, 2).reshape(b, h, w, dim)
            return self.proj(out)
        attn = torch.einsum("bqhd,bkhd->bhqk", q * d_head ** -0.5, k)
        bias = bias_h[..., :, None] + bias_w[..., None, :]
        attn = attn + bias.reshape(b, heads, s, s)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, h, w, dim)
        return self.proj(out)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


def _gelu(x):
    return F.gelu(x, approximate="none")


class Block(nn.Module):
    def __init__(self, cfg: SamConfig, is_global: bool):
        super().__init__()
        c = cfg
        size = (c.grid, c.grid) if is_global else (c.window_size,) * 2
        self.norm1 = nn.LayerNorm(c.encoder_dim, eps=1e-6)
        self.attn = Attention(c.encoder_dim, c.encoder_heads, size, is_global)
        self.norm2 = nn.LayerNorm(c.encoder_dim, eps=1e-6)
        self.mlp = MLPBlock(c.encoder_dim, 4 * c.encoder_dim, _gelu)

    def forward(self, x, pad_mask=None):
        """x: (B, H, W, C) for a global block; for a windowed block, the
        residual stream already in window layout (B * nW, win, win, C), with
        `pad_mask` marking real cells (None: no padding)."""
        h = self.norm1(x)
        if pad_mask is not None:
            h = torch.where(pad_mask, h, torch.zeros((), dtype=h.dtype,
                                                     device=h.device))
        x = x + self.attn(h)
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.encoder_dim, cfg.patch_size,
                              stride=cfg.patch_size)

    def forward(self, x):                       # NHWC in, NHWC out
        return self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.patch_embed = PatchEmbed(c)
        self.pos_embed = nn.Parameter(torch.zeros(1, c.grid, c.grid,
                                                  c.encoder_dim))
        self.blocks = nn.ModuleList(Block(c, i in c.global_blocks)
                                    for i in range(c.encoder_depth))
        self.neck = nn.Sequential(
            nn.Conv2d(c.encoder_dim, c.prompt_dim, 1, bias=False),
            nn.LayerNorm(c.prompt_dim, eps=1e-6),
            nn.Conv2d(c.prompt_dim, c.prompt_dim, 3, padding=1, bias=False),
            nn.LayerNorm(c.prompt_dim, eps=1e-6))

    def forward(self, images):
        """images (B, S, S, 3) -> (B, grid, grid, prompt_dim)."""
        c = self.cfg
        x = self.patch_embed(images) + self.pos_embed
        win = c.window_size
        i = 0
        while i < c.encoder_depth:
            if i in c.global_blocks:
                x = self.blocks[i](x)
                i += 1
                continue
            j = i
            while j < c.encoder_depth and j not in c.global_blocks:
                j += 1
            # a run of windowed blocks: one partition, one unpartition
            orig = x.shape[1:3]
            xp, padded = _window_partition(x, win)
            mask = None
            if padded != tuple(orig):
                ones = torch.ones((x.shape[0],) + tuple(orig) + (1,),
                                  dtype=x.dtype, device=x.device)
                mask = _window_partition(ones, win)[0] > 0.5
            for blk in range(i, j):
                xp = self.blocks[blk](xp, pad_mask=mask)
            x = _window_unpartition(xp, win, padded, orig)
            i = j
        x = self.neck[0](x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = self.neck[1](x)
        x = self.neck[2](x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.neck[3](x)


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def forward(self, coords_01):
        """Random-Fourier encoding of [0, 1]^2 coordinates, in fp32."""
        proj = (2.0 * coords_01.float() - 1.0) @ \
            self.positional_encoding_gaussian_matrix.float()
        proj = 2.0 * math.pi * proj
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class PromptEncoder(nn.Module):
    """Box prompts only: the corner tokens (point_embeddings 2 and 3), the
    dense positional encoding and the "no mask" embedding."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        d = cfg.prompt_dim
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)

    def encode_boxes(self, boxes_xyxy, img_size: int):
        """(M, 4) fp32 pixel boxes -> (M, 2, prompt_dim) fp32 corner tokens
        (+0.5 pixel-centre shift, as the official prompt encoder)."""
        corners = (boxes_xyxy.float() + 0.5).reshape(-1, 2, 2) / img_size
        pe = self.pe_layer(corners)
        return torch.stack(
            [pe[:, 0] + self.point_embeddings[2].weight[0].float(),
             pe[:, 1] + self.point_embeddings[3].weight[0].float()], dim=1)

    def dense_pe(self, grid: int, device):
        xs = (torch.arange(grid, device=device, dtype=torch.float32)
              + 0.5) / grid
        gy, gx = torch.meshgrid(xs, xs, indexing="ij")
        return self.pe_layer(torch.stack([gx, gy], dim=-1))   # (g, g, D)


class DecoderAttention(nn.Module):
    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q, k, v):
        def split(x):
            return x.reshape(*x.shape[:-1], self.heads, -1)

        qh, kh, vh = (split(self.q_proj(q)), split(self.k_proj(k)),
                      split(self.v_proj(v)))
        d = qh.shape[-1]
        attn = torch.einsum("...qhd,...khd->...hqk", qh * d ** -0.5, kh)
        attn = torch.softmax(attn.float(), dim=-1).to(vh.dtype)
        o = torch.einsum("...hqk,...khd->...qhd", attn, vh)
        return self.out_proj(o.reshape(*q.shape[:-1], -1))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: SamConfig, skip_first_layer_pe: bool):
        super().__init__()
        d, heads = cfg.prompt_dim, cfg.decoder_heads
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(d, heads)
        self.norm1 = nn.LayerNorm(d)
        self.cross_attn_token_to_image = DecoderAttention(d, heads, 2)
        self.norm2 = nn.LayerNorm(d)
        self.mlp = MLPBlock(d, cfg.decoder_mlp_dim, F.relu)
        self.norm3 = nn.LayerNorm(d)
        self.norm4 = nn.LayerNorm(d)
        self.cross_attn_image_to_token = DecoderAttention(d, heads, 2)

    def forward(self, tokens, image, token_pe, image_pe):
        # block 0 replaces the tokens with the attention output (no residual)
        if self.skip_first_layer_pe:
            tokens = self.norm1(self.self_attn(tokens, tokens, tokens))
        else:
            q = tokens + token_pe
            tokens = self.norm1(tokens + self.self_attn(q, q, tokens))
        q = tokens + token_pe
        k = image + image_pe
        tokens = self.norm2(tokens + self.cross_attn_token_to_image(q, k,
                                                                    image))
        tokens = self.norm3(tokens + self.mlp(tokens))
        q = image + image_pe
        k = tokens + token_pe
        image = self.norm4(image + self.cross_attn_image_to_token(q, k,
                                                                  tokens))
        return tokens, image


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        d = cfg.prompt_dim
        self.layers = nn.ModuleList(TwoWayAttentionBlock(cfg, i == 0)
                                    for i in range(cfg.decoder_depth))
        self.final_attn_token_to_image = DecoderAttention(
            d, cfg.decoder_heads, 2)
        self.norm_final_attn = nn.LayerNorm(d)

    def forward(self, image, image_pe, tokens):
        tok, img = tokens, image
        for layer in self.layers:
            tok, img = layer(tok, img, tokens, image_pe)
        tok = tok + self.final_attn_token_to_image(tok + tokens,
                                                   img + image_pe, img)
        return self.norm_final_attn(tok), img


class MLP(nn.Module):
    def __init__(self, dims: list[int]):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        c = cfg
        d = c.prompt_dim
        self.cfg = cfg
        self.transformer = TwoWayTransformer(c)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(c.num_mask_tokens, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, stride=2),
            nn.LayerNorm(d // 4, eps=1e-5),     # the JAX module's epsilon
            nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP([d, d, d, d // 8]) for _ in range(c.num_mask_tokens))
        self.iou_prediction_head = MLP([d, c.iou_head_hidden,
                                        c.iou_head_hidden,
                                        c.num_mask_tokens])

    def forward(self, image_embedding, image_pe, prompt_tokens):
        """image_embedding, image_pe (g, g, D); prompt_tokens (M, P, D).
        Returns masks (M, num_mask_tokens, 4g, 4g) and iou (M, n)."""
        c = self.cfg
        g = image_embedding.shape[0]
        m = prompt_tokens.shape[0]
        fixed = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([fixed[None].expand(m, -1, -1).to(
            prompt_tokens.dtype), prompt_tokens], dim=1)
        image = image_embedding.reshape(1, g * g, -1).expand(m, -1, -1)
        img_pe = image_pe.reshape(1, g * g, -1).expand(m, -1, -1)
        tok, img = self.transformer(image, img_pe, tokens)
        iou_out = tok[:, 0]
        mask_tok_out = tok[:, 1:1 + c.num_mask_tokens]

        up = img.reshape(m, g, g, -1)
        up = self.output_upscaling[0](up.permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)
        up = _gelu(self.output_upscaling[1](up))
        up = self.output_upscaling[3](up.permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)
        up = _gelu(up)                                      # (M, 4g, 4g, D/8)
        hyper = torch.stack([mlp(mask_tok_out[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], 1)
        masks = torch.einsum("mnc,mhwc->mnhw", hyper, up)
        return masks, self.iou_prediction_head(iou_out)


class Sam(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    def decode(self, emb, boxes_xyxy):
        """emb (g, g, D) from the image encoder; boxes (M, 4) fp32 in the
        model's input frame. Returns (mask logits (M, 4g, 4g), iou (M,)) of
        mask token 0 (multimask_output=False)."""
        c = self.cfg
        pe = self.prompt_encoder
        prompts = pe.encode_boxes(boxes_xyxy, c.img_size).to(emb.dtype)
        dense_pe = pe.dense_pe(c.grid, emb.device).to(emb.dtype)
        emb = emb + pe.no_mask_embed.weight[0].to(emb.dtype)
        masks, iou = self.mask_decoder(emb, dense_pe, prompts)
        return masks[:, 0], iou[:, 0]

    def forward(self, image, boxes_xyxy):
        """image (S, S, 3) normalised; boxes (M, 4) in the input frame."""
        return self.decode(self.image_encoder(image[None])[0], boxes_xyxy)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def init_params(model: Sam, generator: torch.Generator) -> None:
    """Seeded random weights, as the JAX package's `host_random_params`:
    LayerNorm scales 1, biases 0, every other parameter (and the Fourier
    matrix) N(0, 0.02), drawn with `generator` on the model's device."""
    with torch.no_grad():
        for module in model.modules():
            for name, p in list(module.named_parameters(recurse=False)) + \
                    list(module.named_buffers(recurse=False)):
                if name == "bias":
                    p.zero_()
                elif name == "weight" and isinstance(module, nn.LayerNorm):
                    p.fill_(1.0)
                else:
                    p.copy_(0.02 * torch.randn(p.shape, generator=generator,
                                               device=p.device))


# keys of the official checkpoint on the dense-mask prompt path, which the
# cascade never feeds (segment-anything's `mask_downscaling`; `mask_embed`
# and `shared_image_embedding` in files converted from the HF layout)
_UNUSED_PREFIXES = ("prompt_encoder.mask_downscaling.",
                    "prompt_encoder.mask_embed.", "shared_image_embedding.")


def official_state_dict(sd: dict) -> dict:
    """An official `sam_vit_*.pth` state dict without the keys of the
    dense-mask prompt path: `Sam(cfg).load_state_dict(..., strict=True)`
    takes the rest as it is."""
    return {k: torch.as_tensor(v) for k, v in sd.items()
            if not k.startswith(_UNUSED_PREFIXES)}


def sam_config_from_state_dict(sd, img_size: int = 1024,
                               **overrides) -> SamConfig:
    """The encoder variant (B/L/H) of an official-layout state dict: width
    from patch_embed, depth from the block count, global blocks from the
    rel-pos table length (windowed blocks carry 2 * 14 - 1 rows)."""
    dim = int(sd["image_encoder.patch_embed.proj.weight"].shape[0])
    blocks = sorted({int(m.group(1)) for k in sd
                     if (m := re.match(r"image_encoder\.blocks\.(\d+)\.", k))})
    window_rows = 2 * 14 - 1
    global_blocks = tuple(
        i for i in blocks
        if sd[f"image_encoder.blocks.{i}.attn.rel_pos_h"].shape[0]
        != window_rows)
    heads = {768: 12, 1024: 16, 1280: 16}.get(dim, max(1, dim // 80))
    return SamConfig(img_size=img_size, encoder_dim=dim,
                     encoder_depth=blocks[-1] + 1, encoder_heads=heads,
                     global_blocks=global_blocks, **overrides)


def params_from_jax(flax_params: dict, cfg: SamConfig) -> dict:
    """The JAX `Sam`'s parameter tree (numpy or jax leaves) as this
    module's fp32 state dict (the inverse of the JAX package's
    `_sam_flax_params` with its official names)."""
    p = flax_params.get("params", flax_params)

    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32))

    sd = {}

    def lin(dst, leaf):
        sd[dst + ".weight"] = t(np.asarray(leaf["kernel"]).T)
        sd[dst + ".bias"] = t(leaf["bias"])

    def ln(dst, leaf):
        sd[dst + ".weight"] = t(leaf["scale"])
        sd[dst + ".bias"] = t(leaf["bias"])

    def conv(dst, leaf):     # flax (kh, kw, in, out) -> torch (out, in, kh, kw)
        sd[dst + ".weight"] = t(np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in leaf:
            sd[dst + ".bias"] = t(leaf["bias"])

    enc, pro, dec = (p["image_encoder"], p["prompt_encoder"],
                     p["mask_decoder"])
    conv("image_encoder.patch_embed.proj", enc["patch_embed"])
    sd["image_encoder.pos_embed"] = t(enc["pos_embed"])
    for i in range(cfg.encoder_depth):
        b, dst = enc[f"block{i}"], f"image_encoder.blocks.{i}"
        ln(dst + ".norm1", b["norm1"])
        ln(dst + ".norm2", b["norm2"])
        lin(dst + ".attn.qkv", b["attn"]["qkv"])
        lin(dst + ".attn.proj", b["attn"]["proj"])
        sd[dst + ".attn.rel_pos_h"] = t(b["attn"]["rel_pos_h"])
        sd[dst + ".attn.rel_pos_w"] = t(b["attn"]["rel_pos_w"])
        lin(dst + ".mlp.lin1", b["fc1"])
        lin(dst + ".mlp.lin2", b["fc2"])
    conv("image_encoder.neck.0", enc["neck0"])
    ln("image_encoder.neck.1", enc["neck_ln0"])
    conv("image_encoder.neck.2", enc["neck1"])
    ln("image_encoder.neck.3", enc["neck_ln1"])

    d = cfg.prompt_dim
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = t(
        pro["pe_gaussian"])
    # the box-only JAX module has no point embeddings 0/1 and no
    # not-a-point embedding; the forward never reads them
    for i in (0, 1):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = torch.zeros(1, d)
    sd["prompt_encoder.point_embeddings.2.weight"] = t(pro["corner1"])[None]
    sd["prompt_encoder.point_embeddings.3.weight"] = t(pro["corner2"])[None]
    sd["prompt_encoder.not_a_point_embed.weight"] = torch.zeros(1, d)
    sd["prompt_encoder.no_mask_embed.weight"] = t(pro["no_mask"])[None]

    m = "mask_decoder."
    sd[m + "iou_token.weight"] = t(dec["iou_token"])
    sd[m + "mask_tokens.weight"] = t(dec["mask_tokens"])
    # flax ConvTranspose(transpose_kernel=True) kernel (kh, kw, out, in) ->
    # torch ConvTranspose2d (in, out, kh, kw)
    conv(m + "output_upscaling.0", dec["up1"])
    ln(m + "output_upscaling.1", dec["up_ln"])
    conv(m + "output_upscaling.3", dec["up2"])
    ln(m + "transformer.norm_final_attn", dec["final_ln"])
    for src, name in (("final_q", "q_proj"), ("final_k", "k_proj"),
                      ("final_v", "v_proj"), ("final_out", "out_proj")):
        lin(m + f"transformer.final_attn_token_to_image.{name}", dec[src])
    for i in range(cfg.decoder_depth):
        b, dst = dec[f"block{i}"], m + f"transformer.layers.{i}"
        for pre, name in (("self", "self_attn"),
                          ("t2i", "cross_attn_token_to_image"),
                          ("i2t", "cross_attn_image_to_token")):
            for src, proj in (("q", "q_proj"), ("k", "k_proj"),
                              ("v", "v_proj"), ("out", "out_proj")):
                lin(f"{dst}.{name}.{proj}", b[f"{pre}_{src}"])
        for j in range(1, 5):
            ln(f"{dst}.norm{j}", b[f"ln{j}"])
        lin(dst + ".mlp.lin1", b["fc1"])
        lin(dst + ".mlp.lin2", b["fc2"])
    for i in range(cfg.num_mask_tokens):
        for j, src in enumerate((f"hyper{i}_0", f"hyper{i}_1",
                                 f"hyper{i}_out")):
            lin(m + f"output_hypernetworks_mlps.{i}.layers.{j}", dec[src])
    for j, src in enumerate(("iou_fc0", "iou_fc1", "iou_head")):
        lin(m + f"iou_prediction_head.layers.{j}", dec[src])
    return sd


# ---------------------------------------------------------------------------
# the cascade's segmenter
# ---------------------------------------------------------------------------

def canvas(raw, img_size: int, dtype):
    """u8 frames (N, H, W, 3) on the model's device -> normalised
    (N, S, S, 3) canvas in `dtype`: the reference predictor's
    resize-longest-side + pad, on the device. Bilinear, antialiased when it
    shrinks (`jax.image.resize`'s default, which the JAX package uses)."""
    h, w = raw.shape[-3], raw.shape[-2]
    scale = img_size / max(h, w)
    nh, nw = round(h * scale), round(w * scale)
    img = F.interpolate(raw.permute(0, 3, 1, 2).float(), size=(nh, nw),
                        mode="bilinear", align_corners=False, antialias=True)
    mean = torch.as_tensor(SAM_MEAN, device=raw.device)[:, None, None]
    std = torch.as_tensor(SAM_STD, device=raw.device)[:, None, None]
    img = (img - mean) / std
    out = torch.zeros((raw.shape[0], 3, img_size, img_size),
                      device=raw.device)
    out[:, :, :nh, :nw] = img
    return out.permute(0, 2, 3, 1).to(dtype)


def unresize(logits, img_size: int, h: int, w: int):
    """Mask logits (M, g4, g4) fp32 -> (M, h, w) bool: interpolate to the
    canvas, crop the valid region, interpolate to the frame, both bilinear
    without antialiasing (the reference predictor's torch postprocess)."""
    scale = img_size / max(h, w)
    nh, nw = round(h * scale), round(w * scale)
    full = F.interpolate(logits[:, None], size=(img_size, img_size),
                         mode="bilinear", align_corners=False)
    small = F.interpolate(full[..., :nh, :nw], size=(h, w), mode="bilinear",
                          align_corners=False)
    return small[:, 0] > 0


def _check_canvas(sd, cfg: SamConfig) -> None:
    """A checkpoint's global blocks fix the canvas (their rel-pos tables
    span the whole grid); serving on another canvas needs those tables
    resized, which the port does not do yet."""
    for i in cfg.global_blocks:
        rows = sd[f"image_encoder.blocks.{i}.attn.rel_pos_h"].shape[0]
        if rows != 2 * cfg.grid - 1:
            raise ValueError(
                f"SAM on a {cfg.img_size} px canvas needs {2 * cfg.grid - 1}"
                f"-row rel-pos tables; the checkpoint's are {rows} rows (a "
                f"{(rows + 1) // 2 * cfg.patch_size} px canvas), and "
                f"resizing them is not ported")


def build_sam_segmenter(checkpoint_path: str | None = None,
                        cfg: SamConfig | None = None, max_boxes: int = 16,
                        compute_dtype=None, device="cuda"):
    """segmenter(rgb, boxes_xyxy) -> (M, H, W) bool, the cascade's stage-3
    callable, with the reference predictor's resize-longest-side-1024
    transform and mask un-resize on the device. Also exposes
    `segmenter.segment_batch(frames, boxes_list)`, one encoder batch for a
    chunk of frames, `segmenter.model`, and `segmenter.encodes`, a count of
    image-encoder runs (each runs every global block once).

    Weights: an official `sam_vit_*.pth` (`checkpoint_path`; sized from the
    file unless `cfg` is given; the canvas is the file's, 1024 px for the
    official checkpoints, and another raises), or random weights of `cfg` from seed 0
    (the JAX package's weights-free default is ViT-B).
    bf16 inference by default (`models/precision.py`); box prompts stay fp32
    and mask logits are upcast to fp32 before the `> 0` test.

    The image is encoded once per frame and the boxes decoded in chunks of
    `max_boxes` (the JAX segmenter re-runs the encoder for every chunk; the
    encoder does not see the boxes, so the masks are the same)."""
    dev = resolve_device(device)
    dt = resolve_compute_dtype(compute_dtype)
    if checkpoint_path:
        sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        cfg = cfg or sam_config_from_state_dict(sd)
        _check_canvas(sd, cfg)
        model = Sam(cfg)
        model.load_state_dict(official_state_dict(sd), strict=True)
    else:
        cfg = cfg or SAM_B
        model = Sam(cfg).to(dev)
        init_params(model, torch.Generator(device=dev).manual_seed(0))
    model = model.to(device=dev, dtype=dt).eval()

    def _prep_boxes(rgb_shape, boxes_xyxy):
        scale = cfg.img_size / max(rgb_shape[:2])
        return torch.as_tensor(np.asarray(boxes_xyxy, np.float32) * scale,
                               device=dev)

    def _masks(emb, raw_shape, boxes_xyxy):
        h, w = raw_shape[:2]
        bx = np.asarray(boxes_xyxy, np.float32).reshape(-1, 4)
        outs = []
        for start in range(0, len(bx), max_boxes):
            logits, _ = model.decode(emb, _prep_boxes(raw_shape,
                                                      bx[start:start + max_boxes]))
            outs.append(unresize(logits.float(), cfg.img_size, h, w))
        if not outs:
            return np.zeros((0, h, w), bool)
        return torch.cat(outs).cpu().numpy()

    @torch.no_grad()
    def segmenter(rgb, boxes_xyxy):
        raw = np.asarray(rgb, np.uint8)
        if not len(boxes_xyxy):
            return np.zeros((0,) + raw.shape[:2], bool)
        x = torch.as_tensor(raw, device=dev)[None]
        emb = model.image_encoder(canvas(x, cfg.img_size, dt))[0]
        segmenter.encodes += 1
        return _masks(emb, raw.shape, boxes_xyxy)

    @torch.no_grad()
    def segment_batch(frames, boxes_list):
        frames = [np.asarray(f, np.uint8) for f in frames]
        if not frames:
            return []
        if any(f.shape != frames[0].shape for f in frames):
            return [segmenter(f, b) for f, b in zip(frames, boxes_list)]
        x = torch.as_tensor(np.stack(frames), device=dev)
        embs = model.image_encoder(canvas(x, cfg.img_size, dt))
        segmenter.encodes += 1
        return [_masks(e, f.shape, b)
                for e, f, b in zip(embs, frames, boxes_list)]

    segmenter.segment_batch = segment_batch
    segmenter.model = model
    segmenter.encodes = 0
    return segmenter
