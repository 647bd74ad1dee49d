"""Swin Transformer backbone, the image tower of GroundingDINO (Swin-B) and
of RAM (Swin-L at 384 px) (counterpart of
`instance_based_loc_tpu/models/swin.py`).

Numerically the Hugging Face `SwinBackbone` the GroundingDINO checkpoints are
distributed in: per-block zero padding to window multiples, the shift and
window never shrunk to the input (`always_partition`), the shifted-window
mask built on the padded map with fill -100, patch merging in quadrant
order (r0c0, r1c0, r0c1, r1c1) then LayerNorm(4C) then Linear(4C -> 2C, no
bias), and per-output-stage LayerNorms (`hidden_states_norms`).

Submodules carry the HF key names (`embeddings.patch_embeddings.projection`,
`encoder.layers.{s}.blocks.{i}.attention.self.query`, ...), so the backbone
part of a GroundingDINO `.bin` loads with `load_state_dict` as it is
(without its `relative_position_index` buffers, which are computed here).
RAM's checkpoint holds its Swin in timm's layout (`layers.{s}.blocks.{i}
.attn.qkv`, `.attn.proj`, `.norm1`, `.mlp.fc1`, ...): `swin_params_from_timm`
maps it onto these names. Activations are NHWC, as in the JAX package.

`SwinConfig.adapt_window` is timm's rule, which RAM's backbone follows: a
stage whose map is no larger than the window runs one window of the map's
size, unshifted (Swin-L/384's last stage: 12x12, window 12, shift 0).
`SwinTransformer` is the whole backbone with its final LayerNorm and the
mean-pooled output (JAX `SwinTransformer`'s "pooled").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 128                       # Swin-B (192 for Swin-L)
    depths: tuple = (2, 2, 18, 2)
    num_heads: tuple = (4, 8, 16, 32)
    window: int = 7
    mlp_ratio: float = 4.0
    backbone_norms: bool = False               # per-stage output LayerNorms
    img_size: int = 224                        # sets the stages' resolutions
    # timm / HF SwinModel: a stage whose map is at most `window` wide runs
    # one unshifted window of the map's size (GroundingDINO's SwinBackbone
    # path keeps the window: False)
    adapt_window: bool = False

    def stage_window(self, stage: int) -> tuple[int, bool]:
        """(window, shifted blocks allowed) of a stage at `img_size`."""
        res = -(-self.img_size // self.patch_size)
        for _ in range(stage):
            res = (res + 1) // 2
        if self.adapt_window and res <= self.window:
            return res, False
        return self.window, True


def _rel_bias_index(window: int) -> np.ndarray:
    """(win^2, win^2) indices into the (2w-1)^2 relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64)


def _shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, win^2, win^2) mask so shifted windows do not attend across the
    wrap; h, w are the padded dims, fill -100 as in HF Swin."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(h // window, window, w // window, window)
    img = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    return np.where(img[:, :, None] != img[:, None, :], -100.0, 0.0).astype(
        np.float32)


class SwinSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.window = window
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))

    def forward(self, x, attn_mask=None):
        """x (nW * B, win^2, C); attn_mask (nW, win^2, win^2) or None."""
        bnw, n, c = x.shape
        dh = c // self.heads

        def split(y):
            return y.reshape(bnw, n, self.heads, dh)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        attn = torch.einsum("bqhd,bkhd->bhqk", q * dh ** -0.5, k)
        idx = torch.as_tensor(_rel_bias_index(self.window).reshape(-1),
                              device=x.device)
        bias = self.relative_position_bias_table[idx].reshape(n, n,
                                                              self.heads)
        attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
        if attn_mask is not None:
            nw = attn_mask.shape[0]
            attn = attn.reshape(bnw // nw, nw, self.heads, n, n)
            attn = attn + attn_mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(bnw, self.heads, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(bnw, n, c)


class _Dense(nn.Module):
    """A module holding one Linear as `dense` (HF's output/intermediate)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.dense = nn.Linear(dim_in, dim_out)

    def forward(self, x):
        return self.dense(x)


class SwinAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.self = SwinSelfAttention(dim, heads, window)
        self.output = _Dense(dim, dim)

    def forward(self, x, attn_mask=None):
        return self.output(self.self(x, attn_mask))


class SwinLayer(nn.Module):
    """One Swin block (HF `SwinLayer`)."""

    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 mlp_ratio: float):
        super().__init__()
        self.window = window
        self.shift = shift
        self.layernorm_before = nn.LayerNorm(dim, eps=1e-5)
        self.attention = SwinAttention(dim, heads, window)
        self.layernorm_after = nn.LayerNorm(dim, eps=1e-5)
        self.intermediate = _Dense(dim, int(dim * mlp_ratio))
        self.output = _Dense(int(dim * mlp_ratio), dim)

    def forward(self, x):
        """x (B, H, W, C); pads to window multiples inside the block."""
        b, h, w, c = x.shape
        win = self.window
        shortcut = x
        x = self.layernorm_before(x)
        pad_h, pad_w = (-h) % win, (-w) % win
        hp, wp = h + pad_h, w + pad_w
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        mask = None
        if self.shift:
            x = torch.roll(x, (-self.shift, -self.shift), dims=(1, 2))
            mask = torch.as_tensor(_shift_attn_mask(hp, wp, win, self.shift),
                                   device=x.device)
        xw = x.reshape(b, hp // win, win, wp // win, win, c)
        xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)
        xw = self.attention(xw, mask)
        x = xw.reshape(b, hp // win, wp // win, win, win, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if self.shift:
            x = torch.roll(x, (self.shift, self.shift), dims=(1, 2))
        x = shortcut + x[:, :h, :w]
        y = F.gelu(self.intermediate(self.layernorm_after(x)),
                   approximate="none")
        return x + self.output(y)


class SwinPatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)

    def forward(self, x):
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, cfg: SwinConfig, stage: int):
        super().__init__()
        c = cfg
        dim = c.embed_dim * 2 ** stage
        win, shifted = c.stage_window(stage)
        self.blocks = nn.ModuleList(
            SwinLayer(dim, c.num_heads[stage], win,
                      win // 2 if shifted and i % 2 else 0, c.mlp_ratio)
            for i in range(c.depths[stage]))
        self.downsample = (SwinPatchMerging(dim)
                           if stage < len(c.depths) - 1 else None)


class SwinEmbeddings(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.patch_embeddings = nn.Module()
        self.patch_embeddings.projection = nn.Conv2d(
            3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5)


class SwinEncoder(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.layers = nn.ModuleList(SwinStage(cfg, s)
                                    for s in range(len(cfg.depths)))


class SwinBackbone(nn.Module):
    """images (B, H, W, 3) -> the features of `out_stages` (0-based), each
    (B, h, w, C_s) before that stage's downsampling, through its
    `hidden_states_norms` LayerNorm when `cfg.backbone_norms`."""

    def __init__(self, cfg: SwinConfig, out_stages: tuple):
        super().__init__()
        self.cfg = cfg
        self.out_stages = tuple(out_stages)
        self.embeddings = SwinEmbeddings(cfg)
        self.encoder = SwinEncoder(cfg)
        if cfg.backbone_norms:
            self.hidden_states_norms = nn.ModuleDict({
                f"stage{s + 1}": nn.LayerNorm(cfg.embed_dim * 2 ** s, eps=1e-5)
                for s in self.out_stages})

    def stages(self, images, last: int):
        """Yields (stage, its features before downsampling) for stages 0 to
        `last`; later stages are not run."""
        c = self.cfg
        _, ih, iw, _ = images.shape
        pad_h, pad_w = (-ih) % c.patch_size, (-iw) % c.patch_size
        if pad_h or pad_w:
            images = F.pad(images, (0, 0, 0, pad_w, 0, pad_h))
        x = self.embeddings.patch_embeddings.projection(
            images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = self.embeddings.norm(x)
        for s, stage in enumerate(self.encoder.layers):
            for block in stage.blocks:
                x = block(x)
            yield s, x
            if s == last:
                return
            x = stage.downsample(x)

    def _out(self, s: int, x):
        if self.cfg.backbone_norms:
            return self.hidden_states_norms[f"stage{s + 1}"](x)
        return x

    def forward(self, images):
        return [self._out(s, x)
                for s, x in self.stages(images, max(self.out_stages))
                if s in self.out_stages]


class SwinTransformer(SwinBackbone):
    """The whole backbone (JAX `SwinTransformer`): images (B, H, W, 3) ->
    {"c2".."c5": each stage's features before downsampling (B, h, w, C_s),
    "pooled": the mean over the map of the last stage through the final
    LayerNorm `layernorm` (B, C_final)}."""

    def __init__(self, cfg: SwinConfig):
        super().__init__(cfg, tuple(range(len(cfg.depths))))
        self.layernorm = nn.LayerNorm(
            cfg.embed_dim * 2 ** (len(cfg.depths) - 1), eps=1e-5)

    def forward(self, images):
        feats = {}
        for s, x in self.stages(images, len(self.cfg.depths) - 1):
            feats[f"c{s + 2}"] = self._out(s, x)
        feats["pooled"] = self.layernorm(x).mean(dim=(1, 2))
        return feats


def swin_params_from_jax(p: dict, cfg: SwinConfig, out_stages: tuple,
                         pooled: bool = False) -> dict:
    """The JAX `SwinTransformer`'s tree as this backbone's state dict (the
    JAX module's fused qkv splits into query, key, value); `pooled` takes
    its `final_norm` too, for `SwinTransformer`."""
    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32))

    sd = {}

    def lin(dst, leaf):
        sd[dst + ".weight"] = t(np.asarray(leaf["kernel"]).T)
        if "bias" in leaf:
            sd[dst + ".bias"] = t(leaf["bias"])

    def ln(dst, leaf):
        sd[dst + ".weight"] = t(leaf["scale"])
        sd[dst + ".bias"] = t(leaf["bias"])

    sd["embeddings.patch_embeddings.projection.weight"] = t(
        np.asarray(p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    sd["embeddings.patch_embeddings.projection.bias"] = t(
        p["patch_embed"]["bias"])
    ln("embeddings.norm", p["patch_norm"])
    for s, depth in enumerate(cfg.depths):
        for i in range(depth):
            blk = p[f"stage{s}_block{i}"]
            dst = f"encoder.layers.{s}.blocks.{i}."
            ln(dst + "layernorm_before", blk["norm1"])
            ln(dst + "layernorm_after", blk["norm2"])
            kernel = np.asarray(blk["attn"]["qkv"]["kernel"])
            bias = np.asarray(blk["attn"]["qkv"]["bias"])
            dim = kernel.shape[0]
            for j, name in enumerate(("query", "key", "value")):
                lin(dst + f"attention.self.{name}",
                    {"kernel": kernel[:, j * dim:(j + 1) * dim],
                     "bias": bias[j * dim:(j + 1) * dim]})
            sd[dst + "attention.self.relative_position_bias_table"] = \
                t(blk["attn"]["rel_bias_table"])
            lin(dst + "attention.output.dense", blk["attn"]["proj"])
            lin(dst + "intermediate.dense", blk["fc1"])
            lin(dst + "output.dense", blk["fc2"])
        if s < len(cfg.depths) - 1:
            ln(f"encoder.layers.{s}.downsample.norm", p[f"merge{s}"]["norm"])
            lin(f"encoder.layers.{s}.downsample.reduction",
                p[f"merge{s}"]["reduction"])
    if cfg.backbone_norms:
        for s in out_stages:
            ln(f"hidden_states_norms.stage{s + 1}", p[f"outnorm{s}"])
    if pooled:
        ln("layernorm", p["final_norm"])
    return sd


def swin_params_from_timm(sd: dict, cfg: SwinConfig, prefix: str = "") -> dict:
    """A timm-layout Swin state dict (RAM's `visual_encoder.*`, under
    `prefix`) as `SwinTransformer`'s fp32 state dict: the fused `attn.qkv`
    splits into query, key and value (rows q, k, v); the timm model has no
    final LayerNorm of its own here (RAM's `norm` is the tagger's
    `vis_norm`), so `layernorm` is the identity. timm's
    `relative_position_index` and `attn_mask` buffers are computed here."""
    def t(name):
        v = sd[prefix + name]
        if isinstance(v, torch.Tensor):
            return v.detach().to("cpu", torch.float32).clone()
        return torch.as_tensor(np.asarray(v, dtype=np.float32))

    out = {}

    def copy(dst, src, parts=("weight", "bias")):
        for part in parts:
            out[f"{dst}.{part}"] = t(f"{src}.{part}")

    copy("embeddings.patch_embeddings.projection", "patch_embed.proj")
    copy("embeddings.norm", "patch_embed.norm")
    for s, depth in enumerate(cfg.depths):
        for i in range(depth):
            src, dst = f"layers.{s}.blocks.{i}.", f"encoder.layers.{s}.blocks.{i}."
            copy(dst + "layernorm_before", src + "norm1")
            copy(dst + "layernorm_after", src + "norm2")
            for part in ("weight", "bias"):
                qkv = t(f"{src}attn.qkv.{part}").chunk(3)
                for name, val in zip(("query", "key", "value"), qkv):
                    out[f"{dst}attention.self.{name}.{part}"] = val.clone()
            out[dst + "attention.self.relative_position_bias_table"] = t(
                src + "attn.relative_position_bias_table")
            copy(dst + "attention.output.dense", src + "attn.proj")
            copy(dst + "intermediate.dense", src + "mlp.fc1")
            copy(dst + "output.dense", src + "mlp.fc2")
        if s < len(cfg.depths) - 1:
            copy(f"encoder.layers.{s}.downsample.norm",
                 f"layers.{s}.downsample.norm")
            copy(f"encoder.layers.{s}.downsample.reduction",
                 f"layers.{s}.downsample.reduction", ("weight",))
    final = cfg.embed_dim * 2 ** (len(cfg.depths) - 1)
    out["layernorm.weight"] = torch.ones(final)
    out["layernorm.bias"] = torch.zeros(final)
    return out
