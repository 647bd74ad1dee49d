"""RAM (Recognize Anything), the cascade's open-set tagger (counterpart of
`instance_based_loc_tpu/models/ram.py`; reference `ram_swin_large_14m` at
384 px, whose tags become GroundingDINO's prompt).

The architecture (Zhang et al., 2023, query2label tagging):

* a Swin-L backbone at 384 px (`models/swin.py`, timm's window rule); its
  last stage's tokens go through `vis_norm` and a mean token is prepended
  (145 x 1536 at Swin-L/384);
* `image_proj` (1536 -> 512) makes the cross-attention memory;
* one learned label embedding per tag (num_tags x 512) through
  `wordvec_proj` + ReLU gives the 768-wide tag queries;
* 2 decoder layers (`TagDecoderLayer`: self-attention over the tag queries,
  cross-attention to the image memory, FFN; BERT's post-LayerNorm layout);
* `fc` (768 -> 1) scores every tag; a tag is kept where its sigmoid passes
  its class threshold (the checkpoint's, else `threshold`).

The model runs in the compute type of `models/precision.py` (bf16 by
default: weights cast once, the image follows; attention softmax in fp32);
the logits are cast to fp32 before the sigmoid and the thresholds, as in
the JAX package. The tag vocabulary is data: `tag_list_path` names the
official `ram_tag_list.txt`, index-aligned with the checkpoint's label
embeddings. Without a checkpoint (and without `random_init`) the tagger
returns no tags and the cascade grounds the caption ["object"].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from .. import resolve_device
from .gdino import IMAGENET_MEAN, IMAGENET_STD, device_preprocess
from .precision import resolve_compute_dtype
from .swin import (SwinConfig, SwinTransformer, swin_params_from_jax,
                   swin_params_from_timm)

# A compact indoor-object vocabulary standing in for RAM's 4585-tag list
# when no tag list is given (the JAX package's list).
DEFAULT_TAG_VOCAB = (
    "chair table sofa lamp plant bed cabinet shelf monitor keyboard cup "
    "bottle book box bag pillow curtain door window sink toilet bathtub "
    "refrigerator oven microwave television couch desk stool bench vase "
    "bin crate barrel toy floor ground wall ceiling person"
).split()

RAM_SWIN_L = SwinConfig(embed_dim=192, num_heads=(6, 12, 24, 48), window=12,
                        img_size=384, adapt_window=True)


@dataclasses.dataclass(frozen=True)
class RamConfig:
    backbone: SwinConfig = RAM_SWIN_L
    num_tags: int = 4585
    label_dim: int = 512          # label embedding / image memory width
    hidden: int = 768             # decoder query width
    heads: int = 4
    layers: int = 2
    mlp_dim: int = 3072


class TagDecoderLayer(nn.Module):
    """One Q2L layer: self-attention over the tag queries, cross-attention
    to the image memory, FFN; post-LayerNorm with eps 1e-12 and exact GELU
    (BERT's `BertLayer` with cross-attention, called without masks)."""

    def __init__(self, cfg: RamConfig):
        super().__init__()
        self.heads = cfg.heads
        d = cfg.hidden
        for prefix, kv_dim in (("self", d), ("cross", cfg.label_dim)):
            setattr(self, f"{prefix}_query", nn.Linear(d, d))
            setattr(self, f"{prefix}_key", nn.Linear(kv_dim, d))
            setattr(self, f"{prefix}_value", nn.Linear(kv_dim, d))
            setattr(self, f"{prefix}_out", nn.Linear(d, d))
            setattr(self, f"{prefix}_norm", nn.LayerNorm(d, eps=1e-12))
        self.fc1 = nn.Linear(d, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, d)
        self.out_norm = nn.LayerNorm(d, eps=1e-12)

    def _attend(self, x_q, x_kv, prefix):
        b, _, d = x_q.shape
        dh = d // self.heads

        def heads(y):
            return y.reshape(b, -1, self.heads, dh)

        q = heads(getattr(self, f"{prefix}_query")(x_q))
        k = heads(getattr(self, f"{prefix}_key")(x_kv))
        v = heads(getattr(self, f"{prefix}_value")(x_kv))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
        attn = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, -1, d)
        return getattr(self, f"{prefix}_out")(out)

    def forward(self, queries, memory):
        queries = self.self_norm(queries + self._attend(queries, queries,
                                                        "self"))
        queries = self.cross_norm(queries + self._attend(queries, memory,
                                                         "cross"))
        h = self.fc2(F.gelu(self.fc1(queries), approximate="none"))
        return self.out_norm(queries + h)


class Ram(nn.Module):
    """images (B, S, S, 3) normalised -> per-tag logits (B, num_tags)."""

    def __init__(self, cfg: RamConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        final = c.backbone.embed_dim * 2 ** (len(c.backbone.depths) - 1)
        self.backbone = SwinTransformer(c.backbone)
        self.vis_norm = nn.LayerNorm(final, eps=1e-5)
        self.image_proj = nn.Linear(final, c.label_dim)
        self.label_embed = nn.Parameter(torch.zeros(c.num_tags, c.label_dim))
        self.wordvec_proj = nn.Linear(c.label_dim, c.hidden)
        self.layers = nn.ModuleList(TagDecoderLayer(c)
                                    for _ in range(c.layers))
        self.fc = nn.Linear(c.hidden, 1)

    def forward(self, images):
        b = images.shape[0]
        last = self.backbone(images)[f"c{len(self.cfg.backbone.depths) + 1}"]
        # RAM's Swin forward: the final norm, then the global mean token
        tokens = self.vis_norm(last.reshape(b, -1, last.shape[-1]))
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        memory = self.image_proj(tokens)
        queries = F.relu(self.wordvec_proj(self.label_embed))
        queries = queries[None].expand(b, *queries.shape)
        for layer in self.layers:
            queries = layer(queries, memory)
        return self.fc(queries)[..., 0]


def init_params(model: Ram, generator: torch.Generator) -> None:
    """Seeded random weights drawn on the model's device with `generator`:
    LayerNorm scales 1 and biases 0, every other bias 0, every other
    parameter N(0, 0.02) (the cascade models' `init_params`)."""
    with torch.no_grad():
        for module in model.modules():
            for name, p in module.named_parameters(recurse=False):
                if name == "bias":
                    p.zero_()
                elif name == "weight" and isinstance(module, nn.LayerNorm):
                    p.fill_(1.0)
                else:
                    p.copy_(0.02 * torch.randn(p.shape, generator=generator,
                                               device=p.device))


_DECODER_KEYS = {
    "self_query": "attention.self.query", "self_key": "attention.self.key",
    "self_value": "attention.self.value",
    "self_out": "attention.output.dense",
    "self_norm": "attention.output.LayerNorm",
    "cross_query": "crossattention.self.query",
    "cross_key": "crossattention.self.key",
    "cross_value": "crossattention.self.value",
    "cross_out": "crossattention.output.dense",
    "cross_norm": "crossattention.output.LayerNorm",
    "fc1": "intermediate.dense", "fc2": "output.dense",
    "out_norm": "output.LayerNorm",
}


def port_ram_params(checkpoint_path: str, cfg: RamConfig):
    """The official `ram_swin_large_14m.pth` (timm-layout Swin under
    `visual_encoder.*`, the Q2L head under `tagging_head.*`) as `Ram`'s
    fp32 state dict. Returns (state dict, class thresholds (num_tags,) fp32
    or None)."""
    raw = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    sd = raw.get("model", raw)

    def t(k):
        return sd[k].detach().to(torch.float32).clone()

    out = {f"backbone.{k}": v for k, v in swin_params_from_timm(
        sd, cfg.backbone, prefix="visual_encoder.").items()}
    for dst, src in (("vis_norm", "visual_encoder.norm"),
                     ("image_proj", "image_proj"),
                     ("wordvec_proj", "wordvec_proj"), ("fc", "fc")):
        for part in ("weight", "bias"):
            out[f"{dst}.{part}"] = t(f"{src}.{part}")
    out["label_embed"] = t("label_embed")
    for i in range(cfg.layers):
        for dst, src in _DECODER_KEYS.items():
            for part in ("weight", "bias"):
                out[f"layers.{i}.{dst}.{part}"] = t(
                    f"tagging_head.encoder.layer.{i}.{src}.{part}")
    thresholds = None
    if "class_threshold" in sd:
        thresholds = t("class_threshold").numpy()
    return out, thresholds


def params_from_jax(variables: dict, cfg: RamConfig) -> dict:
    """The JAX `Ram`'s parameter tree (`{"params": ...}` or its inner dict,
    numpy or jax arrays) as this module's fp32 state dict."""
    p = variables.get("params", variables)

    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32))

    out = {f"backbone.{k}": v for k, v in swin_params_from_jax(
        p["backbone"], cfg.backbone, (), pooled=True).items()}

    def lin(dst, leaf):
        out[f"{dst}.weight"] = t(np.asarray(leaf["kernel"]).T)
        out[f"{dst}.bias"] = t(leaf["bias"])

    def ln(dst, leaf):
        out[f"{dst}.weight"] = t(leaf["scale"])
        out[f"{dst}.bias"] = t(leaf["bias"])

    ln("vis_norm", p["vis_norm"])
    for name in ("image_proj", "wordvec_proj", "fc"):
        lin(name, p[name])
    out["label_embed"] = t(p["label_embed"])
    for i in range(cfg.layers):
        for name in _DECODER_KEYS:
            leaf = p[f"layer{i}"][name]
            (ln if name.endswith("norm") else lin)(f"layers.{i}.{name}", leaf)
    return out


def build_ram_tagger(checkpoint_path: str | None = None,
                     tag_vocab: list[str] | None = None,
                     tag_list_path: str | None = None,
                     threshold: float = 0.68,
                     image_size: int = 384,
                     cfg: RamConfig | None = None,
                     compute_dtype=None,
                     random_init: bool = False,
                     device="cuda"):
    """tagger(rgb) -> list[str] for the cascade, with
    `tagger.tag_batch(frames) -> list[list[str]]` (frames of one size run
    as one batch; mixed sizes run frame by frame, as in the JAX package).

    Weights: the official `.pth` (`checkpoint_path`, class thresholds
    included), or `random_init=True`: random weights of `cfg` from seed 0,
    at full width by default. Without either the tagger returns no tags.
    `cfg` defaults to Swin-L at `image_size` with one tag per vocabulary
    entry. `tagger.model` and `tagger.forwards`, a count of model runs,
    are exposed."""
    if tag_list_path is not None:
        with open(tag_list_path, encoding="utf-8") as f:
            vocab = [line.strip() for line in f if line.strip()]
    else:
        vocab = list(tag_vocab or DEFAULT_TAG_VOCAB)

    if checkpoint_path is None and not random_init:
        def tagger(rgb):
            return []

        tagger.tag_batch = lambda frames: [[] for _ in frames]
        return tagger

    dev = resolve_device(device)
    dt = resolve_compute_dtype(compute_dtype)
    cfg = cfg or RamConfig(
        num_tags=len(vocab),
        backbone=dataclasses.replace(RAM_SWIN_L, img_size=image_size))
    model = Ram(cfg)
    if checkpoint_path is not None:
        sd, thresholds = port_ram_params(checkpoint_path, cfg)
        model.load_state_dict(sd)
    else:
        model = model.to(dev)
        init_params(model, torch.Generator(device=dev).manual_seed(0))
        thresholds = None
    if thresholds is None:
        thresholds = np.full((cfg.num_tags,), threshold, np.float32)
    model = model.to(dev, dt).eval()

    @torch.no_grad()
    def _probs(raw: np.ndarray) -> np.ndarray:
        img = device_preprocess(torch.as_tensor(raw, device=dev), image_size,
                                IMAGENET_MEAN, IMAGENET_STD)
        logits = model(img.to(dt))
        tagger.forwards += 1
        return torch.sigmoid(logits.float()).cpu().numpy()

    def _tags(probs: np.ndarray) -> list[str]:
        return [vocab[i] for i in np.nonzero(probs > thresholds)[0]
                if i < len(vocab)]

    def tagger(rgb) -> list[str]:
        return _tags(_probs(np.asarray(rgb, np.uint8)[None])[0])

    def tag_batch(frames) -> list[list[str]]:
        frames = [np.asarray(f, np.uint8) for f in frames]
        if not frames:
            return []
        if any(f.shape != frames[0].shape for f in frames):
            return [tagger(f) for f in frames]
        return [_tags(p) for p in _probs(np.stack(frames))]

    tagger.tag_batch = tag_batch
    tagger.model = model
    tagger.forwards = 0
    return tagger
