"""CLIP's text encoder for clip_loc (counterpart of
`instance_based_loc_tpu/models/clip_text.py`; reference
`clip_loc/clip_utils.py:8-54`, which embeds object names with CLIP's text
tower to match them against crop embeddings).

Token embedding plus learned positions, a causal pre-LayerNorm transformer,
a final LayerNorm, the features of the EOT token (the largest id of a
zero-padded sequence) and a linear projection. `port_hf_clip_text_params`
maps a `transformers` CLIPTextModel state dict onto this module.

Tokenization: with a CLIP `vocab.json` and `merges.txt` the byte-level BPE
(`models/bpe.py`); otherwise `SimpleTokenizer`, a deterministic hash of
each word into the vocabulary (the JAX package's weights-free fallback,
giving the same ids).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from .. import resolve_device
from .vit import _f32


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    max_length: int = 77
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    mlp_dim: int = 2048
    projection_dim: int = 512
    layernorm_eps: float = 1e-5
    use_quick_gelu: bool = True
    dtype: torch.dtype = torch.float32


class TextBlock(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        c = self.cfg = cfg
        self.ln1 = nn.LayerNorm(c.hidden_size, eps=c.layernorm_eps)
        self.qkv = nn.Linear(c.hidden_size, 3 * c.hidden_size)
        self.out = nn.Linear(c.hidden_size, c.hidden_size)
        self.ln2 = nn.LayerNorm(c.hidden_size, eps=c.layernorm_eps)
        self.fc1 = nn.Linear(c.hidden_size, c.mlp_dim)
        self.fc2 = nn.Linear(c.mlp_dim, c.hidden_size)

    def forward(self, x, causal):
        c = self.cfg
        b, s, e = x.shape
        dh = e // c.num_heads
        qkv = self.qkv(self.ln1(x)).reshape(b, s, 3, c.num_heads, dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scores = torch.einsum("bqhd,bkhd->bhqk", q * dh ** -0.5, k)
        scores = scores.masked_fill(~causal, -1e30)
        attn = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, s, e)
        x = x + self.out(o)
        h = self.fc1(self.ln2(x))
        h = (h * torch.sigmoid(1.702 * h) if c.use_quick_gelu
             else F.gelu(h, approximate="none"))
        return x + self.fc2(h)


class ClipTextEncoder(nn.Module):
    """token_ids (B, L) -> (B, projection_dim), the EOT token's features
    (at argmax of the ids) through `proj`."""

    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        c = self.cfg = cfg
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.pos_embed = nn.Parameter(torch.zeros(c.max_length,
                                                  c.hidden_size))
        self.blocks = nn.ModuleList(TextBlock(c) for _ in range(c.num_layers))
        self.ln_final = nn.LayerNorm(c.hidden_size, eps=c.layernorm_eps)
        self.proj = nn.Linear(c.hidden_size, c.projection_dim, bias=False)

    def forward(self, token_ids):
        b, s = token_ids.shape
        x = self.token_embedding(token_ids) + self.pos_embed[:s]
        causal = torch.ones(s, s, dtype=torch.bool,
                            device=token_ids.device).tril()
        for block in self.blocks:
            x = block(x, causal)
        x = self.ln_final(x)
        eot = torch.argmax(token_ids, dim=-1)
        return self.proj(x[torch.arange(b, device=x.device), eot])


def init_params(model: ClipTextEncoder, generator: torch.Generator) -> None:
    """Seeded random weights drawn on the model's device: lecun-normal
    Linear weights and zero biases, unit LayerNorms, N(0, 1/sqrt(width))
    token embeddings and N(0, 0.01) positions (the JAX module's flax
    initialisers' scales)."""
    def normal(p, std):
        return std * torch.randn(p.shape, generator=generator, device=p.device)

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, nn.Linear):
                module.weight.copy_(normal(module.weight,
                                           module.weight.shape[1] ** -0.5))
                if module.bias is not None:
                    module.bias.zero_()
        e = model.cfg.hidden_size
        model.token_embedding.weight.copy_(
            normal(model.token_embedding.weight, e ** -0.5))
        model.pos_embed.copy_(normal(model.pos_embed, 0.01))


def port_hf_clip_text_params(state_dict: dict, cfg: ClipTextConfig,
                             text_projection=None) -> dict:
    """A `transformers.CLIPTextModel` state dict (keys with or without
    `text_model.`) as this module's fp32 state dict (JAX
    `port_hf_clip_text_params`). The projection is `text_projection` if
    given, else the state dict's `text_projection.weight` (a CLIPModel or
    CLIPTextModelWithProjection file), else the identity, as in the JAX
    package, which never reads the file's projection."""
    sd = {k.removeprefix("text_model."): v for k, v in state_dict.items()}
    out = {
        "token_embedding.weight": _f32(sd["embeddings.token_embedding.weight"]),
        "pos_embed": _f32(sd["embeddings.position_embedding.weight"]),
        "ln_final.weight": _f32(sd["final_layer_norm.weight"]),
        "ln_final.bias": _f32(sd["final_layer_norm.bias"]),
    }
    for i in range(cfg.num_layers):
        src, dst = f"encoder.layers.{i}.", f"blocks.{i}."
        for part in ("weight", "bias"):
            out[f"{dst}qkv.{part}"] = torch.cat(
                [_f32(sd[f"{src}self_attn.{n}_proj.{part}"]) for n in "qkv"])
            for a, b in (("out", "self_attn.out_proj"), ("ln1", "layer_norm1"),
                         ("ln2", "layer_norm2"), ("fc1", "mlp.fc1"),
                         ("fc2", "mlp.fc2")):
                out[f"{dst}{a}.{part}"] = _f32(sd[f"{src}{b}.{part}"])
    if text_projection is None:
        text_projection = sd.get("text_projection.weight", torch.eye(
            cfg.projection_dim, cfg.hidden_size))
    out["proj.weight"] = _f32(text_projection)
    return out


class SimpleTokenizer:
    """Deterministic hash-bucket tokenizer for weights-free runs: each
    lowercased word's md5 picks an id in [1, vocab_size - 3]; SOT and EOT
    are the two last ids; zero padding."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def __call__(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.max_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot]
            for word in text.lower().split()[: self.max_length - 2]:
                h = int(hashlib.md5(word.encode()).hexdigest(), 16)
                ids.append(h % (self.vocab_size - 3) + 1)
            ids.append(self.eot)
            out[i, : len(ids)] = ids
        return out


def build_clip_text_embedder(checkpoint_path: str | None = None,
                             tokenizer=None, cfg: ClipTextConfig | None = None,
                             vocab_path: str | None = None,
                             merges_path: str | None = None, device="cuda"):
    """text_embed_fn(text) -> (projection_dim,) numpy, the callable
    `ClipLocObjectMemory.from_object_memory` takes, with `.model`.

    Weights: an HF CLIPTextModel state dict (`checkpoint_path`), or random
    weights of `cfg` from seed 0. Tokens: `tokenizer` if given, else the
    CLIP BPE with `vocab_path` and `merges_path`, else `SimpleTokenizer`."""
    cfg = cfg or ClipTextConfig()
    dev = resolve_device(device)
    model = ClipTextEncoder(cfg)
    if checkpoint_path:
        sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        model.load_state_dict(port_hf_clip_text_params(sd, cfg))
        model = model.to(dev)
    else:
        model = model.to(dev)
        init_params(model, torch.Generator(device=dev).manual_seed(0))
    model = model.to(dtype=cfg.dtype).eval()
    if tokenizer is None and vocab_path and merges_path:
        from .bpe import ClipBPETokenizer
        bpe = ClipBPETokenizer(vocab_path, merges_path,
                               context_length=cfg.max_length)

        def tokenizer(texts):
            return np.asarray([bpe.encode(t) for t in texts], np.int32)
    tok = tokenizer or SimpleTokenizer(cfg.vocab_size, cfg.max_length)

    @torch.no_grad()
    def embed(text: str) -> np.ndarray:
        ids = torch.as_tensor(np.asarray(tok([text]), np.int64), device=dev)
        return model(ids)[0].float().cpu().numpy()

    embed.model = model
    return embed
