"""BERT text encoder, GroundingDINO's text tower (counterpart of
`instance_based_loc_tpu/models/bert.py`).

Numerically the Hugging Face `BertModel` (post-LayerNorm encoder, exact
gelu, no pooler), with GroundingDINO's per-phrase block-diagonal (B, T, T)
self-attention mask and explicit position ids (each phrase restarts at 0).
Submodules carry the HF key names, so the text part of a GroundingDINO
`.bin` loads with `load_state_dict` as it is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, d)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, d)
        self.LayerNorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)

    def forward(self, x, attn_bias):
        b, t, d = x.shape
        dh = d // self.heads

        def split(y):
            return y.reshape(b, t, self.heads, dh)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5 + attn_bias
        probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, d)


class _DenseNorm(nn.Module):
    """HF's `BertSelfOutput` / `BertOutput`: dense, then LayerNorm of the
    residual sum."""

    def __init__(self, dim_in: int, dim: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(dim_in, dim)
        self.LayerNorm = nn.LayerNorm(dim, eps=eps)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = _DenseNorm(cfg.hidden_size, cfg.hidden_size,
                                 cfg.layer_norm_eps)

    def forward(self, x, attn_bias):
        return self.output(self.self(x, attn_bias), x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x), approximate="none")


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = _DenseNorm(cfg.intermediate_size, cfg.hidden_size,
                                 cfg.layer_norm_eps)

    def forward(self, x, attn_bias):
        x = self.attention(x, attn_bias)
        return self.output(self.intermediate(x), x)


class BertEncoderLayers(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_layers))


class BertEncoder(nn.Module):
    """input_ids (B, T), allowed (B, T, T) bool (the pairs a token may
    attend to: GroundingDINO's block-diagonal mask), position_ids (B, T) ->
    last hidden state (B, T, D); token types are all 0. `word_embeds`
    (B, T, D): word-embedding rows looked up by the caller (the grounder
    does it on the host), used in place of `embeddings.word_embeddings`."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoderLayers(cfg)

    def forward(self, input_ids, allowed, position_ids, word_embeds=None):
        emb = self.embeddings
        if word_embeds is None:
            word_embeds = emb.word_embeddings(input_ids.long())
        dtype = emb.position_embeddings.weight.dtype
        x = (word_embeds.to(dtype) + emb.position_embeddings(position_ids.long())
             + emb.token_type_embeddings.weight[0])
        x = emb.LayerNorm(x)
        attn_bias = ((1.0 - allowed[:, None].to(x.dtype))
                     * torch.finfo(x.dtype).min)
        for layer in self.encoder.layer:
            x = layer(x, attn_bias)
        return x


def bert_params_from_jax(p: dict, cfg: BertConfig) -> dict:
    """The JAX `BertEncoder`'s parameter tree as this module's state dict."""
    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32))

    sd = {}

    def lin(dst, leaf):
        sd[dst + ".weight"] = t(np.asarray(leaf["kernel"]).T)
        sd[dst + ".bias"] = t(leaf["bias"])

    def ln(dst, leaf):
        sd[dst + ".weight"] = t(leaf["scale"])
        sd[dst + ".bias"] = t(leaf["bias"])

    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        sd[f"embeddings.{name}.weight"] = t(p[name]["embedding"])
    ln("embeddings.LayerNorm", p["embed_norm"])
    for i in range(cfg.num_layers):
        blk, dst = p[f"layer{i}"], f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            lin(dst + f"attention.self.{name}", blk[name])
        lin(dst + "attention.output.dense", blk["attn_out"])
        ln(dst + "attention.output.LayerNorm", blk["attn_norm"])
        lin(dst + "intermediate.dense", blk["fc1"])
        lin(dst + "output.dense", blk["fc2"])
        ln(dst + "output.LayerNorm", blk["out_norm"])
    return sd
