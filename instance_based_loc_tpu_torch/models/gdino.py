"""GroundingDINO, the cascade's detection stage (counterpart of
`instance_based_loc_tpu/models/gdino.py`).

The Hugging Face `GroundingDinoForObjectDetection` architecture, as the JAX
package computes it:

* Swin backbone (`models/swin.py`) -> 3-scale pyramid plus one stride-2
  conv level, 1x1 conv + GroupNorm(32) projections;
* BERT text tower (`models/bert.py`) with the block-diagonal per-phrase
  mask and per-phrase position ids;
* encoder: per layer, image<->text fusion (BiMultiHeadAttention with
  layer-scale residuals), text self-attention, and multi-scale deformable
  self-attention over the flattened pyramid (`ops/msda.py`, whose level-0
  gather is the hand-written CUDA kernel on the card);
* language-guided query selection, decoder with self-, text cross- and
  deformable cross-attention and iterative box refinement through one
  shared box head; contrastive logits padded to max_text_len.

Submodules carry the HF key names, so an HF `.bin` loads with
`load_state_dict(strict=True)` once its tied copies and computed buffers
are dropped (`hf_state_dict`). `params_from_jax` maps the JAX module's tree.
Images are NHWC. The text tower and its projection run in fp32 (in the JAX
package its fp32 host-side word embeddings promote them to fp32 too); the
rest runs in the compute type.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from .. import resolve_device
from ..ops.msda import multi_scale_deformable_attention
from .bert import BertConfig, BertEncoder, bert_params_from_jax
from .precision import resolve_compute_dtype
from .swin import SwinBackbone, SwinConfig, swin_params_from_jax
from .wordpiece import WordPieceTokenizer

# [CLS], [SEP], '.', '?' in the BERT vocab: phrase delimiters
SPECIAL_TOKEN_IDS = (101, 102, 1012, 1029)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass(frozen=True)
class GDinoConfig:
    # the grounding-dino-base checkpoint's Swin-B-384: window 12
    backbone: SwinConfig = dataclasses.field(
        default_factory=lambda: SwinConfig(backbone_norms=True, window=12))
    text: BertConfig = dataclasses.field(default_factory=BertConfig)
    img_size: int = 800                 # square resize side
    d_model: int = 256
    num_queries: int = 900
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_heads: int = 8
    decoder_heads: int = 8
    ffn_dim: int = 2048
    encoder_n_points: int = 4
    decoder_n_points: int = 4
    num_feature_levels: int = 4
    max_text_len: int = 256
    pos_temperature: float = 20.0
    out_stages: tuple = (1, 2, 3)       # swin stages feeding the pyramid


def make_text_masks(input_ids: np.ndarray):
    """GroundingDINO's block-diagonal text self-attention mask and
    per-phrase position ids (HF
    `generate_masks_with_special_tokens_and_transfer_map`):
    input_ids (B, T) -> (allowed (B, T, T) bool, position_ids (B, T))."""
    input_ids = np.asarray(input_ids)
    b, t = input_ids.shape
    special = np.zeros((b, t), bool)
    for sid in SPECIAL_TOKEN_IDS:
        special |= input_ids == sid
    allowed = np.broadcast_to(np.eye(t, dtype=bool), (b, t, t)).copy()
    position_ids = np.zeros((b, t), np.int64)
    for row in range(b):
        previous_col = 0
        for col in np.nonzero(special[row])[0]:
            if col == 0 or col == t - 1:
                allowed[row, col, col] = True
                position_ids[row, col] = 0
            else:
                allowed[row, previous_col + 1:col + 1,
                        previous_col + 1:col + 1] = True
                position_ids[row, previous_col + 1:col + 1] = np.arange(
                    0, col - previous_col)
            previous_col = col
    return allowed, position_ids


def sine_pos_2d(h: int, w: int, d_model: int, temperature: float):
    """(h * w, d_model) sine position embedding (HF GroundingDINO: cumsum of
    an all-ones mask, eps 1e-6, scale 2 pi, y then x), numpy fp32."""
    half = d_model // 2
    scale = 2 * math.pi
    y = (np.arange(h, dtype=np.float32) + 1.0) / (h + 1e-6) * scale
    x = (np.arange(w, dtype=np.float32) + 1.0) / (w + 1e-6) * scale
    dim_t = np.arange(half, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / half)
    py = y[:, None] / dim_t
    px = x[:, None] / dim_t
    py = np.stack([np.sin(py[:, 0::2]), np.cos(py[:, 1::2])], -1).reshape(h, -1)
    px = np.stack([np.sin(px[:, 0::2]), np.cos(px[:, 1::2])], -1).reshape(w, -1)
    pos = np.concatenate([np.broadcast_to(py[:, None], (h, w, half)),
                          np.broadcast_to(px[None, :], (h, w, half))], -1)
    return pos.reshape(h * w, d_model)


def get_sine_pos_embed(pos, num_pos_feats: int, temperature: float = 10000.0,
                       exchange_xy: bool = True):
    """(..., n) positions -> (..., n * num_pos_feats) sine embeddings (HF
    `get_sine_pos_embed`): per scalar, interleaved sin (even) / cos (odd)."""
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = torch.as_tensor(temperature ** (2 * (dim_t // 2) / num_pos_feats),
                            device=pos.device)

    def one(x):
        sx = x[..., None] * (2 * math.pi) / dim_t
        return torch.stack([torch.sin(sx[..., 0::2]), torch.cos(sx[..., 1::2])],
                           dim=-1).reshape(sx.shape[:-1] + (num_pos_feats,))

    embs = [one(pos[..., i]) for i in range(pos.shape[-1])]
    if exchange_xy and len(embs) >= 2:
        embs[0], embs[1] = embs[1], embs[0]
    return torch.cat(embs, dim=-1)


def _logit(x, eps=1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def _softmax(x, dim=-1):
    return torch.softmax(x.float(), dim=dim).to(x.dtype)


class MultiheadAttention(nn.Module):
    """HF GroundingDinoMultiheadAttention: separate q/k/v/out linears, an
    additive float mask, 1/sqrt(head_dim) scaling."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, queries, keys, values, attn_bias=None):
        b, nq, d = queries.shape
        dh = d // self.heads

        def split(y):
            return y.reshape(b, y.shape[1], self.heads, dh)

        q, k, v = (split(self.query(queries)), split(self.key(keys)),
                   split(self.value(values)))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
        if attn_bias is not None:
            scores = scores + attn_bias
        out = torch.einsum("bhqk,bkhd->bqhd", _softmax(scores), v)
        return self.out_proj(out.reshape(b, nq, d))


class BiMultiHeadAttention(nn.Module):
    """GLIP-style bi-directional image <-> text cross attention."""

    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        d, e = cfg.d_model, cfg.ffn_dim // 2
        self.heads = cfg.encoder_heads // 2
        self.vision_proj = nn.Linear(d, e)
        self.text_proj = nn.Linear(d, e)
        self.values_vision_proj = nn.Linear(d, e)
        self.values_text_proj = nn.Linear(d, e)
        self.out_vision_proj = nn.Linear(e, d)
        self.out_text_proj = nn.Linear(e, d)

    def forward(self, vision, text, text_pad_mask=None):
        """vision (B, S, D), text (B, T, D); text_pad_mask (B, T) True = pad.
        Returns (delta_vision, delta_text)."""
        b, s, _ = vision.shape
        t = text.shape[1]
        e = self.vision_proj.out_features
        dh = e // self.heads

        def split(y):
            return y.reshape(b, -1, self.heads, dh).transpose(1, 2)

        vq = split(self.vision_proj(vision) * dh ** -0.5)
        tk = split(self.text_proj(text))
        vv = split(self.values_vision_proj(vision))
        tv = split(self.values_text_proj(text))
        attn = torch.einsum("bhsd,bhtd->bhst", vq, tk).float()
        attn = (attn - attn.max()).clamp(-50000, 50000)
        attn_t = attn.transpose(2, 3)
        attn_t = (attn_t - attn_t.max(dim=-1, keepdim=True).values).clamp(
            -50000, 50000)
        if text_pad_mask is not None:
            attn = attn.masked_fill(text_pad_mask[:, None, None, :],
                                    float("-inf"))
        v_probs = torch.softmax(attn, dim=-1).to(tv.dtype)
        t_probs = torch.softmax(attn_t, dim=-1).to(vv.dtype)
        v_out = torch.einsum("bhst,bhtd->bhsd", v_probs, tv)
        t_out = torch.einsum("bhts,bhsd->bhtd", t_probs, vv)
        v_out = v_out.transpose(1, 2).reshape(b, s, e)
        t_out = t_out.transpose(1, 2).reshape(b, t, e)
        return self.out_vision_proj(v_out), self.out_text_proj(t_out)


class FusionLayer(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        d = cfg.d_model
        self.layer_norm_vision = nn.LayerNorm(d, eps=1e-5)
        self.layer_norm_text = nn.LayerNorm(d, eps=1e-5)
        self.attn = BiMultiHeadAttention(cfg)
        self.vision_param = nn.Parameter(torch.full((d,), 1e-4))
        self.text_param = nn.Parameter(torch.full((d,), 1e-4))

    def forward(self, vision, text, text_pad_mask=None):
        vision = self.layer_norm_vision(vision)
        text = self.layer_norm_text(text)
        dv, dt = self.attn(vision, text, text_pad_mask)
        return vision + self.vision_param * dv, text + self.text_param * dt


class TextEnhancerLayer(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = MultiheadAttention(d, cfg.encoder_heads // 2)
        self.fc1 = nn.Linear(d, cfg.ffn_dim // 2)
        self.fc2 = nn.Linear(cfg.ffn_dim // 2, d)
        self.layer_norm_before = nn.LayerNorm(d, eps=1e-5)
        self.layer_norm_after = nn.LayerNorm(d, eps=1e-5)

    def forward(self, text, attn_bias, pos_embed):
        qk = text + pos_embed
        text = self.layer_norm_before(
            text + self.self_attn(qk, qk, text, attn_bias))
        h = self.fc2(F.relu(self.fc1(text)))
        return self.layer_norm_after(text + h)


class DeformableAttention(nn.Module):
    """Multi-scale deformable attention block (HF
    GroundingDinoMultiscaleDeformableAttention)."""

    def __init__(self, cfg: GDinoConfig, heads: int, n_points: int):
        super().__init__()
        d, lv = cfg.d_model, cfg.num_feature_levels
        self.heads, self.n_points, self.n_levels = heads, n_points, lv
        self.sampling_offsets = nn.Linear(d, heads * lv * n_points * 2)
        self.attention_weights = nn.Linear(d, heads * lv * n_points)
        self.value_proj = nn.Linear(d, d)
        self.output_proj = nn.Linear(d, d)

    def forward(self, queries, value_src, reference_points, spatial_shapes):
        """queries (B, Q, D) with position embeddings added; value_src
        (B, S, D); reference_points (B, Q, L, 2 or 4) fp32."""
        b, q, d = queries.shape
        h, k, lv = self.heads, self.n_points, self.n_levels
        value = self.value_proj(value_src).reshape(b, -1, h, d // h)
        offsets = self.sampling_offsets(queries).float().reshape(
            b, q, h, lv, k, 2)
        weights = torch.softmax(self.attention_weights(queries).float()
                                .reshape(b, q, h, lv * k), dim=-1)
        weights = weights.reshape(b, q, h, lv, k)
        ref = reference_points.float()[:, :, None, :, None]
        if reference_points.shape[-1] == 2:
            normalizer = torch.tensor([(w_, h_) for (h_, w_) in spatial_shapes],
                                      dtype=torch.float32, device=queries.device)
            loc = ref + offsets / normalizer[None, None, None, :, None, :]
        else:
            loc = ref[..., :2] + offsets / k * ref[..., 2:] * 0.5
        out = multi_scale_deformable_attention(value, spatial_shapes, loc,
                                               weights)
        # MSDA accumulates in fp32; back to the stream type
        return self.output_proj(out.to(queries.dtype))


class DeformableLayer(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = DeformableAttention(cfg, cfg.encoder_heads,
                                             cfg.encoder_n_points)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, vision, pos_embed, reference_points, spatial_shapes):
        attn = self.self_attn(vision + pos_embed, vision, reference_points,
                              spatial_shapes)
        vision = self.self_attn_layer_norm(vision + attn)
        h = self.fc2(F.relu(self.fc1(vision)))
        return self.final_layer_norm(vision + h)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        self.text_enhancer_layer = TextEnhancerLayer(cfg)
        self.fusion_layer = FusionLayer(cfg)
        self.deformable_layer = DeformableLayer(cfg)

    def forward(self, vision, text, vision_pos, vision_ref, text_attn_bias,
                text_pos, text_pad_mask, spatial_shapes):
        vision, text = self.fusion_layer(vision, text, text_pad_mask)
        text = self.text_enhancer_layer(text, text_attn_bias, text_pos)
        vision = self.deformable_layer(vision, vision_pos, vision_ref,
                                       spatial_shapes)
        return vision, text


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = MultiheadAttention(d, cfg.decoder_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.encoder_attn_text = MultiheadAttention(d, cfg.decoder_heads)
        self.encoder_attn_text_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.encoder_attn = DeformableAttention(cfg, cfg.decoder_heads,
                                                cfg.decoder_n_points)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, hidden, query_pos, reference_points, vision, text,
                text_cross_bias, spatial_shapes):
        qk = hidden + query_pos
        hidden = self.self_attn_layer_norm(
            hidden + self.self_attn(qk, qk, hidden))
        hidden = self.encoder_attn_text_layer_norm(
            hidden + self.encoder_attn_text(hidden + query_pos, text, text,
                                            text_cross_bias))
        hidden = self.encoder_attn_layer_norm(
            hidden + self.encoder_attn(hidden + query_pos, vision,
                                       reference_points, spatial_shapes))
        h = self.fc2(F.relu(self.fc1(hidden)))
        return self.final_layer_norm(hidden + h)


class MLPHead(nn.Module):
    def __init__(self, dim_in: int, hidden: int, dim_out: int,
                 num_layers: int):
        super().__init__()
        dims = [dim_in] + [hidden] * (num_layers - 1) + [dim_out]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def _encoder_reference_points(shapes):
    """(S, L, 2) normalised per-level centre grids (valid ratios 1)."""
    pts = []
    for (h, w) in shapes:
        ry = (np.arange(h, dtype=np.float32) + 0.5) / h
        rx = (np.arange(w, dtype=np.float32) + 0.5) / w
        pts.append(np.stack(np.meshgrid(rx, ry, indexing="xy"), -1)
                   .reshape(-1, 2))
    ref = np.concatenate(pts, axis=0)
    return np.broadcast_to(ref[:, None], (ref.shape[0], len(shapes), 2))


def _proposals(shapes):
    """(S, 4) logit-space proposal boxes (HF
    generate_encoder_output_proposals) and their validity (S,)."""
    out = []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        grid = (np.stack([gx, gy], -1) + 0.5) / np.asarray([w, h], np.float32)
        wh = np.ones_like(grid) * 0.05 * 2.0 ** lvl
        out.append(np.concatenate([grid, wh], -1).reshape(-1, 4))
    props = np.concatenate(out, axis=0)
    valid = ((props > 0.01) & (props < 0.99)).all(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        logits = np.log(props / (1 - props))
    logits[~valid] = np.inf
    return logits, valid


class GroundingDinoModel(nn.Module):
    """HF `GroundingDinoModel`'s parameters (backbone, text tower,
    projections, encoder, decoder, query-selection heads)."""

    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        c = cfg
        d = c.d_model
        self.backbone = nn.Module()
        self.backbone.conv_encoder = nn.Module()
        self.backbone.conv_encoder.model = SwinBackbone(c.backbone,
                                                        c.out_stages)
        self.text_backbone = BertEncoder(c.text)
        self.text_projection = nn.Linear(c.text.hidden_size, d)
        chans = [c.backbone.embed_dim * 2 ** s for s in c.out_stages]
        projs = []
        for i in range(c.num_feature_levels):
            if i < len(chans):
                conv = nn.Conv2d(chans[i], d, 1)
            else:
                conv = nn.Conv2d(chans[-1] if i == len(chans) else d, d, 3,
                                 stride=2, padding=1)
            projs.append(nn.Sequential(conv, nn.GroupNorm(32, d, eps=1e-5)))
        self.input_proj_vision = nn.ModuleList(projs)
        self.level_embed = nn.Parameter(torch.zeros(c.num_feature_levels, d))
        self.query_position_embeddings = nn.Embedding(c.num_queries, d)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(EncoderLayer(c)
                                            for _ in range(c.encoder_layers))
        self.decoder = nn.Module()
        self.decoder.layers = nn.ModuleList(DecoderLayer(c)
                                            for _ in range(c.decoder_layers))
        self.decoder.layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.decoder.reference_points_head = MLPHead(2 * d, d, d, 2)
        self.enc_output = nn.Linear(d, d)
        self.enc_output_norm = nn.LayerNorm(d, eps=1e-5)
        self.encoder_output_bbox_embed = MLPHead(d, d, 4, 3)


class GroundingDino(nn.Module):
    """Two-stage grounded detector: (logits (B, Q, max_text_len) fp32,
    boxes (B, Q, 4) normalised cxcywh fp32). After a forward,
    `query_index` (B, Q) holds the encoder positions its query selection
    chose."""

    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        self.cfg = cfg
        self.model = GroundingDinoModel(cfg)
        self.bbox_embed = nn.ModuleList([MLPHead(cfg.d_model, cfg.d_model,
                                                 4, 3)])

    def forward(self, images, input_ids, text_allowed, position_ids,
                text_token_mask, text_embeds=None, query_index=None):
        """images (B, H, W, 3) normalised, in the compute type; input_ids
        (B, T); text_allowed (B, T, T) bool (make_text_masks); position_ids
        (B, T); text_token_mask (B, T) bool, True = real token.
        `text_embeds` (B, T, D_bert): word-embedding rows looked up on the
        host. `query_index` (B, Q): decode these encoder positions instead
        of the selected ones (so a run can be held against another query by
        query)."""
        c, m = self.cfg, self.model
        b = images.shape[0]
        adt = images.dtype
        dev = images.device

        text = m.text_backbone(input_ids, text_allowed, position_ids,
                               word_embeds=text_embeds)
        text = m.text_projection(text.to(m.text_projection.weight.dtype))
        text = text.to(adt)

        feats = m.backbone.conv_encoder.model(images)
        maps = []
        for i, proj in enumerate(m.input_proj_vision):
            if i < len(feats):
                src = feats[i].permute(0, 3, 1, 2)
            elif i == len(feats):
                src = feats[-1].permute(0, 3, 1, 2)
            else:
                src = maps[-1]
            maps.append(proj(src))
        flat, pos_list, shapes = [], [], []
        for lvl, mp in enumerate(maps):
            h, w = mp.shape[-2:]
            shapes.append((h, w))
            flat.append(mp.flatten(2).transpose(1, 2))
            pos_list.append(torch.as_tensor(
                sine_pos_2d(h, w, c.d_model, c.pos_temperature), device=dev)
                + m.level_embed[lvl].float()[None])
        memory = torch.cat(flat, dim=1)
        vision_pos = torch.cat(pos_list).to(adt)
        shapes = tuple(shapes)
        vision_ref = torch.as_tensor(
            np.ascontiguousarray(_encoder_reference_points(shapes)),
            device=dev)[None]

        neg = torch.finfo(adt).min
        zero = torch.zeros((), dtype=adt, device=dev)
        text_attn_bias = torch.where(text_allowed[:, None], zero,
                                     torch.full((), neg, dtype=adt,
                                                device=dev))
        text_pad_mask = ~text_token_mask
        text_pos = get_sine_pos_embed(position_ids[..., None].float(),
                                      c.d_model, exchange_xy=False).to(adt)
        for layer in m.encoder.layers:
            memory, text = layer(memory, text, vision_pos[None], vision_ref,
                                 text_attn_bias, text_pos, text_pad_mask,
                                 shapes)

        # language-guided query selection (two-stage)
        props, valid = _proposals(shapes)
        props = torch.as_tensor(props, device=dev)
        valid = torch.as_tensor(valid, device=dev)
        oq = torch.where(valid[None, :, None], memory, zero)
        oq = m.enc_output_norm(m.enc_output(oq))
        enc_class = torch.einsum("bsd,btd->bst", oq, text).float()
        enc_class = enc_class.masked_fill(~text_token_mask[:, None, :],
                                          float("-inf"))
        enc_coord = m.encoder_output_bbox_embed(oq).float() + props[None]
        # HF keeps invalid proposals in the top-k; ties go to the lower
        # index, as lax.top_k breaks them
        topk_scores = enc_class.max(dim=-1).values
        topk_idx = torch.sort(topk_scores, dim=1, descending=True,
                              stable=True).indices[:, :c.num_queries]
        self.query_index = topk_idx
        if query_index is not None:
            topk_idx = query_index.to(dev)
        reference = torch.sigmoid(torch.gather(
            enc_coord, 1, topk_idx[..., None].expand(-1, -1, 4)))
        hidden = m.query_position_embeddings.weight[None].expand(b, -1, -1)
        hidden = hidden.to(adt)
        text_cross_bias = torch.where(text_token_mask[:, None, None, :], zero,
                                      torch.full((), neg, dtype=adt,
                                                 device=dev))

        # decoder with iterative box refinement
        bbox_head = self.bbox_embed[0]
        init_reference = reference
        refs = []
        for layer in m.decoder.layers:
            ref_input = reference[:, :, None].expand(-1, -1, len(shapes), 4)
            query_sine = get_sine_pos_embed(reference, c.d_model // 2,
                                            exchange_xy=True)
            query_pos = m.decoder.reference_points_head(query_sine.to(adt))
            hidden = layer(hidden, query_pos, ref_input, memory, text,
                           text_cross_bias, shapes)
            reference = torch.sigmoid(bbox_head(hidden).float()
                                      + _logit(reference))
            refs.append(reference)

        h_last = m.decoder.layer_norm(hidden)
        ref_last = init_reference if len(refs) == 1 else refs[-2]
        logits = torch.einsum("bqd,btd->bqt", h_last, text).float()
        logits = logits.masked_fill(~text_token_mask[:, None, :],
                                    float("-inf"))
        pad = c.max_text_len - logits.shape[-1]
        if pad > 0:
            logits = F.pad(logits, (0, pad), value=float("-inf"))
        boxes = torch.sigmoid(bbox_head(h_last).float() + _logit(ref_last))
        return logits, boxes


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights, as the JAX package's `host_random_params`:
    LayerNorm and GroupNorm scales 1, biases 0, every other parameter
    N(0, 0.02), drawn with `generator` on the model's device."""
    with torch.no_grad():
        for module in model.modules():
            for name, p in module.named_parameters(recurse=False):
                if name == "bias":
                    p.zero_()
                elif name == "weight" and isinstance(
                        module, (nn.LayerNorm, nn.GroupNorm)):
                    p.fill_(1.0)
                else:
                    p.copy_(0.02 * torch.randn(p.shape, generator=generator,
                                               device=p.device))


def hf_state_dict(sd: dict) -> dict:
    """A HF `GroundingDinoForObjectDetection` state dict without what this
    module does not hold: the decoder's tied copies of the box head
    (`model.decoder.bbox_embed.*`, `bbox_embed.1..`), the Swin
    `relative_position_index` buffers and BERT's `position_ids` (computed
    here), and a text pooler. `GroundingDino(cfg).load_state_dict(...,
    strict=True)` takes the rest as it is."""
    def keep(k):
        if k.startswith("model.decoder.bbox_embed.") or (
                k.startswith("bbox_embed.") and not k.startswith("bbox_embed.0.")):
            return False
        return not (k.endswith("relative_position_index")
                    or k.endswith("embeddings.position_ids")
                    or ".pooler." in k)

    return {k: torch.as_tensor(v) for k, v in sd.items() if keep(k)}


def params_from_jax(flax_params: dict, cfg: GDinoConfig) -> dict:
    """The JAX `GroundingDino`'s tree (as `port_hf_gdino_params` or
    `model.init` make it) as this module's fp32 state dict."""
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

    def mha(dst, tree):
        for n in ("query", "key", "value", "out_proj"):
            lin(f"{dst}.{n}", tree[n])

    def deform(dst, tree):
        for n in ("sampling_offsets", "attention_weights", "value_proj",
                  "output_proj"):
            lin(f"{dst}.{n}", tree[n])

    def head(dst, tree, n):
        for i in range(n):
            lin(f"{dst}.layers.{i}", tree[f"layers_{i}"])

    m = "model."
    for k, v in swin_params_from_jax(p["backbone"], cfg.backbone,
                                     cfg.out_stages).items():
        sd[m + "backbone.conv_encoder.model." + k] = v
    for k, v in bert_params_from_jax(p["text_backbone"], cfg.text).items():
        sd[m + "text_backbone." + k] = v
    lin(m + "text_projection", p["text_projection"])
    for i in range(cfg.num_feature_levels):
        sd[m + f"input_proj_vision.{i}.0.weight"] = t(
            np.asarray(p[f"input_proj_{i}"]["kernel"]).transpose(3, 2, 0, 1))
        sd[m + f"input_proj_vision.{i}.0.bias"] = t(p[f"input_proj_{i}"]["bias"])
        ln(m + f"input_proj_vision.{i}.1", p[f"input_norm_{i}"])
    sd[m + "level_embed"] = t(p["level_embed"])
    sd[m + "query_position_embeddings.weight"] = t(p["query_embed"])
    for i in range(cfg.encoder_layers):
        src, dst = p[f"encoder_layer{i}"], m + f"encoder.layers.{i}."
        fu = src["fusion_layer"]
        ln(dst + "fusion_layer.layer_norm_vision", fu["layer_norm_vision"])
        ln(dst + "fusion_layer.layer_norm_text", fu["layer_norm_text"])
        for n in ("vision_proj", "text_proj", "values_vision_proj",
                  "values_text_proj", "out_vision_proj", "out_text_proj"):
            lin(dst + f"fusion_layer.attn.{n}", fu["attn"][n])
        sd[dst + "fusion_layer.vision_param"] = t(fu["vision_param"])
        sd[dst + "fusion_layer.text_param"] = t(fu["text_param"])
        te = src["text_enhancer_layer"]
        mha(dst + "text_enhancer_layer.self_attn", te["self_attn"])
        for n in ("fc1", "fc2"):
            lin(dst + f"text_enhancer_layer.{n}", te[n])
        for n in ("layer_norm_before", "layer_norm_after"):
            ln(dst + f"text_enhancer_layer.{n}", te[n])
        de = src["deformable_layer"]
        deform(dst + "deformable_layer.self_attn", de["self_attn"])
        for n in ("fc1", "fc2"):
            lin(dst + f"deformable_layer.{n}", de[n])
        for n in ("self_attn_layer_norm", "final_layer_norm"):
            ln(dst + f"deformable_layer.{n}", de[n])
    for i in range(cfg.decoder_layers):
        src, dst = p[f"decoder_layer{i}"], m + f"decoder.layers.{i}."
        mha(dst + "self_attn", src["self_attn"])
        mha(dst + "encoder_attn_text", src["encoder_attn_text"])
        deform(dst + "encoder_attn", src["encoder_attn"])
        for n in ("fc1", "fc2"):
            lin(dst + n, src[n])
        for n in ("self_attn_layer_norm", "encoder_attn_text_layer_norm",
                  "encoder_attn_layer_norm", "final_layer_norm"):
            ln(dst + n, src[n])
    ln(m + "decoder.layer_norm", p["decoder_norm"])
    head(m + "decoder.reference_points_head", p["ref_point_head"], 2)
    lin(m + "enc_output", p["enc_output"])
    ln(m + "enc_output_norm", p["enc_output_norm"])
    head(m + "encoder_output_bbox_embed", p["enc_bbox_head"], 3)
    head("bbox_embed.0", p["bbox_head"], 3)
    return sd


# ---------------------------------------------------------------------------
# the cascade's grounder
# ---------------------------------------------------------------------------

def device_preprocess(raw, size: int, mean, std, scale255: bool = True):
    """u8 frames (N, H, W, 3) on the device -> square-resized, normalised
    fp32 (N, size, size, 3): bilinear, antialiased when it shrinks
    (`jax.image.resize`'s default, which the JAX package uses; a copy of
    its `parallel/cascade_serving.py` helper)."""
    img = raw.float()
    if scale255:
        img = img / 255.0
    img = F.interpolate(img.permute(0, 3, 1, 2), size=(size, size),
                        mode="bilinear", align_corners=False, antialias=True)
    mean = torch.as_tensor(mean, device=raw.device)[:, None, None]
    std = torch.as_tensor(std, device=raw.device)[:, None, None]
    return ((img - mean) / std).permute(0, 2, 3, 1)


def cast_for_inference(model: GroundingDino, dtype) -> GroundingDino:
    """The JAX grounder's precision policy: every weight rounded to `dtype`
    (its `cast_params`). The text side (BERT and `text_projection`) then
    computes in fp32 on those rounded weights, as JAX's type promotion of
    the fp32 host-side word embeddings makes it do, and the text enters the
    fusion layers in the image's type (`forward`). A no-op in fp32."""
    model.to(dtype=dtype)
    model.model.text_backbone.float()
    model.model.text_projection.float()
    return model


def build_gdino_grounder(checkpoint_path: str | None = None,
                         vocab_path: str | None = None,
                         box_threshold: float = 0.35,
                         cfg: GDinoConfig | None = None,
                         compute_dtype=None, random_init: bool = False,
                         device="cuda"):
    """grounder(rgb, keyword) -> (boxes_cxcywh_norm, scores), with
    `grounder.detect_all(rgb, keywords)` (one forward for all keywords,
    `grounder.multi_phrase = True`), `grounder.model` and
    `grounder.forwards`, a count of model runs.

    Weights: an HF `.bin`/`.pth`/`.pt` state dict of
    GroundingDinoForObjectDetection; any other file is the JAX package's
    pickled parameter tree (an already-ported flax tree with numpy leaves,
    read by a restricted unpickler: a tree holding flax or jax objects
    raises); or (`random_init=True`) random weights of `cfg` from seed 0. bf16 inference by default
    (`cast_for_inference`); scores are
    thresholded on fp32 sigmoids."""
    cfg = cfg or GDinoConfig()
    if (checkpoint_path is None) == (not random_init):
        raise ValueError("build_gdino_grounder takes either a checkpoint "
                         "or random_init=True")
    dev = resolve_device(device)
    dt = resolve_compute_dtype(compute_dtype)
    tokenizer = WordPieceTokenizer(vocab_path)
    model = GroundingDino(cfg)
    if checkpoint_path is None:
        model = model.to(dev)
        init_params(model, torch.Generator(device=dev).manual_seed(0))
    elif checkpoint_path.endswith((".pth", ".bin", ".pt")):
        sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        model.load_state_dict(hf_state_dict(sd), strict=True)
    else:
        from .vit_embedder import read_pickled_tree
        model.load_state_dict(
            params_from_jax(read_pickled_tree(checkpoint_path), cfg),
            strict=True)
    # the word-embedding lookup happens on the host, from an fp32 table
    vocab_table = model.model.text_backbone.embeddings.word_embeddings \
        .weight.detach().float().cpu().numpy()
    model = cast_for_inference(model.to(dev), dt).eval()

    @torch.no_grad()
    def _run(raw_batch, ids):
        # text length bucketed to a multiple of 16; pad ids (0) only attend
        # to themselves and `token_mask` removes them from fusion, query
        # selection, logits and decoder cross-attention
        t = ids.shape[1]
        tp = -(-t // 16) * 16
        if tp != t:
            ids = np.pad(ids, ((0, 0), (0, tp - t)))
        allowed, position_ids = make_text_masks(ids)
        token_mask = ids != 0
        text_embeds = vocab_table[np.clip(ids, 0, len(vocab_table) - 1)]
        images = device_preprocess(torch.as_tensor(raw_batch, device=dev),
                                   cfg.img_size, IMAGENET_MEAN, IMAGENET_STD)
        logits, boxes = model(
            images.to(dt), torch.as_tensor(ids, device=dev),
            torch.as_tensor(allowed, device=dev),
            torch.as_tensor(position_ids, device=dev),
            torch.as_tensor(token_mask, device=dev),
            text_embeds=torch.as_tensor(text_embeds, device=dev))
        grounder.forwards += 1
        return (torch.sigmoid(logits[..., :t]).cpu().numpy(),
                boxes.cpu().numpy())

    def grounder(rgb, keyword: str):
        ids = np.asarray(tokenizer.encode(keyword + "."), np.int64)[None]
        probs, boxes = _run(np.asarray(rgb, np.uint8)[None], ids)
        scores = probs[0].max(axis=-1)
        keep = scores > box_threshold
        return boxes[0][keep], scores[keep]

    def detect_all(rgb, keywords: list[str]):
        """ONE forward for all keywords: each query goes to the phrase that
        owns its argmax token, scored by the max sigmoid logit over that
        phrase's tokens. Returns [(boxes, scores)] per keyword."""
        if not keywords:
            return []
        ids = [tokenizer.cls_id]
        spans = []
        for k in keywords:
            piece = tokenizer.encode(k + ".", add_special_tokens=False)
            spans.append((len(ids), len(ids) + len(piece)))
            ids.extend(piece)
        ids.append(tokenizer.sep_id)
        probs, boxes = _run(np.asarray(rgb, np.uint8)[None],
                            np.asarray(ids, np.int64)[None])
        probs, boxes = probs[0], boxes[0]
        owner = np.argmax(probs, axis=-1)
        out = []
        for lo, hi in spans:
            scores = probs[:, lo:hi].max(axis=-1)
            keep = (owner >= lo) & (owner < hi) & (scores > box_threshold)
            out.append((boxes[keep], scores[keep]))
        return out

    grounder.detect_all = detect_all
    grounder.multi_phrase = True
    grounder.model = model
    grounder.forwards = 0
    return grounder
