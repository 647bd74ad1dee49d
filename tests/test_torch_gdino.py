"""The port's GroundingDINO (text masks, Swin, BERT, the whole model, its
weights and the grounder) against the JAX package's, on the CPU, at
`tests/test_gdino_parity.py`'s tiny config.

An HF `GroundingDinoForObjectDetection` `.bin` written by `transformers`
(random weights) is loaded by both packages. Tolerances, fp32:

* text masks and position ids: exact;
* Swin pyramid features and BERT hidden states: atol 1e-4 (fp32 maths in
  another order through 6 Swin blocks / 2 BERT layers);
* the whole model, logits and boxes: atol 1e-4, with the HF weights and
  with the JAX module's own (perturbed) weights carried by
  `params_from_jax`;
* the bf16 inference cast against the JAX grounder's `cast_params`: every
  weight the same bf16 value (exact), the text side (BERT and
  `text_projection`) held in fp32, as JAX promotes it, the rest in bf16;
* the grounders' `detect_all` on a frame: the same kept boxes (atol 1e-4)
  and scores (atol 1e-4) per keyword, and the port's text-length bucketing
  (pad ids to a multiple of 16) leaves the logits unchanged (atol 1e-5).
* the grounder from the JAX package's pickled tree (`.pkl`, written as
  tests/test_gdino_parity.py writes it, from the HF weights): the same
  boxes and scores as the port's HF path (atol 1e-6: one set of fp32
  weights, two routes to them) and as the JAX grounder on the same pickle
  (atol 1e-4); a pickled FrozenDict raises.
"""

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from instance_based_loc_tpu.models import gdino as jgdino
from instance_based_loc_tpu.models.swin import SwinTransformer
from instance_based_loc_tpu.models.bert import BertEncoder as JaxBert
from instance_based_loc_tpu_torch.models import gdino as tgdino
from instance_based_loc_tpu_torch.models.swin import SwinConfig
from instance_based_loc_tpu_torch.models.bert import BertConfig

transformers = pytest.importorskip("transformers")

INPUT_IDS = np.array([[101, 7, 8, 1012, 9, 1012, 102]], np.int64)


def tiny_hf_config():
    swin = transformers.SwinConfig(
        image_size=64, patch_size=4, embed_dim=8, depths=[2, 2, 2],
        num_heads=[1, 2, 4], window_size=4, drop_path_rate=0.0,
        out_features=["stage1", "stage2", "stage3"])
    bert = transformers.BertConfig(
        vocab_size=1100, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=37,
        max_position_embeddings=64,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return transformers.GroundingDinoConfig(
        backbone_config=swin, text_config=bert, d_model=32,
        encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
        decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
        num_queries=10, max_text_len=16, num_feature_levels=4,
        dropout=0.0, activation_dropout=0.0, attention_dropout=0.0,
        fusion_dropout=0.0, fusion_droppath=0.0, text_enhancer_dropout=0.0)


TINY = dict(img_size=64, d_model=32, num_queries=10, encoder_layers=2,
            decoder_layers=2, encoder_heads=4, decoder_heads=4, ffn_dim=64,
            max_text_len=16, out_stages=(0, 1, 2))
SWIN = dict(patch_size=4, embed_dim=8, depths=(2, 2, 2),
            num_heads=(1, 2, 4), window=4, backbone_norms=True)
BERT = dict(vocab_size=1100, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=37, max_position_embeddings=64)


def jax_config():
    from instance_based_loc_tpu.models.swin import SwinConfig as JSwin
    from instance_based_loc_tpu.models.bert import BertConfig as JBert
    return jgdino.GDinoConfig(backbone=JSwin(img_size=64, **SWIN),
                              text=JBert(**BERT), **TINY)


def torch_config():
    return tgdino.GDinoConfig(backbone=SwinConfig(**SWIN),
                              text=BertConfig(**BERT), **TINY)


def write_vocab(path, words=("chair", "table")):
    """A WordPiece vocab with [CLS], [SEP] and "." at their bert-base ids
    (101, 102, 1012), then `words`."""
    path.write_text("\n".join(["[PAD]"] * 101 + ["[CLS]", "[SEP]"]
                              + ["[UNK]"] * 909 + ["."] + list(words)))
    return str(path)


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    torch.manual_seed(2)
    hf = transformers.GroundingDinoForObjectDetection(tiny_hf_config())
    path = tmp_path_factory.mktemp("gdino") / "gdino_tiny.bin"
    torch.save(hf.state_dict(), path)
    sd = {k: v.numpy() for k, v in torch.load(path).items()}
    params = jgdino.port_hf_gdino_params(sd, jax_config())
    model = tgdino.GroundingDino(torch_config())
    model.load_state_dict(tgdino.hf_state_dict(torch.load(path)),
                          strict=True)
    return str(path), params, model.eval()


def test_text_masks_match_jax():
    ids = np.concatenate([INPUT_IDS, np.zeros((1, 9), np.int64)], axis=1)
    for x in (INPUT_IDS, ids):
        ja, jp = jgdino.make_text_masks(x)
        ta, tp = tgdino.make_text_masks(x)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tp, jp)


def test_swin_and_bert_match_jax(hf_checkpoint):
    _, params, model = hf_checkpoint
    jcfg = jax_config()
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    feats = SwinTransformer(jcfg.backbone).apply(
        {"params": params["params"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        tfeats = model.model.backbone.conv_encoder.model(torch.from_numpy(x))
    for stage, got in zip(("c2", "c3", "c4"), tfeats):
        np.testing.assert_allclose(got.numpy(), np.asarray(feats[stage]),
                                   atol=1e-4, rtol=0, err_msg=stage)

    allowed, pos = jgdino.make_text_masks(INPUT_IDS)
    jout = JaxBert(jcfg.text).apply(
        {"params": params["params"]["text_backbone"]},
        jnp.asarray(INPUT_IDS.astype(np.int32)),
        jnp.asarray(allowed.astype(np.float32)),
        jnp.zeros(INPUT_IDS.shape, jnp.int32),
        jnp.asarray(pos.astype(np.int32)))
    with torch.no_grad():
        tout = model.model.text_backbone(
            torch.from_numpy(INPUT_IDS), torch.from_numpy(allowed),
            torch.from_numpy(pos))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=0)


def _forward_both(jparams, model, seed):
    x = np.random.default_rng(seed).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    allowed, pos = jgdino.make_text_masks(INPUT_IDS)
    mask = np.ones_like(INPUT_IDS, bool)
    jl, jb = jgdino.GroundingDino(jax_config()).apply(
        jparams, jnp.asarray(x), jnp.asarray(INPUT_IDS.astype(np.int32)),
        jnp.asarray(allowed), jnp.asarray(pos.astype(np.int32)),
        jnp.asarray(mask))
    with torch.no_grad():
        tl, tb = model(torch.from_numpy(x), torch.from_numpy(INPUT_IDS),
                       torch.from_numpy(allowed), torch.from_numpy(pos),
                       torch.from_numpy(mask))
    return (np.asarray(jl), np.asarray(jb)), (tl.numpy(), tb.numpy())


def test_model_with_hf_weights_matches_jax(hf_checkpoint):
    _, params, model = hf_checkpoint
    (jl, jb), (tl, tb) = _forward_both(params, model, 1)
    t = INPUT_IDS.shape[1]
    assert tl.shape == jl.shape == (1, 10, 16)
    assert np.isneginf(tl[..., t:]).all()
    np.testing.assert_allclose(tl[..., :t], jl[..., :t], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tb, jb, atol=1e-4, rtol=0)


def test_model_with_jax_weights_matches_jax():
    rng = np.random.default_rng(3)
    allowed, pos = jgdino.make_text_masks(INPUT_IDS)
    params = jgdino.GroundingDino(jax_config()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.asarray(INPUT_IDS.astype(np.int32)), jnp.asarray(allowed),
        jnp.asarray(pos.astype(np.int32)),
        jnp.ones(INPUT_IDS.shape, bool))
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape)
        .astype(np.float32), params)
    model = tgdino.GroundingDino(torch_config()).eval()
    model.load_state_dict(tgdino.params_from_jax(params, torch_config()),
                          strict=True)
    (jl, jb), (tl, tb) = _forward_both(params, model, 4)
    t = INPUT_IDS.shape[1]
    np.testing.assert_allclose(tl[..., :t], jl[..., :t], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tb, jb, atol=1e-4, rtol=0)


def test_inference_cast_matches_jax_policy(hf_checkpoint):
    from instance_based_loc_tpu.models.precision import cast_params
    _, params, model = hf_checkpoint
    cast = tgdino.cast_for_inference(copy.deepcopy(model), torch.bfloat16)
    ref = tgdino.params_from_jax(cast_params(params, jnp.bfloat16),
                                 torch_config())
    got = cast.state_dict()
    for k, v in ref.items():
        if v.is_floating_point():
            assert torch.equal(got[k].float(), v), k
    m = cast.model
    text = {id(p) for part in (m.text_backbone, m.text_projection)
            for p in part.parameters()}
    for p in cast.parameters():
        assert p.dtype == (torch.float32 if id(p) in text
                           else torch.bfloat16)


def test_grounders_detect_the_same_boxes(hf_checkpoint, tmp_path):
    path, _, _ = hf_checkpoint
    vocab = write_vocab(tmp_path / "vocab.txt")
    jg = jgdino.build_gdino_grounder(path, vocab_path=vocab,
                                     box_threshold=0.0, cfg=jax_config(),
                                     compute_dtype="float32")
    tg = tgdino.build_gdino_grounder(path, vocab_path=vocab,
                                     box_threshold=0.0, cfg=torch_config(),
                                     compute_dtype="float32", device="cpu")
    assert tg.multi_phrase
    rgb = (np.random.default_rng(0).random((48, 64, 3)) * 255).astype(
        np.uint8)
    jout = jg.detect_all(rgb, ["chair", "table"])
    tout = tg.detect_all(rgb, ["chair", "table"])
    assert sum(len(b) for b, _ in tout) > 0
    for (jb, js), (tb, ts) in zip(jout, tout):
        np.testing.assert_allclose(tb, jb, atol=1e-4, rtol=0)
        np.testing.assert_allclose(ts, js, atol=1e-4, rtol=0)
    jb1, js1 = jg(rgb, "chair")
    tb1, ts1 = tg(rgb, "chair")
    np.testing.assert_allclose(tb1, jb1, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ts1, js1, atol=1e-4, rtol=0)


def test_text_length_bucketing_keeps_logits(hf_checkpoint):
    _, _, model = hf_checkpoint
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 64, 64, 3)).astype(np.float32))
    ids = np.array([[101, 7, 8, 1012, 102]], np.int64)
    padded = np.pad(ids, ((0, 0), (0, 11)))
    outs = []
    with torch.no_grad():
        for x_ids in (ids, padded):
            allowed, pos = tgdino.make_text_masks(x_ids)
            outs.append(model(x, torch.from_numpy(x_ids),
                              torch.from_numpy(allowed),
                              torch.from_numpy(pos),
                              torch.from_numpy(x_ids != 0)))
    (l0, b0), (l1, b1) = outs
    np.testing.assert_allclose(l1[..., :5].numpy(), l0[..., :5].numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(b1.numpy(), b0.numpy(), atol=1e-5, rtol=0)


def test_grounder_from_pickled_jax_tree(hf_checkpoint, tmp_path):
    import pickle
    from flax.core import freeze
    path, params, _ = hf_checkpoint
    vocab = write_vocab(tmp_path / "vocab.txt")
    ckpt = tmp_path / "params.pkl"
    ckpt.write_bytes(pickle.dumps(params))
    kw = dict(vocab_path=vocab, box_threshold=0.0, cfg=torch_config(),
              compute_dtype="float32", device="cpu")
    tg_pkl = tgdino.build_gdino_grounder(str(ckpt), **kw)
    tg_hf = tgdino.build_gdino_grounder(path, **kw)
    jg = jgdino.build_gdino_grounder(str(ckpt), vocab_path=vocab,
                                     box_threshold=0.0, cfg=jax_config(),
                                     compute_dtype="float32")
    rgb = (np.random.default_rng(4).random((48, 64, 3)) * 255).astype(
        np.uint8)
    out = tg_pkl.detect_all(rgb, ["chair", "table"])
    assert sum(len(b) for b, _ in out) > 0
    for ref, atol in ((tg_hf.detect_all(rgb, ["chair", "table"]), 1e-6),
                      (jg.detect_all(rgb, ["chair", "table"]), 1e-4)):
        for (rb, rs), (tb, ts) in zip(ref, out):
            np.testing.assert_allclose(tb, rb, atol=atol, rtol=0)
            np.testing.assert_allclose(ts, rs, atol=atol, rtol=0)
    frozen = tmp_path / "frozen.pkl"
    frozen.write_bytes(pickle.dumps(freeze(params)))
    with pytest.raises(ValueError, match="flax"):
        tgdino.build_gdino_grounder(str(frozen), **kw)
