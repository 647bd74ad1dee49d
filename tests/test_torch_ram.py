"""The port's RAM tagger (`models/ram.py`, `models/swin.py`'s timm rules)
against the JAX package's, at tiny widths in fp32 with the same weights:

* Swin with `adapt_window` (a stage narrower than the window runs one
  unshifted window of its size) and the pooled output: within 2e-5;
* `TagDecoderLayer`: within 2e-5;
* `Ram` logits through `params_from_jax`: within 1e-4;
* `port_ram_params` on a synthetic official-layout `.pth` (timm Swin keys,
  the Q2L head, `class_threshold`): the same logits within 1e-4 and the
  same thresholds;
* `build_ram_tagger` end to end on the same u8 frames: the same tags, for
  single frames and for `tag_batch` with equal and with mixed frame sizes;
* `build_cascade_detector(ram_tag_list=...)`: the cascade grounds RAM's
  tags read from the tag list.
"""


import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from instance_based_loc_tpu.models import ram as jram
from instance_based_loc_tpu.models import swin as jswin
from instance_based_loc_tpu_torch.models import ram as tram
from instance_based_loc_tpu_torch.models import swin as tswin
from instance_based_loc_tpu_torch.models.cascade import build_cascade_detector
from instance_based_loc_tpu_torch.models.sam import SamConfig

SWIN_TINY = dict(img_size=32, patch_size=4, embed_dim=8, depths=(1, 1),
                 num_heads=(1, 2), window=4, adapt_window=True)
RAM_TINY = dict(num_tags=12, label_dim=16, hidden=24, heads=2, layers=2,
                mlp_dim=32)
JTINY = jram.RamConfig(backbone=jswin.SwinConfig(**SWIN_TINY), **RAM_TINY)
TTINY = tram.RamConfig(backbone=tswin.SwinConfig(**SWIN_TINY), **RAM_TINY)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(
            np.float32), params)


def _synthetic_official_sd(cfg, rng):
    """A state dict in the official ram_swin_large_14m key layout (a copy of
    tests/test_ram.py's helper, which that slow-marked file keeps)."""
    sd = {}

    def lin(k, i, o):
        sd[k + ".weight"] = rng.normal(size=(o, i)).astype(np.float32) * 0.1
        sd[k + ".bias"] = rng.normal(size=(o,)).astype(np.float32) * 0.1

    def ln(k, d):
        sd[k + ".weight"] = np.ones((d,), np.float32)
        sd[k + ".bias"] = np.zeros((d,), np.float32)

    bb = cfg.backbone
    sd["visual_encoder.patch_embed.proj.weight"] = rng.normal(
        size=(bb.embed_dim, 3, bb.patch_size, bb.patch_size)).astype(
            np.float32) * 0.1
    sd["visual_encoder.patch_embed.proj.bias"] = np.zeros(
        (bb.embed_dim,), np.float32)
    ln("visual_encoder.patch_embed.norm", bb.embed_dim)
    dim = bb.embed_dim
    for s, depth in enumerate(bb.depths):
        for i in range(depth):
            base = f"visual_encoder.layers.{s}.blocks.{i}."
            ln(base + "norm1", dim)
            ln(base + "norm2", dim)
            lin(base + "attn.qkv", dim, 3 * dim)
            lin(base + "attn.proj", dim, dim)
            sd[base + "attn.relative_position_bias_table"] = rng.normal(
                size=((2 * bb.window - 1) ** 2, bb.num_heads[s])
            ).astype(np.float32) * 0.1
            lin(base + "mlp.fc1", dim, int(dim * bb.mlp_ratio))
            lin(base + "mlp.fc2", int(dim * bb.mlp_ratio), dim)
        if s < len(bb.depths) - 1:
            base = f"visual_encoder.layers.{s}.downsample."
            ln(base + "norm", 4 * dim)
            sd[base + "reduction.weight"] = rng.normal(
                size=(2 * dim, 4 * dim)).astype(np.float32) * 0.1
            dim *= 2
    ln("visual_encoder.norm", dim)
    lin("image_proj", dim, cfg.label_dim)
    sd["label_embed"] = rng.normal(
        size=(cfg.num_tags, cfg.label_dim)).astype(np.float32)
    lin("wordvec_proj", cfg.label_dim, cfg.hidden)
    lin("fc", cfg.hidden, 1)
    for i in range(cfg.layers):
        base = f"tagging_head.encoder.layer.{i}."
        for n in ("attention.self.query", "attention.self.key",
                  "attention.self.value", "attention.output.dense",
                  "crossattention.self.query", "crossattention.self.key",
                  "crossattention.self.value", "crossattention.output.dense"):
            io = (cfg.label_dim, cfg.hidden) if "crossattention.self.k" in n \
                or "crossattention.self.v" in n else (cfg.hidden, cfg.hidden)
            lin(base + n, *io)
        ln(base + "attention.output.LayerNorm", cfg.hidden)
        ln(base + "crossattention.output.LayerNorm", cfg.hidden)
        lin(base + "intermediate.dense", cfg.hidden, cfg.mlp_dim)
        lin(base + "output.dense", cfg.mlp_dim, cfg.hidden)
        ln(base + "output.LayerNorm", cfg.hidden)
    sd["class_threshold"] = np.full((cfg.num_tags,), 0.5, np.float32)
    return sd


@pytest.fixture(scope="module")
def official_pth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ram") / "ram_tiny.pth")
    sd = _synthetic_official_sd(JTINY, np.random.default_rng(1))
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)
    return path


def test_swin_adapt_window_and_pooled_match_jax():
    """Window 6 on an 8x8 then a 4x4 map: stage 0 pads to 12x12 and shifts
    its second block by 3; stage 1 adapts to one unshifted 4x4 window
    (a 7x7 relative-bias table)."""
    kw = dict(SWIN_TINY, window=6, depths=(2, 2))
    jcfg, tcfg = jswin.SwinConfig(**kw), tswin.SwinConfig(**kw)
    assert [tcfg.stage_window(s) for s in (0, 1)] == [(6, True), (4, False)]
    images = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    model = jswin.SwinTransformer(jcfg)
    params = _perturbed(model.init(jax.random.PRNGKey(0),
                                   jnp.asarray(images)), 0)
    want = model.apply(params, jnp.asarray(images))
    port = tswin.SwinTransformer(tcfg)
    port.load_state_dict(tswin.swin_params_from_jax(
        params["params"], tcfg, (), pooled=True))
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    assert sorted(got) == sorted(want) == ["c2", "c3", "pooled"]
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=2e-5)


def test_tag_decoder_layer_matches_jax():
    rng = np.random.default_rng(2)
    queries = rng.normal(size=(2, 5, 32)).astype(np.float32)
    memory = rng.normal(size=(2, 7, 16)).astype(np.float32)
    jlayer = jram.TagDecoderLayer(jram.RamConfig(hidden=32, heads=2,
                                                 mlp_dim=64))
    params = _perturbed(jlayer.init(jax.random.PRNGKey(0),
                                    jnp.asarray(queries),
                                    jnp.asarray(memory)), 2)
    want = np.asarray(jlayer.apply(params, jnp.asarray(queries),
                                   jnp.asarray(memory)))
    layer = tram.TagDecoderLayer(tram.RamConfig(hidden=32, heads=2,
                                                mlp_dim=64, label_dim=16))
    sd = {}
    for name, leaf in params["params"].items():
        if "kernel" in leaf:
            sd[f"{name}.weight"] = torch.as_tensor(leaf["kernel"].T)
        else:
            sd[f"{name}.weight"] = torch.as_tensor(leaf["scale"])
        sd[f"{name}.bias"] = torch.as_tensor(leaf["bias"])
    layer.load_state_dict(sd)
    with torch.no_grad():
        got = layer(torch.from_numpy(queries), torch.from_numpy(memory))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_ram_logits_match_jax():
    images = np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    model = jram.Ram(JTINY)
    params = _perturbed(model.init(jax.random.PRNGKey(0),
                                   jnp.asarray(images)), 3)
    want = np.asarray(model.apply(params, jnp.asarray(images)))
    port = tram.Ram(TTINY)
    port.load_state_dict(tram.params_from_jax(params, TTINY))
    with torch.no_grad():
        got = port(torch.from_numpy(images)).numpy()
    assert got.shape == (2, 12)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.ptp(want) > 0.1          # logits that differ from tag to tag


def test_port_ram_params_matches_jax(official_pth):
    jparams, jthr = jram.port_ram_params(official_pth, JTINY)
    sd, thr = tram.port_ram_params(official_pth, TTINY)
    np.testing.assert_array_equal(thr, jthr)
    images = np.random.default_rng(4).normal(size=(1, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jram.Ram(JTINY).apply(jparams, jnp.asarray(images)))
    port = tram.Ram(TTINY)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _frames():
    rng = np.random.default_rng(5)
    shapes = [(48, 64), (48, 64), (40, 56)]
    return [(rng.random(s + (3,)) * 255).astype(np.uint8) for s in shapes]


def test_build_ram_tagger_matches_jax(official_pth):
    vocab = [f"tag{i}" for i in range(12)]
    kw = dict(tag_vocab=vocab, image_size=32, compute_dtype="float32")
    jtag = jram.build_ram_tagger(official_pth, cfg=JTINY, **kw)
    ttag = tram.build_ram_tagger(official_pth, cfg=TTINY, device="cpu", **kw)
    frames = _frames()
    want = [jtag(f) for f in frames]
    assert [ttag(f) for f in frames] == want
    assert any(want) and not all(len(t) == 12 for t in want), want
    assert ttag.tag_batch(frames[:2]) == jtag.tag_batch(frames[:2]) \
        == want[:2]
    assert ttag.tag_batch(frames) == jtag.tag_batch(frames) == want
    assert ttag.tag_batch([]) == []


def test_cascade_grounds_the_tags_of_its_tag_list(official_pth, tmp_path):
    vocab = [f"thing{i}" for i in range(12)]
    tag_list = tmp_path / "ram_tag_list.txt"
    tag_list.write_text("\n".join(vocab) + "\n")
    sam = SamConfig(img_size=64, patch_size=16, encoder_dim=32,
                    encoder_depth=2, encoder_heads=2, window_size=2,
                    global_blocks=(1,), prompt_dim=16, decoder_depth=2,
                    decoder_heads=2, decoder_mlp_dim=32, iou_head_hidden=16)
    cascade = build_cascade_detector(
        ram_checkpoint=official_pth, ram_tag_list=str(tag_list),
        ram_cfg=TTINY, sam_cfg=sam, compute_dtype="float32", device="cpu")
    jtag = jram.build_ram_tagger(official_pth, tag_list_path=str(tag_list),
                                 cfg=JTINY, image_size=32,
                                 compute_dtype="float32")
    frame = _frames()[0]
    tags = jtag(frame)
    assert tags and cascade.tagger(frame) == tags
    det = cascade.find(frame, consider_floor=False)
    # the weights-free grounder proposes one box per keyword; the dedup
    # keeps the first keyword's box
    assert det.phrases == tags[:1]
