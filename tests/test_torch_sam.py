"""The port's SAM (attention plain version, model, weights, segmenter)
against the JAX package's, on the CPU.

* `sam_attention_reference` against the JAX `reference_sam_attention` and the
  Pallas kernel `sam_flash_attention` run in interpret mode, on 16x16 and
  8x32 grids at D = 64 and 80, fp32: atol 1e-5 (the same fp32 maths in
  another order).
* SAM at `tests/test_sam_parity.py`'s tiny config with the JAX module's
  (perturbed) weights carried across by `params_from_jax`: mask logits and
  IoU within atol 1e-4 (fp32 through 3 encoder blocks and the decoder).
* a tiny official-layout `.pth` loaded by both packages' segmenters: the
  same masks on >= 99% of pixels (a logit near 0 may flip through the two
  bilinear resizes, summed in another order), on the file's canvas and on
  another one (the position tables resized while loading).
* serving on another canvas: `resize_like_jax` against `jax.image.resize`
  (cubic and linear, shrinking and enlarging) within 1e-6 of the largest
  |input|; the resized
  tables against the JAX package's within 1e-6; a 128 px checkpoint at 96
  px against the JAX model within 1e-4 (fp32).
* the on-device canvas transform against `jax.image.resize` (bilinear,
  antialiased when it shrinks): atol 1e-4 after normalisation (values of
  a few units; fp32 filter weights summed in another order).
* the compute-precision policy: the JAX package's names and default
  (argument > IBL_MODEL_DTYPE > bf16).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from instance_based_loc_tpu.models import sam as jsam
from instance_based_loc_tpu.models.precision import (
    resolve_compute_dtype as jax_resolve)
from instance_based_loc_tpu.ops.pallas.sam_attention import (
    reference_sam_attention, sam_flash_attention)
from instance_based_loc_tpu_torch.models import sam as tsam
from instance_based_loc_tpu_torch.models.precision import (
    resolve_compute_dtype)
from instance_based_loc_tpu_torch.ops.sam_attention import (
    sam_attention, sam_attention_reference)

transformers = pytest.importorskip("transformers")

TINY = dict(img_size=64, patch_size=16, encoder_dim=32, encoder_depth=3,
            encoder_heads=2, window_size=2, global_blocks=(1,),
            prompt_dim=16, decoder_depth=2, decoder_heads=2,
            decoder_mlp_dim=32, iou_head_hidden=16)
BOXES = np.array([[4.0, 6.0, 40.0, 50.0], [10.0, 12.0, 30.0, 28.0],
                  [0.0, 0.0, 63.0, 63.0]], np.float32)


@pytest.mark.parametrize("hk,wk,d", [(16, 16, 64), (16, 16, 80),
                                     (8, 32, 64), (8, 32, 80)])
def test_sam_attention_plain_version_matches_jax(hk, wk, d):
    rng = np.random.default_rng(hk * wk + d)
    b, h, s = 1, 2, hk * wk
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(3))
    bh = (0.3 * rng.normal(size=(b, h, s, hk))).astype(np.float32)
    bw = (0.3 * rng.normal(size=(b, h, s, wk))).astype(np.float32)
    jargs = [jnp.asarray(x) for x in (q, k, v, bh, bw)]
    ref = np.asarray(reference_sam_attention(*jargs))
    pallas = np.asarray(sam_flash_attention(*jargs, q_tile=64,
                                            interpret=True))
    targs = [torch.from_numpy(x) for x in (q, k, v, bh, bw)]
    plain = sam_attention_reference(*targs).numpy()
    np.testing.assert_allclose(plain, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(plain, pallas, atol=1e-5, rtol=0)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(sam_attention(*targs).numpy(), plain)


@pytest.fixture(scope="module")
def jax_tiny_sam():
    """JAX SAM at the tiny config, weights perturbed so no leaf keeps its
    trivial init, with its mask logits and IoU on 3 boxes."""
    rng = np.random.default_rng(0)
    cfg = jsam.SamConfig(**TINY)
    model = jsam.Sam(cfg)
    img = rng.normal(size=(64, 64, 3)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(img),
                        jnp.asarray(BOXES))
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape)
        .astype(np.float32), params)
    masks, iou = model.apply(params, jnp.asarray(img), jnp.asarray(BOXES))
    return params, img, np.asarray(masks), np.asarray(iou)


def test_sam_model_matches_jax(jax_tiny_sam):
    params, img, jmasks, jiou = jax_tiny_sam
    cfg = tsam.SamConfig(**TINY)
    model = tsam.Sam(cfg)
    model.load_state_dict(tsam.params_from_jax(params, cfg), strict=True)
    with torch.no_grad():
        masks, iou = model(torch.from_numpy(img), torch.from_numpy(BOXES))
    assert masks.shape == (3, 4 * cfg.grid, 4 * cfg.grid)
    np.testing.assert_allclose(masks.numpy(), jmasks, atol=1e-4, rtol=0)
    np.testing.assert_allclose(iou.numpy(), jiou, atol=1e-4, rtol=0)


def _hf_to_official(k: str) -> str:
    """HF SamModel key -> official segment-anything key (the mapping of
    tests/test_fullscale_parity.py)."""
    if k.startswith("vision_encoder."):
        k = k.replace("vision_encoder.", "image_encoder.", 1)
        k = k.replace(".layers.", ".blocks.", 1)
        for a, b in (("patch_embed.projection", "patch_embed.proj"),
                     ("neck.conv1", "neck.0"), ("neck.layer_norm1", "neck.1"),
                     ("neck.conv2", "neck.2"), ("neck.layer_norm2", "neck.3"),
                     (".layer_norm1.", ".norm1."),
                     (".layer_norm2.", ".norm2.")):
            k = k.replace(a, b)
        return k
    if k.startswith("prompt_encoder."):
        k = k.replace("shared_embedding.positional_embedding",
                      "pe_layer.positional_encoding_gaussian_matrix")
        # (not_a_point_embed keeps its name in the official layout)
        return k.replace("prompt_encoder.point_embed.",
                         "prompt_encoder.point_embeddings.")
    if k.startswith("mask_decoder."):
        k = k.replace("layer_norm_final_attn", "norm_final_attn")
        for j in (1, 2, 3, 4):
            k = k.replace(f".layer_norm{j}.", f".norm{j}.")
        k = k.replace("upscale_conv1", "output_upscaling.0")
        k = k.replace("upscale_layer_norm", "output_upscaling.1")
        k = k.replace("upscale_conv2", "output_upscaling.3")
        if "output_hypernetworks_mlps" in k or "iou_prediction_head" in k:
            k = k.replace(".layers.0.", ".layers.1.")
            k = k.replace(".proj_in.", ".layers.0.")
            k = k.replace(".proj_out.", ".layers.2.")
    return k


def _official_state_dict(image_size=64, seed=0):
    """A tiny HF SamModel's random weights (O(0.1), so masks carry
    structure) in the official segment-anything layout, its tables sized
    for an `image_size` canvas."""
    torch.manual_seed(seed)
    vc = transformers.SamVisionConfig(
        hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
        image_size=image_size, patch_size=16, window_size=2,
        global_attn_indexes=[1], output_channels=16, num_pos_feats=8)
    pc = transformers.SamPromptEncoderConfig(
        hidden_size=16, image_embedding_size=image_size // 16,
        image_size=image_size)
    mc = transformers.SamMaskDecoderConfig(
        hidden_size=16, num_attention_heads=2, num_hidden_layers=2,
        iou_head_depth=3, iou_head_hidden_dim=16, mlp_dim=32)
    hf = transformers.SamModel(transformers.SamConfig(
        vision_config=vc.to_dict(), prompt_encoder_config=pc.to_dict(),
        mask_decoder_config=mc.to_dict()))
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.3)
    return {_hf_to_official(k): v.clone()
            for k, v in hf.state_dict().items()}


def test_official_checkpoint_loads_into_both_segmenters(tmp_path):
    path = str(tmp_path / "sam_tiny.pth")
    torch.save(_official_state_dict(), path)

    rgb = (np.random.default_rng(1).random((40, 56, 3)) * 255).astype(
        np.uint8)
    boxes = np.array([[3.0, 4.0, 30.0, 35.0], [20.0, 10.0, 50.0, 38.0]],
                     np.float32)
    jseg = jsam.build_sam_segmenter(path, cfg=jsam.SamConfig(**TINY),
                                    compute_dtype="float32")
    tseg = tsam.build_sam_segmenter(path, cfg=tsam.SamConfig(**TINY),
                                    compute_dtype="float32", device="cpu")
    jm, tm = jseg(rgb, boxes), tseg(rgb, boxes)
    assert tm.shape == jm.shape == (2, 40, 56) and tm.dtype == bool
    assert jm.any() and not jm.all()
    assert (tm == jm).mean() >= 0.99
    # batch entry point: the same masks as one frame at a time
    for a, b in zip(tseg.segment_batch([rgb, rgb[::-1].copy()],
                                       [boxes, boxes[:1]]),
                    [tm, tseg(rgb[::-1].copy(), boxes[:1])]):
        np.testing.assert_array_equal(a, b)
    # another canvas than the file's (its tables resized while loading):
    # the two packages' masks again, from the file and from the state dict
    # in memory
    cfg = dict(TINY, img_size=128)
    jm = jsam.build_sam_segmenter(path, cfg=jsam.SamConfig(**cfg),
                                  compute_dtype="float32")(rgb, boxes)
    for kw in ({"checkpoint_path": path},
               {"state_dict": torch.load(path, weights_only=True)}):
        tm = tsam.build_sam_segmenter(cfg=tsam.SamConfig(**cfg),
                                      compute_dtype="float32", device="cpu",
                                      **kw)(rgb, boxes)
        assert jm.any() and not jm.all()
        assert (tm == jm).mean() >= 0.99


@pytest.mark.parametrize("shape,new,method", [
    ((1, 64, 64, 8), (1, 48, 48, 8), "cubic"),      # SAM-H at 768 px
    ((1, 8, 8, 4), (1, 12, 12, 4), "cubic"),
    ((1, 16, 16, 4), (1, 5, 5, 4), "cubic"),
    ((127, 16), (95, 16), "linear"),                # its global rel-pos
    ((7, 6), (23, 6), "linear"),
    ((33, 3), (4, 3), "linear")])
def test_resize_like_jax_matches_jax_image_resize(shape, new, method):
    """Shrinking (antialiased) and enlarging, values ~N(0, 1): within 1e-6
    of the largest |input|. The weights are JAX's to an ulp; the sums are
    fp32 in JAX and float64 here, and JAX's own weights, applied outside
    its jit, differ from `jax.image.resize` by 1.5e-6 on the 64 -> 48
    case."""
    x = np.random.default_rng(len(shape) + new[1]).normal(
        size=shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), new, method))
    got = tsam.resize_like_jax(x, new, method)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(x).max())


@pytest.mark.parametrize("img_size", [32, 48, 128])
def test_fit_canvas_matches_jax_tables(img_size):
    """The tables the port loads for another canvas equal the JAX
    package's (`_sam_flax_params` carried back by `params_from_jax`)
    within 1e-6."""
    sd = _official_state_dict()
    cfg = dict(TINY, img_size=img_size)
    flax = jsam._sam_flax_params({k: v.numpy() for k, v in sd.items()},
                                 jsam.SamConfig(**cfg), jsam._OFFICIAL_NAMES)
    ref = tsam.params_from_jax(flax, tsam.SamConfig(**cfg))
    got = tsam.fit_canvas(sd, tsam.SamConfig(**cfg))
    g = img_size // 16
    assert got["image_encoder.pos_embed"].shape == (1, g, g, 32)
    assert got["image_encoder.blocks.1.attn.rel_pos_h"].shape[0] == 2 * g - 1
    assert got["image_encoder.blocks.0.attn.rel_pos_h"].shape[0] == 3
    for key in ref:
        if "pos_embed" in key or "rel_pos" in key:
            np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                       atol=1e-6, rtol=0, err_msg=key)


def test_sam_at_smaller_canvas_matches_jax():
    """A 128 px checkpoint served at 96 px (grid 8 -> 6): mask logits and
    IoU against the JAX model on the JAX package's resized tables, atol
    1e-4 (fp32, as test_sam_model_matches_jax)."""
    sd = _official_state_dict(image_size=128, seed=2)
    cfg = dict(TINY, img_size=96)
    jcfg = jsam.SamConfig(**cfg)
    flax = jsam._sam_flax_params({k: v.numpy() for k, v in sd.items()},
                                 jcfg, jsam._OFFICIAL_NAMES)
    img = np.random.default_rng(3).normal(size=(96, 96, 3)).astype(
        np.float32)
    boxes = BOXES * 1.5
    jmasks, jiou = jsam.Sam(jcfg).apply(flax, jnp.asarray(img),
                                        jnp.asarray(boxes))
    model = tsam.sam_from_state_dict(sd, tsam.SamConfig(**cfg))
    with torch.no_grad():
        masks, iou = model(torch.from_numpy(img), torch.from_numpy(boxes))
    assert masks.shape == (3, 24, 24)
    np.testing.assert_allclose(masks.numpy(), np.asarray(jmasks), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("h,w", [(40, 56), (48, 32), (240, 320)])
def test_canvas_matches_jax_resize(h, w):
    raw = (np.random.default_rng(h).random((h, w, 3)) * 255).astype(np.uint8)
    size = 64
    scale = size / max(h, w)
    nh, nw = round(h * scale), round(w * scale)
    img = jax.image.resize(jnp.asarray(raw, jnp.float32), (nh, nw, 3),
                           "bilinear")
    img = (np.asarray(img) - jsam.SAM_MEAN) / jsam.SAM_STD
    ref = np.zeros((size, size, 3), np.float32)
    ref[:nh, :nw] = img
    got = tsam.canvas(torch.from_numpy(raw)[None], size, torch.float32)[0]
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arg,env", [(None, None), (None, "float32"),
                                     ("bf16", "float32"), ("f32", None)])
def test_compute_dtype_policy_matches_jax(arg, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("IBL_MODEL_DTYPE", raising=False)
    else:
        monkeypatch.setenv("IBL_MODEL_DTYPE", env)
    assert str(resolve_compute_dtype(arg)).split(".")[-1] == \
        jnp.dtype(jax_resolve(arg)).name
