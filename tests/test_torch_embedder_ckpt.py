"""The port's ViT embedder checkpoints against the JAX package's loader
(`instance_based_loc_tpu/models/vit_embedder.py:load_params`).

* HF `.bin` files of random-init `transformers` ViTModel, Dinov2Model and
  CLIPVisionModel at a tiny config: the JAX package's `load_params` and the
  port's `load_params` give cls embeddings and tokens within 1e-4 (fp32;
  README's porter tolerance); `build_vit_embedder(checkpoint_path=...)`
  loads the same file. CLIPVisionModel has no projection, so both
  packages project with zeros; a CLIPVisionModelWithProjection file is
  held against `transformers` itself, since the JAX package ignores the
  file's projection.
* a flat `.npz` holding the pickled JAX parameter tree (numpy leaves):
  the same embeddings within 1e-4. A tree pickled with flax or jax objects
  raises a ValueError that says so, and never falls back to random weights.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import flax

from instance_based_loc_tpu.models import vit as jvit
from instance_based_loc_tpu.models import vit_embedder as jemb
from instance_based_loc_tpu_torch.models import vit as tvit
from instance_based_loc_tpu_torch.models import vit_embedder as temb

transformers = pytest.importorskip("transformers")

TINY = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
            num_heads=2, mlp_dim=64)
TOL = 1e-4


def _configs(variant):
    proj = 16 if variant == "clip" else None
    base = dict(TINY, projection_dim=proj)
    return (dataclasses.replace(jvit.VARIANTS[variant], **base,
                                dtype=jnp.float32),
            dataclasses.replace(tvit.VARIANTS[variant], **base,
                                dtype=torch.float32))


def _hf_model(variant, with_projection=False):
    common = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                  image_size=28, patch_size=14)
    torch.manual_seed(0)
    if variant == "vit":
        model = transformers.ViTModel(transformers.ViTConfig(
            **common, intermediate_size=64))
    elif variant == "dinov2":
        model = transformers.Dinov2Model(transformers.Dinov2Config(
            **common, mlp_ratio=2, layerscale_value=0.5))
    else:
        cfg = transformers.CLIPVisionConfig(**common, intermediate_size=64,
                                            projection_dim=16,
                                            hidden_act="gelu")
        model = (transformers.CLIPVisionModelWithProjection(cfg)
                 if with_projection else transformers.CLIPVisionModel(cfg))
    with torch.no_grad():   # no leaf keeps its trivial init
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    return model.eval()


def _images():
    return np.random.default_rng(0).normal(size=(3, 28, 28, 3)).astype(
        np.float32)


def _jax_outputs(params, jcfg, images):
    cls, tokens = jvit.ViT(jcfg).apply(params, jnp.asarray(images))
    return np.asarray(cls), np.asarray(tokens)


def _port_outputs(path, variant, tcfg, images):
    model = tvit.ViT(tcfg)
    temb.load_params(model, tcfg, variant, path)
    with torch.no_grad():
        cls, tokens = model.eval()(torch.from_numpy(images))
    return cls.numpy(), tokens.numpy()


@pytest.mark.parametrize("variant", ["vit", "dino", "clip"])
def test_hf_checkpoint_matches_jax(tmp_path, variant):
    key = "dinov2" if variant == "dino" else variant
    jcfg, tcfg = _configs(key)
    path = str(tmp_path / f"{variant}.bin")
    torch.save(_hf_model(key).state_dict(), path)
    images = _images()
    jparams = jemb.load_params(jvit.ViT(jcfg), jcfg, variant, path)
    jcls, jtok = _jax_outputs(jparams, jcfg, images)
    tcls, ttok = _port_outputs(path, variant, tcfg, images)
    np.testing.assert_allclose(tcls, jcls, atol=TOL)
    np.testing.assert_allclose(ttok, jtok, atol=TOL)
    assert np.abs(ttok).max() > 0.5                      # not a trivial trunk

    embed = temb.build_vit_embedder(variant, checkpoint_path=path,
                                    device="cpu", cfg=tcfg)
    sd = embed.model.state_dict()
    for k, v in tvit.ViT(tcfg).state_dict().items():
        assert sd[k].shape == v.shape
    np.testing.assert_allclose(
        sd["blocks.1.attn.qkv.weight"].numpy(),
        np.asarray(jparams["params"]["block1"]["attn"]["qkv"]["kernel"])
        .reshape(32, 96).T, atol=0)


def test_clip_projection_from_the_file_matches_transformers(tmp_path):
    """The port projects with the file's `visual_projection` (the JAX
    package zeroes it): the cls embedding equals HF's `image_embeds`."""
    _, tcfg = _configs("clip")
    hf = _hf_model("clip", with_projection=True)
    path = str(tmp_path / "clip_proj.bin")
    torch.save(hf.state_dict(), path)
    images = _images()
    with torch.no_grad():
        ref = hf(pixel_values=torch.from_numpy(images).permute(0, 3, 1, 2)
                 ).image_embeds.numpy()
    tcls, _ = _port_outputs(path, "clip", tcfg, images)
    np.testing.assert_allclose(tcls, ref, atol=TOL)


def _npz(path, tree):
    np.savez(path, params=np.frombuffer(pickle.dumps(tree), dtype=np.uint8))


@pytest.mark.parametrize("variant", ["vit", "dinov2", "clip"])
def test_npz_tree_matches_jax(tmp_path, variant):
    jcfg, tcfg = _configs(variant)
    images = _images()
    params = jax.jit(jvit.ViT(jcfg).init)(jax.random.PRNGKey(1),
                                          jnp.asarray(images))
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(
            np.float32), flax.core.unfreeze(params))
    path = str(tmp_path / f"{variant}.npz")
    _npz(path, tree)
    jparams = jemb.load_params(jvit.ViT(jcfg), jcfg, variant, path)
    jcls, jtok = _jax_outputs(jparams, jcfg, images)
    tcls, ttok = _port_outputs(path, variant, tcfg, images)
    np.testing.assert_allclose(tcls, jcls, atol=TOL)
    np.testing.assert_allclose(ttok, jtok, atol=TOL)


@pytest.mark.parametrize("leaves", ["frozen_dict", "jax_arrays"])
def test_flax_pickled_npz_raises(tmp_path, leaves):
    jcfg, tcfg = _configs("vit")
    params = jax.jit(jvit.ViT(jcfg).init)(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 28, 28, 3)))
    tree = (flax.core.freeze(jax.tree_util.tree_map(np.asarray, params))
            if leaves == "frozen_dict" else params)
    path = str(tmp_path / "flax.npz")
    _npz(path, tree)
    with pytest.raises(ValueError, match="without jax and flax"):
        temb.load_params(tvit.ViT(tcfg), tcfg, "vit", path)
    with pytest.raises(ValueError, match="flax.npz"):
        temb.build_vit_embedder("vit", checkpoint_path=path, device="cpu",
                                cfg=tcfg)
