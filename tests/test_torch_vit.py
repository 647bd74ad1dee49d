"""The port's ViT trunk, crop preprocessing and embedders against the JAX
package's.

* ViT trunk, small (2 layers, hidden 64, 4 heads, image 28, patch 14), fp32,
  with the JAX module's (perturbed) weights carried across by
  `params_from_jax`: cls embeddings within atol 1e-4 (fp32 maths in another
  order through 2 blocks).
* `preprocess_crop` against the JAX version (PIL): PIL resamples in fixed
  point, so each of its two passes may round a pixel one uint8 step the
  other way: |diff| <= 2/255/std after normalisation, and the mean |diff|
  stays below 5e-3 (measured at most 4.3e-3 over 60 random crops).
* the weights-free `color` and `dummy` embedders: exactly equal.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from instance_based_loc_tpu.models import vit as jvit
from instance_based_loc_tpu.models.vit_embedder import (
    preprocess_crop as jax_preprocess, _NORMS)
from instance_based_loc_tpu.models.embedders import (
    get_embedder as jax_get_embedder)
from instance_based_loc_tpu.memory.detection import (
    ColorRegionDetector as JaxColorRegionDetector)
from instance_based_loc_tpu_torch.models import vit as tvit
from instance_based_loc_tpu_torch.models.vit_embedder import (
    build_vit_embedder, preprocess_crop)
from instance_based_loc_tpu_torch.models.embedders import get_embedder
from instance_based_loc_tpu_torch.memory.detection import (
    ColorRegionDetector, Detections)
from instance_based_loc_tpu_torch.data.synthetic import (
    default_scene, render_scene, ring_poses)

SMALL = dict(image_size=28, patch_size=14, hidden_size=64, num_layers=2,
             num_heads=4, mlp_dim=128)


def _configs(variant):
    proj = 32 if variant == "clip" else None
    jcfg = dataclasses.replace(jvit.VARIANTS[variant], **SMALL,
                               projection_dim=proj, dtype=jnp.float32)
    tcfg = dataclasses.replace(tvit.VARIANTS[variant], **SMALL,
                               projection_dim=proj, dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_trunks():
    """Per variant: JAX params (perturbed so no leaf keeps its trivial
    init), images, and the JAX cls embeddings."""
    rng = np.random.default_rng(0)
    images = rng.normal(size=(3, 28, 28, 3)).astype(np.float32)
    out = {}
    for variant in ("vit", "dinov2", "clip"):
        jcfg, _ = _configs(variant)
        model = jvit.ViT(jcfg)
        params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                     jnp.asarray(images))
        params = jax.tree_util.tree_map(
            lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape)
            .astype(np.float32), params)
        cls, _ = jax.jit(model.apply)(params, jnp.asarray(images))
        out[variant] = (params, images, np.asarray(cls))
    return out


@pytest.mark.parametrize("variant", ["vit", "dinov2", "clip"])
def test_vit_trunk_matches_jax(jax_trunks, variant):
    params, images, jax_cls = jax_trunks[variant]
    _, tcfg = _configs(variant)
    model = tvit.ViT(tcfg)
    model.load_state_dict(tvit.params_from_jax(params, tcfg))
    with torch.no_grad():
        cls, tokens = model(torch.from_numpy(images))
    assert tokens.shape == (3, tcfg.num_patches + 1, tcfg.hidden_size)
    np.testing.assert_allclose(cls.numpy(), jax_cls, atol=1e-4)


@pytest.mark.parametrize("variant", ["dino", "vit", "clip"])
def test_preprocess_crop_matches_jax(variant):
    rng = np.random.default_rng(1)
    std = _NORMS["dinov2" if variant == "dino" else variant][1]
    atol = 2.0 / 255.0 / float(np.min(std)) + 1e-5
    for shape in [(37, 53), (300, 200), (120, 120), (20, 257), (256, 300)]:
        crop = rng.integers(0, 256, size=shape + (3,), dtype=np.uint8)
        ref = jax_preprocess(crop, variant)
        out = preprocess_crop(crop, variant).numpy()
        assert out.shape == ref.shape == (224, 224, 3)
        diff = np.abs(out - ref)
        assert diff.max() <= atol, (shape, diff.max())
        assert diff.mean() < 5e-3, (shape, diff.mean())


def test_weights_free_embedders_match_jax():
    scene = default_scene(num_objects=4, seed=2)
    rgb, depth, _ = render_scene(scene, ring_poses(4)[1], 96, 128, 120.0)
    det = ColorRegionDetector(min_area=40).find(rgb, False)
    jdet = JaxColorRegionDetector(min_area=40).find(rgb, False)
    assert len(det) == len(jdet) > 0
    for name in ("color", "dummy"):
        out = get_embedder(name)(detections=det, full_rgb_image=rgb)
        ref = jax_get_embedder(name)(detections=jdet, full_rgb_image=rgb)
        np.testing.assert_array_equal(out, ref)


def test_vit_embedder_batches_and_is_deterministic():
    rng = np.random.default_rng(2)
    crops = [rng.integers(0, 256, size=(30 + 3 * i, 40 + 2 * i, 3),
                          dtype=np.uint8) for i in range(5)]
    det = Detections(crops, np.zeros((5, 4), np.float32),
                     np.zeros((5, 8, 8), bool), list("abcde"))
    _, tcfg = _configs("dinov2")
    cfg = dataclasses.replace(tcfg, image_size=224)
    e1 = build_vit_embedder("dino", device="cpu", cfg=cfg, max_crops=2)
    e2 = build_vit_embedder("dino", device="cpu", cfg=cfg, max_crops=2)
    out1, out2 = e1(det), e2(det)
    assert out1.shape == (5, 64) and e1.batches == 3
    np.testing.assert_array_equal(out1, out2)      # seeded weights
    assert np.abs(out1[0] - out1[1]).max() > 1e-3  # crops differ


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_vit_embedder("dino")
