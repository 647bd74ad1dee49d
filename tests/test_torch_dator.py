"""The port's DATOR inference (`instance_based_loc_tpu_torch/models/dator/`)
against the JAX package on the CPU, at small widths.

Tolerances:
* `bilinear_sample` against JAX and against torch's grid_sample: 1e-5 (the
  same fp32 weights and products, reordered sums in grid_sample);
* a TransReID tower (SIE, LoRA, final norm) and a FourDNet forward in fp32
  with the same weights (`params_from_jax`): tokens, embedding, class
  scores and class tokens within 1e-4 (fp32 matmuls and LayerNorm variances
  summed in another order, through 2-3 blocks and the fusion head);
* `port_hf_vit_to_transreid` on a random-init `transformers` ViT: the
  port's tokens against the JAX package's within 1e-4;
* the npz checkpoint path: a tiny JAX-written npz with 7 classes and no
  BNNeck entries, loaded with strict=False by both packages' embedders,
  gives embeddings within 1e-4;
* `preprocess_rgb` / `preprocess_depth`: exactly equal (the port runs
  PIL's bilinear resize in numpy).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from instance_based_loc_tpu.memory.detection import (
    Detections as JaxDetections)
from instance_based_loc_tpu.models.dator import data as jdata
from instance_based_loc_tpu.models.dator import fourdnet as jfd
from instance_based_loc_tpu.models.dator import transreid_vit as jvit
from instance_based_loc_tpu.models.dator.embedder import (
    build_dator_embedder as jax_build_embedder)
from instance_based_loc_tpu.models.dator.train import (
    save_params_npz as jax_save_params_npz)
from instance_based_loc_tpu_torch.memory.detection import Detections
from instance_based_loc_tpu_torch.models.dator import data as tdata
from instance_based_loc_tpu_torch.models.dator import fourdnet as tfd
from instance_based_loc_tpu_torch.models.dator import transreid_vit as tvit
from instance_based_loc_tpu_torch.models.dator.embedder import (
    build_dator_embedder)
from instance_based_loc_tpu_torch.models.dator.train import (
    flat_npz_to_tree, load_params_npz, params_from_jax, save_params_npz)
from instance_based_loc_tpu_torch.models.embedders import get_embedder

TOL = 1e-4


def _cfgs(num_layers=3, **kw):
    jb = jvit.TransReIDConfig(img_height=32, img_width=16, patch_size=8,
                              stride_size=8, hidden_size=32,
                              num_layers=num_layers, num_heads=4,
                              local_feature=True, dtype=jnp.float32, **kw)
    tb = tvit.TransReIDConfig(img_height=32, img_width=16, patch_size=8,
                              stride_size=8, hidden_size=32,
                              num_layers=num_layers, num_heads=4,
                              local_feature=True, dtype=torch.float32, **kw)
    return jb, tb


def _fourdnet_cfgs(num_classes=5, **kw):
    jb, tb = _cfgs()
    return (jfd.FourDNetConfig(backbone=jb, reduced_dim=16,
                               num_classes=num_classes, dtype=jnp.float32,
                               **kw),
            tfd.FourDNetConfig(backbone=tb, reduced_dim=16,
                               num_classes=num_classes, dtype=torch.float32,
                               **kw))


def _perturbed(variables, seed):
    """The init tree with every LoRA up projection, BatchNorm statistic and
    bias made non-trivial, so the comparison reaches them."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        arr = np.asarray(leaf, np.float32)
        if name in ("lora_up", "bias", "mean"):
            return arr + rng.normal(0, 0.1, arr.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, arr.shape).astype(np.float32)
        return arr
    return jax.tree_util.tree_map_with_path(fill, variables)


def test_bilinear_sample_matches_jax_and_grid_sample(rng):
    vmap = rng.normal(size=(3, 4, 6, 5)).astype(np.float32)   # (B, H, W, C)
    gx = rng.uniform(-1.2, 1.2, size=(3, 10, 7)).astype(np.float32)
    gy = rng.uniform(-1.2, 1.2, size=(3, 10, 7)).astype(np.float32)
    ours = tfd.bilinear_sample(torch.as_tensor(vmap), torch.as_tensor(gx),
                               torch.as_tensor(gy)).numpy()
    ref = np.asarray(jax.vmap(jfd.bilinear_sample)(
        jnp.asarray(vmap), jnp.asarray(gx), jnp.asarray(gy)))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    grid = torch.as_tensor(np.stack([gx, gy], axis=-1))
    gs = torch.nn.functional.grid_sample(
        torch.as_tensor(vmap).permute(0, 3, 1, 2), grid, align_corners=True,
        padding_mode="zeros").permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, gs, atol=1e-5)
    # one map without a batch axis, as the JAX function takes it
    one = tfd.bilinear_sample(torch.as_tensor(vmap[0]), torch.as_tensor(gx[0]),
                              torch.as_tensor(gy[0])).numpy()
    np.testing.assert_allclose(one, ours[0], atol=1e-6)


@pytest.mark.parametrize("local_feature,sie", [(False, True), (True, False)])
def test_transreid_tower_matches_jax(rng, local_feature, sie):
    extra = dict(cameras=2, views=3) if sie else {}
    jb, tb = _cfgs(num_layers=3, **extra)
    jb = dataclasses.replace(jb, local_feature=local_feature)
    tb = dataclasses.replace(tb, local_feature=local_feature)
    x = rng.normal(size=(2, 32, 16, 3)).astype(np.float32)
    cams = np.array([0, 1]) if sie else None
    views = np.array([2, 0]) if sie else None
    jmodel = jvit.TransReIDViT(jb)
    variables = _perturbed(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x),
        None if cams is None else jnp.asarray(cams),
        None if views is None else jnp.asarray(views)), 1)
    ref = np.asarray(jmodel.apply(
        variables, jnp.asarray(x),
        None if cams is None else jnp.asarray(cams),
        None if views is None else jnp.asarray(views)))

    port = tvit.TransReIDViT(tb, towers=1)
    # one JAX tower is the port's tower axis of length 1
    stacked = jax.tree_util.tree_map(lambda a: np.asarray(a)[None], variables)
    port.load_state_dict(params_from_jax(stacked, port))
    with torch.no_grad():
        out = port(torch.as_tensor(x)[None],
                   None if cams is None else torch.as_tensor(cams),
                   None if views is None else torch.as_tensor(views))[0]
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL)


def test_fourdnet_forward_matches_jax(rng):
    jcfg, tcfg = _fourdnet_cfgs()
    rgb = rng.normal(size=(3, 32, 16, 3)).astype(np.float32)
    depth = rng.normal(size=(3, 32, 16, 3)).astype(np.float32)
    jmodel = jfd.FourDNet(jcfg)
    key = jax.random.PRNGKey(0)
    variables = _perturbed(jmodel.init({"params": key, "dropout": key},
                                       jnp.asarray(rgb), jnp.asarray(depth),
                                       training=True), 2)
    jscore, jemb, (jrc, jdc) = jmodel.apply(
        variables, jnp.asarray(rgb), jnp.asarray(depth), training=False,
        return_cls_tokens=True)

    port = tfd.FourDNet(tcfg)
    port.load_state_dict(params_from_jax(variables, port))
    with torch.no_grad():
        score, emb, (rc, dc) = port(torch.as_tensor(rgb),
                                    torch.as_tensor(depth),
                                    return_cls_tokens=True)
    for name, o, r in (("embedding", emb, jemb), ("scores", score, jscore),
                       ("rgb cls", rc, jrc), ("depth cls", dc, jdc)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=TOL,
                                   err_msg=name)
    # the towers keep JAX's stacked layout: one npz entry per state entry
    assert port.state_dict()["towers.patch_embed.kernel"].shape[0] == 2


def test_port_hf_vit_to_transreid_matches_jax():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.ViTConfig(
        image_size=32, patch_size=8, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128)
    torch.manual_seed(1)
    hf = transformers.ViTModel(hf_cfg, add_pooling_layer=False)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    jb, tb = _cfgs(num_layers=2)
    # an overlapping 48x24 grid: the pos embedding is resized
    jb = dataclasses.replace(jb, img_height=48, img_width=24, stride_size=4)
    tb = dataclasses.replace(tb, img_height=48, img_width=24, stride_size=4)
    x = np.random.default_rng(3).normal(size=(2, 48, 24, 3)).astype(np.float32)
    jmodel = jvit.TransReIDViT(jb)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jmodel.apply(jvit.port_hf_vit_to_transreid(sd, jb, init),
                                  jnp.asarray(x)))

    port = tvit.TransReIDViT(tb, towers=2)
    ported = tvit.port_hf_vit_to_transreid(sd, tb, towers=2)
    missing, unexpected = port.load_state_dict(ported, strict=False)
    # only the adapters keep their init (zero LoRA up: the identity)
    assert not unexpected and all("lora" in k for k in missing), missing
    with torch.no_grad():
        out = port(torch.as_tensor(np.stack([x, x])))
    np.testing.assert_allclose(out[0].numpy(), ref, atol=TOL)
    np.testing.assert_allclose(out[1].numpy(), ref, atol=TOL)


def test_resize_pos_embed_matches_jax(rng):
    pos = rng.normal(size=(1, 1 + 7 * 7, 16)).astype(np.float32)
    np.testing.assert_allclose(tvit.resize_pos_embed(pos, 16, 8),
                               jvit.resize_pos_embed(pos, 16, 8), atol=1e-5)


def _detections(pkg_detections, rng, n):
    rgb = rng.uniform(0, 255, (40, 30, 3)).astype(np.uint8)
    depth = rng.uniform(0, 2, (40, 30)).astype(np.float32)
    boxes = np.array([[2 + i % 5, 1 + i % 3, 24 + i % 6, 38 - i % 4]
                      for i in range(n)], np.float32)
    crops = [rgb[int(b[1]):int(b[3]), int(b[0]):int(b[2])] for b in boxes]
    return pkg_detections(crops=crops, boxes_xyxy=boxes,
                          masks=np.ones((n, 40, 30), bool),
                          phrases=["thing"] * n), rgb, depth


def test_npz_without_bnneck_gives_the_same_embeddings(tmp_path, rng):
    """A JAX-written npz whose head has 7 classes and which holds no BNNeck
    entries: both embedders adopt the class count, keep their BNNeck init
    (strict=False) and give the same embeddings."""
    jcfg, tcfg = _fourdnet_cfgs(num_classes=7)
    jmodel = jfd.FourDNet(jcfg)
    x = jnp.zeros((1, 32, 16, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    variables = _perturbed(jmodel.init({"params": key, "dropout": key}, x, x,
                                       training=True), 3)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {"params": {k: v for k, v in variables["params"].items()
                            if k != "bottleneck"}}
    path = str(tmp_path / "dator.npz")
    jax_save_params_npz(variables, path)
    assert "bottleneck" not in flat_npz_to_tree(path)["params"]

    kw = dict(height=32, width=16, max_crops=4, feature="embedding")
    jembed = jax_build_embedder(
        path, model_cfg=dataclasses.replace(jcfg, num_classes=100), **kw)
    tembed = build_dator_embedder(
        path, model_cfg=dataclasses.replace(tcfg, num_classes=100),
        device="cpu", **kw)
    assert tembed.model.cfg.num_classes == 7
    jdet, rgb, depth = _detections(JaxDetections, rng, 5)
    tdet = Detections(jdet.crops, jdet.boxes_xyxy, jdet.masks, jdet.phrases)
    ref = jembed(jdet, full_rgb_image=rgb, full_depth_image=depth)
    out = tembed(tdet, full_rgb_image=rgb, full_depth_image=depth)
    assert out.shape == (5, 16) and tembed.batches == 2   # 4 + 1 crops
    np.testing.assert_allclose(out, np.asarray(ref), atol=TOL)


def test_npz_round_trip_and_strict_load(tmp_path):
    _, tcfg = _fourdnet_cfgs()
    model = tfd.FourDNet(tcfg)
    tfd.init_params(model, torch.Generator().manual_seed(0))
    path = str(tmp_path / "p.npz")
    save_params_npz(model, path)
    fresh = tfd.FourDNet(tcfg)
    fresh.load_state_dict(load_params_npz(fresh, path))
    for name, value in model.state_dict().items():
        # fp32 values pass through fp16
        np.testing.assert_allclose(fresh.state_dict()[name].numpy(),
                                   value.numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=name)
    np.savez(str(tmp_path / "small.npz"),
             **{"['params']['Q_r']['bias']": np.zeros(16, np.float16)})
    with pytest.raises(KeyError, match="missing"):
        load_params_npz(fresh, str(tmp_path / "small.npz"))
    kept = load_params_npz(fresh, str(tmp_path / "small.npz"), strict=False)
    assert torch.equal(kept["towers.pos_embed"],
                       fresh.state_dict()["towers.pos_embed"])


def test_embedder_registry_and_checkpoint_kinds(tmp_path):
    _, tcfg = _fourdnet_cfgs()
    embed = get_embedder("dator", device="cpu", model_cfg=tcfg, height=32,
                         width=16)
    assert isinstance(embed.model, tfd.FourDNet)
    with pytest.raises(ValueError, match="orbax"):
        build_dator_embedder(str(tmp_path / "step_100"), model_cfg=tcfg,
                             device="cpu")


@pytest.mark.parametrize("shape", [(37, 23), (300, 90), (256, 128), (5, 400)])
def test_preprocess_equals_jax_exactly(rng, shape):
    rgb = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    depth = rng.uniform(0, 60, shape).astype(np.float32)
    np.testing.assert_array_equal(tdata.preprocess_rgb(rgb),
                                  jdata.preprocess_rgb(rgb))
    np.testing.assert_array_equal(tdata.preprocess_depth(depth),
                                  jdata.preprocess_depth(depth))
    rgb_depth = rng.uniform(0, 60, shape + (3,)).astype(np.float32)
    np.testing.assert_array_equal(tdata.preprocess_depth(rgb_depth),
                                  jdata.preprocess_depth(rgb_depth))
