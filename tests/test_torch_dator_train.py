"""The port's DATOR training (`instance_based_loc_tpu_torch/models/dator/`
losses, FourDNet's training forward, train.py, and the ViT attention's
gradient) against the JAX package on the CPU, on the same numpy inputs, at
a small size (hidden 64, 2 blocks, 32x16 images, 8-sample batches of 4
identities).

Tolerances:
* losses, `margin_logits` and their gradients: 1e-5 (1 + max|ref|) over
  each tensor (the same fp32 maths, sums in another order; the margin
  heads scale cosines by s = 30 and CircleLoss by 256, so rounding grows
  with the largest entry); the attention Function's dq / dk / dv: 1e-5.
  In bf16 (the kernel's precision class), the plain backward against
  `jax.vjp` of the JAX towers' bf16 attention as written:
  |diff| <= 1e-2 + 2^-6 |ref|. The JAX towers round the scores to bf16
  before the softmax (2^-9 of a score of up to ~4 moves P by up to ~1 %),
  then P, dP and dS, and both sides round each gradient to bf16 (one
  step is 2^-8 to 2^-7 of the value); the plain backward computes in fp32.
  Ties of the hardest positive / negative are made exact with integer
  features, so both packages split the gradient over the same entries;
* FourDNet's training outputs and BatchNorm statistics: 1e-4 (fp32
  products and LayerNorm variances summed in another order, through two
  blocks and the fusion head);
* `cosine_schedule` against optax at an int32 count: 1e-6 relative (both
  in fp32; optax's cos and numpy's may differ by an ulp); the optimisers
  over 3 steps: 1e-6;
* one `train_step` against the JAX `train_step` on weights carried over by
  `params_from_jax`: the loss and each component within 1e-5, the updated
  parameters and BatchNorm statistics within 1e-4, and each update (new -
  old) within 1e-3 of its leaf's largest update;
* `augment_batch` given the JAX draws: 1e-6 (the same elementwise maths).
"""

import functools

import numpy as np
import optax
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from instance_based_loc_tpu.models.dator import fourdnet as jfd
from instance_based_loc_tpu.models.dator import losses as jlosses
from instance_based_loc_tpu.models.dator import train as jtrain
from instance_based_loc_tpu.models.dator import transreid_vit as jvit
from instance_based_loc_tpu.ops.pallas.attention import reference_attention
from instance_based_loc_tpu_torch.models.dator import fourdnet as tfd
from instance_based_loc_tpu_torch.models.dator import losses as tlosses
from instance_based_loc_tpu_torch.models.dator import train as ttrain
from instance_based_loc_tpu_torch.models.dator import transreid_vit as tvit
from instance_based_loc_tpu_torch.ops import attention

H, W, B = 32, 16, 8


def _cfgs(**kw):
    """(JAX, port) FourDNet configs at the test size, fp32."""
    geo = dict(img_height=H, img_width=W, patch_size=8, stride_size=8,
               hidden_size=64, num_layers=3, num_heads=4, local_feature=True)
    jb = jvit.TransReIDConfig(dtype=jnp.float32, **geo)
    tb = tvit.TransReIDConfig(dtype=torch.float32, **geo)
    common = dict(reduced_dim=16, num_classes=4, **kw)
    return (jfd.FourDNetConfig(backbone=jb, dtype=jnp.float32, **common),
            tfd.FourDNetConfig(backbone=tb, dtype=torch.float32, **common))


def _perturbed(variables, seed):
    """Non-trivial LoRA up projections, biases and BatchNorm statistics, so
    the comparison reaches them."""
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


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    depth = rng.integers(0, 65536, (B, H, W)).astype(np.uint16)
    labels = np.repeat(np.arange(4), 2).astype(np.int32)
    return rgb, depth, labels


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, atol, name=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=0, err_msg=name)


# --------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------- #
def _loss_inputs(case, rng):
    if case == "ties":
        # integer features: every distance is exact in both packages, and
        # the hardest positive / negative of several anchors tie (samples 0
        # and 1 are one image twice, as PKSampler's padding gives)
        feats = np.array([[0, 0], [0, 0], [1, 0], [0, 1], [1, 1], [-1, 0],
                          [0, -1], [2, 0]], np.float32)
        labels = np.array([0, 0, 0, 1, 1, 2, 2, 1], np.int32)
    else:
        feats = rng.normal(size=(8, 6)).astype(np.float32)
        labels = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    return feats, labels


LOSS_CASES = [
    ("cross_entropy", {}), ("cross_entropy", {"label_smoothing": 0.1}),
    ("batch_hard_triplet", {}), ("batch_hard_triplet", {"margin": 0.3}),
    ("batch_hard_triplet", {"normalize_feature": True}),
    ("batch_hard_triplet", {"ties": True}),
    ("batch_hard_triplet", {"ties": True, "margin": 0.5}),
    ("arcface", {}), ("arcface", {"easy_margin": True, "ls_eps": 0.1}),
    ("cosface", {}), ("amsoftmax", {"s": 10.0, "m": 0.2}), ("circle", {}),
    ("center_loss", {}), ("reid_loss", {"label_smoothing": 0.1}),
]


@pytest.mark.parametrize("name,kw", LOSS_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(LOSS_CASES)])
def test_losses_match_jax(name, kw, rng):
    kw = dict(kw)
    feats, labels = _loss_inputs("ties" if kw.pop("ties", False) else "",
                                 rng)
    other = rng.normal(size=(4, feats.shape[1])).astype(np.float32)
    logits = rng.normal(size=(8, 4)).astype(np.float32) * 3

    def jfn(f, o, lg):
        lab = jnp.asarray(labels)
        if name == "cross_entropy":
            return jlosses.cross_entropy(lg, lab, **kw)
        if name == "batch_hard_triplet":
            return jlosses.batch_hard_triplet(f, lab, **kw)
        if name == "center_loss":
            return jlosses.center_loss(f, lab, o)
        if name == "reid_loss":
            return jlosses.reid_loss(lg, f, lab, **kw)[0]
        return jnp.sum(jnp.sin(jlosses.margin_logits(name, f, o, lab, **kw)))

    def tfn(f, o, lg):
        lab = torch.from_numpy(labels)
        if name == "cross_entropy":
            return tlosses.cross_entropy(lg, lab, **kw)
        if name == "batch_hard_triplet":
            return tlosses.batch_hard_triplet(f, lab, **kw)
        if name == "center_loss":
            return tlosses.center_loss(f, lab, o)
        if name == "reid_loss":
            return tlosses.reid_loss(lg, f, lab, **kw)[0]
        return torch.sum(torch.sin(tlosses.margin_logits(name, f, o, lab,
                                                         **kw)))

    ref, jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2))(
        jnp.asarray(feats), jnp.asarray(other), jnp.asarray(logits))
    ins = [torch.tensor(x, requires_grad=True)
           for x in (feats, other, logits)]
    out = tfn(*ins)
    out.backward()
    _close(out.item(), float(ref), 1e-5 * (1 + abs(float(ref))), "value")
    for t, j, what in zip(ins, jgrads, ("features", "other", "logits")):
        got = np.zeros(t.shape) if t.grad is None else t.grad.numpy()
        _close(got, j, 1e-5 * (1 + np.abs(np.asarray(j)).max()),
               f"d/d{what}")


def test_margin_logits_rejects_an_unknown_head():
    with pytest.raises(ValueError, match="unknown margin head"):
        tlosses.margin_logits("softmax", torch.zeros(2, 3), torch.ones(4, 3),
                              torch.zeros(2, dtype=torch.long))


# --------------------------------------------------------------------- #
# the attention Function
# --------------------------------------------------------------------- #
def _jax_tower_attention(q, k, v):
    """The JAX towers' attention (models/dator/transreid_vit.py:79-82) on
    (B, H, S, D) inputs, as written: P is rounded to the inputs' type."""
    q, k, v = (x.transpose(0, 2, 1, 3) for x in (q, k, v))   # (B, S, H, D)
    attn = jnp.einsum("bqhd,bkhd->bhqk", q, k) * (q.shape[-1] ** -0.5)
    attn = jax.nn.softmax(attn.astype(jnp.float32), axis=-1).astype(q.dtype)
    return jnp.einsum("bhqk,bkhd->bqhd", attn, v).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("valid_len,dtype", [
    pytest.param(None, "float32", id="None"),
    pytest.param(50, "float32", id="50"),
    # the kernel's precision class: the plain backward on bf16 inputs (what
    # the card's kernel is held to) against the JAX towers' bf16 autodiff
    pytest.param(None, "bfloat16", id="bf16"),
])
def test_attention_function_gradients(valid_len, dtype, rng):
    bf16 = dtype == "bfloat16"
    shape = (2, 3, 70, 64 if bf16 else 16)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32)
                  for _ in range(4))
    tdtype = getattr(torch, dtype)
    ins = [torch.tensor(x).to(tdtype).requires_grad_(True)
           for x in (q, k, v)]
    out = attention.vit_attention(*ins, valid_len=valid_len)
    out.backward(torch.from_numpy(g).to(tdtype))
    assert all(x.grad.dtype == tdtype for x in ins)
    ours = [x.grad.float().numpy() for x in ins]
    if bf16:
        _, vjp = jax.vjp(_jax_tower_attention,
                         *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
        for o, r, n in zip(ours, vjp(jnp.asarray(g, jnp.bfloat16)), "qkv"):
            np.testing.assert_allclose(o, np.asarray(r.astype(jnp.float32)),
                                       atol=1e-2, rtol=2 ** -6,
                                       err_msg=f"d{n} vs jax bf16")
        return

    ref_ins = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    attention.vit_attention_reference(*ref_ins, valid_len=valid_len) \
        .backward(torch.from_numpy(g))
    for o, r, n in zip(ours, ref_ins, "qkv"):
        _close(o, r.grad.numpy(), 1e-5, f"d{n} vs torch autograd")

    if valid_len is None:
        jfn = _jax_tower_attention
    else:
        def jfn(q_, k_, v_):
            return reference_attention(q_, k_, v_, valid_len=valid_len)
    _, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    for o, r, n in zip(ours, vjp(jnp.asarray(g)), "qkv"):
        _close(o, r, 1e-5, f"d{n} vs jax")
    if valid_len is not None:       # keys past valid_len: no gradient
        assert not ours[1][:, :, valid_len:].any()
        assert not ours[2][:, :, valid_len:].any()


def _backward_inputs(dtype=torch.bfloat16, d=64):
    q, k, v, g = (torch.zeros((1, 2, 16, d), dtype=dtype) for _ in range(4))
    return q, k, v, g


@pytest.mark.parametrize("case,match", [
    ("bf16_head_size_32", "head size 64"),
    ("grad_shape", "grad_out must have q's shape"),
    ("grad_dtype", "grad_out must have q's dtype"),
    ("grad_device", "grad_out must lie on q's device"),
    ("k_device", "one device"),
    ("valid_len_zero", "valid_len must lie in"),
    ("valid_len_past_s", "valid_len must lie in"),
    ("fp16", "bf16 or fp32"),
    ("batch_heads", "65535"),
    ("cpu", "no attention backward kernel for device cpu"),
])
def test_backward_check_rejects_what_the_kernel_does_not_take(case, match):
    """`_backward_check` raises before any launch; on CPU tensors it stops
    at the device (the wrapper gives them the plain version)."""
    q, k, v, g = _backward_inputs()
    valid = None
    if case == "bf16_head_size_32":
        q, k, v, g = _backward_inputs(d=32)
    elif case == "grad_shape":
        g = g[:, :, :8]
    elif case == "grad_dtype":
        g = g.float()
    elif case == "grad_device":
        g = torch.zeros(g.shape, dtype=g.dtype, device="meta")
    elif case == "k_device":
        k = torch.zeros(k.shape, dtype=k.dtype, device="meta")
    elif case == "valid_len_zero":
        valid = 0
    elif case == "valid_len_past_s":
        valid = 17
    elif case == "fp16":
        q, k, v, g = _backward_inputs(torch.float16)
    elif case == "batch_heads":
        q, k, v, g = (torch.zeros((1, 1, 16, 64), dtype=torch.bfloat16)
                      .expand(65536, 1, 16, 64) for _ in range(4))
    with pytest.raises(ValueError, match=match):
        attention._backward_check(q, k, v, g, valid)


@pytest.mark.parametrize("s,d,dtype,kernel", [
    (50, 64, torch.bfloat16, "fused"),       # CLIP-B/32's heads
    (129, 64, torch.bfloat16, "fused"),      # the DATOR towers'
    (attention.FUSED_MAX_S, 64, torch.bfloat16, "fused"),
    (attention.FUSED_MAX_S + 1, 64, torch.bfloat16, "two_pass"),
    (257, 64, torch.bfloat16, "two_pass"),   # DINOv2-base's
    (129, 64, torch.float32, "two_pass"),    # fp32: the CUDA-core passes
    (129, 32, torch.float32, "two_pass"),
])
def test_backward_kernel_rule(s, d, dtype, kernel):
    """The wrapper's choice between the fused kernel and the two passes is
    a function of (S, D, dtype) alone."""
    assert attention.backward_kernel(s, d, dtype) == kernel


def test_backward_wrapper_checks_a_forced_kernel():
    """Forcing a kernel skips none of the checks: an unknown name raises,
    and a forced kernel still raises for a device it does not run on (CPU
    tensors take the plain version first, so these lie on the meta
    device)."""
    q = torch.zeros((1, 2, 16, 64), dtype=torch.bfloat16, device="meta")
    before = attention.backward_launches
    with pytest.raises(ValueError, match="unknown backward kernel"):
        attention._attention_backward(q, q, q, q, None, kernel="other")
    for kernel in ("fused", "two_pass"):
        with pytest.raises(ValueError, match="no attention backward kernel"):
            attention._attention_backward(q, q, q, q, None, kernel=kernel)
    assert attention.backward_launches == before


def test_backward_wrapper_takes_plain_version_on_cpu(rng):
    shape = (1, 2, 20, 8)
    q, k, v, g = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                  for _ in range(4))
    before = attention.backward_launches
    got = attention._attention_backward(q, k, v, g.transpose(2, 3)
                                        .contiguous().transpose(2, 3), 11)
    assert attention.backward_launches == before
    for a, r in zip(got, attention.vit_attention_backward(q, k, v, g, 11)):
        torch.testing.assert_close(a, r, atol=0, rtol=0)


# --------------------------------------------------------------------- #
# FourDNet's training forward
# --------------------------------------------------------------------- #
class _DropoutDraw(nn.Module):
    """The draw FourDNet's modality dropout makes: the root scope's first
    `make_rng("dropout")`."""
    b: int

    @nn.compact
    def __call__(self):
        return jax.random.randint(self.make_rng("dropout"), (self.b,), 0, 5)


def _jax_modality_p(rng):
    return np.asarray(_DropoutDraw(B).apply({}, rngs={"dropout": rng}))


@pytest.fixture(scope="module")
def jax_variables():
    """One jitted flax init with every head (token_ce on), perturbed;
    `_variables_for` drops what a configuration lacks."""
    jcfg, _ = _cfgs(token_ce=True)
    key = jax.random.PRNGKey(0)
    x = jnp.zeros((2, H, W, 3), jnp.float32)
    init = jax.jit(lambda k: jfd.FourDNet(jcfg).init(
        {"params": k, "dropout": k}, x, x, training=True))
    return jax.tree_util.tree_map(np.asarray, _perturbed(init(key), 1))


def _variables_for(variables, jcfg, center_classes=0):
    params = {k: v for k, v in variables["params"].items()
              if jcfg.token_ce or not k.startswith("token_")}
    if center_classes:
        params["center_centers"] = np.random.default_rng(9).normal(
            size=(center_classes, jcfg.reduced_dim)).astype(np.float32)
    stats = {k: v for k, v in variables["batch_stats"].items()
             if jcfg.token_ce or not k.startswith("token_")}
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("detach_fusion,token_ce,modality", [
    (False, False, False), (True, True, True)])
def test_fourdnet_training_forward_matches_flax(detach_fusion, token_ce,
                                                modality, jax_variables, rng):
    jcfg, tcfg = _cfgs(detach_fusion=detach_fusion, token_ce=token_ce,
                       modality_dropout=modality)
    variables = _variables_for(jax_variables, jcfg)
    rgb = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    depth = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    apply = jax.jit(lambda v, r, d: jfd.FourDNet(jcfg).apply(
        v, r, d, training=True, rngs={"dropout": key},
        mutable=["batch_stats", "intermediates"]))
    out, mutated = apply(variables, jnp.asarray(rgb), jnp.asarray(depth))
    port = tfd.FourDNet(tcfg)
    port.load_state_dict(ttrain.params_from_jax(variables, port))
    p = _t(_jax_modality_p(key)) if modality else None
    with torch.no_grad():
        got = port(_t(rgb), _t(depth), training=True, modality_p=p)
    _close(got.cls_score, out[0], 1e-4, "class scores")
    _close(got.embedding, out[1], 1e-4, "embedding")
    for a, r, n in zip(got.aux_scores, out[2], ("rgb", "depth")):
        _close(a, r, 1e-4, f"aux {n}")
    _close(got.embedding_raw,
           mutated["intermediates"]["embedding_raw"][0], 1e-4, "raw")
    if token_ce:
        _close(got.tok_scores, out[3], 1e-4, "token scores")
    else:
        assert got.tok_scores is None and len(out) == 3
    state = port.state_dict()
    for name, key_ in ttrain._npz_keys(port).items():
        if key_.startswith("['batch_stats']"):
            node = mutated
            for part in key_.strip("[]'").split("']['"):
                node = node[part]
            _close(state[name], node, 1e-4, name)


def test_training_forward_needs_the_dropout_draws():
    _, tcfg = _cfgs()
    port = tfd.FourDNet(tcfg)
    x = torch.zeros(2, H, W, 3)
    with pytest.raises(ValueError, match="modality_p"):
        port(x, x, training=True)


# --------------------------------------------------------------------- #
# schedule and optimisers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("epochs,warmup,spe,offset", [
    (4, 1, 5, 0), (3, 0, 4, 0), (2, 5, 3, 0), (1, 1, 1, 0), (4, 1, 5, 7)])
def test_cosine_schedule_matches_optax(epochs, warmup, spe, offset):
    kw = dict(base_lr=0.008, epochs=epochs, warmup_epochs=warmup,
              steps_per_epoch=spe, schedule_offset_steps=offset)
    ref = jtrain.cosine_schedule(jtrain.TrainConfig(**kw))
    ours = ttrain.cosine_schedule(ttrain.TrainConfig(**kw))
    for count in range(epochs * spe + 3):
        np.testing.assert_allclose(ours(count), float(ref(jnp.int32(count))),
                                   rtol=1e-6, atol=1e-12,
                                   err_msg=f"count {count}")


class _Leaf(torch.nn.Module):
    def __init__(self, **params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, torch.nn.Parameter(_t(v)))


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("clip", [1000.0, 0.5])
def test_optimizers_match_optax(optimizer, clip, rng):
    """Three updates of a tree with a frozen tower weight, a LoRA matrix,
    a head and a BatchNorm statistic. clip 0.5 clips every step, on a norm
    the frozen weight's gradient dominates."""
    vals = {"qkv": rng.normal(size=(4, 6)), "lora": rng.normal(size=(4, 2)),
            "head": rng.normal(size=(3, 5)), "mean": rng.normal(size=3)}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              * (5.0 if k == "qkv" else 1.0) for k, v in vals.items()}
             for _ in range(3)]
    kw = dict(optimizer=optimizer, base_lr=0.05, weight_decay=0.01,
              grad_clip=clip, epochs=3, steps_per_epoch=1, warmup_epochs=1)

    def jtree(d):
        return {"params": {"towers": {"block0": {"attn": {
                    "qkv": {"kernel": d["qkv"]}, "lora_down": d["lora"]}}},
                    "head": {"kernel": d["head"]}},
                "batch_stats": {"bottleneck": {"mean": d["mean"]}}}
    params = jax.tree_util.tree_map(jnp.asarray, jtree(vals))
    tx = jtrain.make_optimizer(jtrain.TrainConfig(**kw), params)
    opt_state = tx.init(params)

    model = torch.nn.Module()
    model.towers = torch.nn.Module()
    model.towers.block0 = torch.nn.Module()
    model.towers.block0.attn = _Leaf(lora_down=vals["lora"])
    model.towers.block0.attn.qkv = _Leaf(kernel=vals["qkv"])
    model.head = _Leaf(kernel=vals["head"])
    model.register_buffer("mean", _t(vals["mean"]))
    state = ttrain.new_train_state(model, ttrain.TrainConfig(**kw))
    assert state.trainable == ["towers.block0.attn.lora_down", "head.kernel"]
    for g in grads:
        jg = jtree({**g, "mean": np.zeros_like(g["mean"])})
        updates, opt_state = tx.update(jax.tree_util.tree_map(
            jnp.asarray, jg), opt_state, params)
        params = optax.apply_updates(params, updates)
        model.towers.block0.attn.qkv.kernel.grad = _t(g["qkv"])
        model.towers.block0.attn.lora_down.grad = _t(g["lora"])
        model.head.kernel.grad = _t(g["head"])
        norm = ttrain.apply_gradients(state)
        _close(norm, optax.global_norm(jg), 1e-5, "norm")
    p = params["params"]
    _close(model.towers.block0.attn.qkv.kernel.detach(),
           p["towers"]["block0"]["attn"]["qkv"]["kernel"], 1e-6, "frozen")
    _close(model.towers.block0.attn.qkv.kernel.detach(), vals["qkv"], 0,
           "frozen moved")
    _close(model.towers.block0.attn.lora_down.detach(),
           p["towers"]["block0"]["attn"]["lora_down"], 1e-6, "lora")
    _close(model.head.kernel.detach(), p["head"]["kernel"], 1e-6, "head")
    _close(model.mean, vals["mean"], 0, "statistics moved")
    assert state.step == 3


# --------------------------------------------------------------------- #
# dequantisation, augmentation, one train step
# --------------------------------------------------------------------- #
def _jax_augment_draws(key):
    """`augment_batch`'s draws, with the JAX package's keys and ranges."""
    k_flip, k_dx, k_dy, k_re, k_rx, k_ry, k_rw, k_rh = jax.random.split(key, 8)
    u = jax.random.uniform
    return ttrain.AugmentDraws(
        flip=_t(jax.random.bernoulli(k_flip, 0.5, (B,))),
        dx=_t(jax.random.randint(k_dx, (B,), -10, 11)),
        dy=_t(jax.random.randint(k_dy, (B,), -10, 11)),
        re_on=_t(jax.random.bernoulli(k_re, 0.5, (B,))),
        area=_t(u(k_rw, (B,), minval=0.02, maxval=0.4)),
        log_aspect=_t(u(k_rh, (B,), minval=jnp.log(0.3),
                        maxval=jnp.log(3.3))),
        ry=_t(u(k_ry, (B,))), rx=_t(u(k_rx, (B,))))


def test_dequantize_and_augment_match_jax():
    rgb, depth, _ = _batch(3)
    jr, jd = jtrain.dequantize_batch(jnp.asarray(rgb), jnp.asarray(depth))
    tr, td = ttrain.dequantize_batch(_t(rgb), _t(depth.astype(np.int32)))
    _close(tr, jr, 0, "rgb")
    _close(td, jd, 0, "depth")
    key = jax.random.PRNGKey(11)
    jr2, jd2 = jtrain.augment_batch(jr, jd, key)
    draws = _jax_augment_draws(key)
    assert draws.flip.any() and draws.re_on.any() and not draws.flip.all()
    tr2, td2 = ttrain.augment_batch(tr, td, draws)
    _close(tr2, jr2, 1e-6, "augmented rgb")
    _close(td2, jd2, 1e-6, "augmented depth")


STEP_CASES = {
    # SGD, no draws, LoRA-only, a clip that triggers on a norm the frozen
    # weights' gradients are part of: each update is held to its leaf's
    # scale
    "plain": (dict(modality_dropout=False),
              dict(optimizer="sgd", base_lr=0.1, grad_clip=1.0), False),
    # everything else at once (one jit compile): modality dropout and
    # augmentation from the JAX draws, token CE, detach_fusion, the
    # arcface head, centre loss, the pre-BNNeck triplet, label smoothing,
    # AdamW with a visible weight decay, every weight trainable, and a
    # clip that triggers
    "draws": (dict(modality_dropout=True, token_ce=True, detach_fusion=True),
              dict(optimizer="adamw", base_lr=0.1, weight_decay=0.5,
                   augment=True, id_loss_type="arcface",
                   center_loss_weight=0.05, triplet_feature="pre_bn",
                   label_smoothing=0.1, lora_only=False, grad_clip=1.0),
              True),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case, jax_variables):
    model_kw, train_kw, draws_from_jax = STEP_CASES[case]
    jcfg, tcfg = _cfgs(**model_kw)
    kw = dict(epochs=2, steps_per_epoch=3, warmup_epochs=1, **train_kw)
    jtcfg, ttcfg = jtrain.TrainConfig(**kw), ttrain.TrainConfig(**kw)
    params = _variables_for(jax_variables, jcfg,
                            jcfg.num_classes if ttcfg.center_loss_weight
                            else 0)
    tx = jtrain.make_optimizer(jtcfg, params)
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               opt_state=tx.init(params), tx=tx,
                               apply_fn=jfd.FourDNet(jcfg).apply)

    state = ttrain.create_train_state(tcfg, ttcfg, device="cpu")
    state.model.load_state_dict(ttrain.params_from_jax(params, state.model))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}

    rgb, depth, labels = _batch()
    rng = jax.random.PRNGKey(5)
    step = jax.jit(functools.partial(jtrain.train_step, train_cfg=jtcfg))
    jnew, jm = step(jstate, jnp.asarray(rgb), jnp.asarray(depth),
                    jnp.asarray(labels), rng)
    if draws_from_jax:
        aug_key, drop_key = jax.random.split(jax.random.fold_in(rng, 17))
        draws = ttrain.StepDraws(_t(_jax_modality_p(drop_key)),
                                 _jax_augment_draws(aug_key))
    else:
        draws = ttrain.StepDraws(None, None)
    tm = ttrain.train_step(state, _t(rgb), _t(depth.astype(np.int32)),
                           _t(labels), draws)
    assert set(jm) <= set(tm), (sorted(jm), sorted(tm))
    for k in jm:
        _close(tm[k], jm[k], 1e-5, k)
    assert float(tm["grad_norm"]) > ttcfg.grad_clip     # the clip acts

    after = ttrain.params_from_jax(jnew.params, state.model)
    got = state.model.state_dict()
    moved = 0
    for name, ref in after.items():
        _close(got[name], ref, 1e-4, name)
        scale = np.abs((ref - before[name]).numpy()).max()
        if case == "plain":
            _close(got[name] - before[name], ref - before[name],
                   1e-3 * scale + 1e-7, f"update of {name}")
        moved += scale > 0
    if ttcfg.lora_only:
        frozen = [n for n in after if n.startswith("towers.")
                  and "lora" not in n]
        assert all(torch.equal(got[n], before[n]) for n in frozen)
    assert moved > len(after) // 2


def test_create_train_state_loads_pretrained_towers(tmp_path):
    """--pretrained: an HF ViT state dict (with the classifier model's
    "vit." prefix) goes into both towers through
    `port_hf_vit_to_transreid`; the LoRA adapters keep their init."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.ViTConfig(
        image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=256)
    torch.manual_seed(2)
    hf = transformers.ViTModel(hf_cfg, add_pooling_layer=False)
    path = str(tmp_path / "vit.bin")
    torch.save({f"vit.{k}": v for k, v in hf.state_dict().items()}, path)
    _, tcfg = _cfgs()
    plain = ttrain.create_train_state(tcfg, ttrain.TrainConfig(),
                                      device="cpu")
    state = ttrain.create_train_state(tcfg, ttrain.TrainConfig(),
                                      pretrained_path=path, device="cpu")
    ported = tvit.port_hf_vit_to_transreid(
        {k: v.numpy() for k, v in hf.state_dict().items()}, tcfg.backbone,
        towers=2)
    got = state.model.state_dict()
    for name, value in ported.items():
        torch.testing.assert_close(got[f"towers.{name}"], value.float(),
                                   atol=0, rtol=0)
    for name, value in plain.model.state_dict().items():
        if "lora" in name or not name.startswith("towers."):
            torch.testing.assert_close(got[name], value, atol=0, rtol=0)
