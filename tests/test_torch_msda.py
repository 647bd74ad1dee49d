"""The port's MSDA (gather plain version, tap folding, the whole op) against
the JAX package's, on the CPU, at a level above the JAX package's
MATMUL_MAX_S = 4096 rows so its gather route runs (the tiny GroundingDINO
config never reaches it; the port gathers every level).

* `msda_level_gather_reference` against the JAX `msda_level_gather_reference`
  and the Pallas kernel run in interpret mode, fp32 and bf16 values: atol
  1e-5 (both sides upcast the same values and sum 16 fp32 products in
  another order).
* the bilinear taps against the JAX `_tap_index_weights_bcast`: indices
  exact, weights atol 1e-6.
* `multi_scale_deformable_attention` on levels (65, 65) + (8, 8) against
  the JAX op: fp32 atol 1e-5. In bf16 the JAX op rounds each coefficient
  and each product to bf16 before its fp32 sum and the port does not (the
  Pallas kernel's contract), so each of the terms may differ by 2^-8 of
  its size: |diff| <= 2^-7 * sum |coeff * v| + 1e-5, computed per output.
* the same op with K = 2 and K = 8 sampling points (T = 8 and 32 taps per
  level), fp32: atol 1e-5.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from instance_based_loc_tpu.ops import msda as jmsda
from instance_based_loc_tpu.ops.pallas.msda_gather import (
    msda_level_gather_pallas, msda_level_gather_reference as jax_gather_ref)
from instance_based_loc_tpu_torch.ops import msda as tmsda
from instance_based_loc_tpu_torch.ops.msda_gather import (
    msda_level_gather, msda_level_gather_reference)

SHAPES = ((65, 65), (8, 8))          # 4225 rows: above JAX's MATMUL_MAX_S


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_plain_version_matches_jax(dtype):
    rng = np.random.default_rng(0)
    s, h, d, q = 65 * 65, 2, 32, 300
    v = rng.normal(size=(s, h, d)).astype(np.float32)
    lin = rng.integers(0, s, size=(q, h, 16)).astype(np.int32)
    coeff = rng.normal(size=(q, h, 16)).astype(np.float32)
    jv = jnp.asarray(v, dtype)
    ref = np.asarray(jax_gather_ref(jv, jnp.asarray(lin), jnp.asarray(coeff)))
    pallas = np.asarray(msda_level_gather_pallas(
        jv, jnp.asarray(lin), jnp.asarray(coeff), interpret=True))
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    plain = msda_level_gather_reference(tv, torch.from_numpy(lin),
                                        torch.from_numpy(coeff)).numpy()
    np.testing.assert_allclose(plain, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(plain, pallas, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        msda_level_gather(tv, torch.from_numpy(lin),
                          torch.from_numpy(coeff)).numpy(), plain)


def test_tap_index_weights_match_jax():
    rng = np.random.default_rng(1)
    loc = rng.uniform(-0.05, 1.05, size=(40, 2, 4, 2)).astype(np.float32)
    jy, jx, jw = jmsda._tap_index_weights_bcast(jnp.asarray(loc), 65, 65)
    ty, tx, tw = tmsda._tap_index_weights(torch.from_numpy(loc), 65, 65)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)


def _msda_inputs(seed, k=4):
    rng = np.random.default_rng(seed)
    b, heads, d, q = 2, 2, 8, 60
    s = sum(hh * ww for hh, ww in SHAPES)
    value = rng.normal(size=(b, s, heads, d)).astype(np.float32)
    # spill past [0, 1] to pin zero padding in both packages
    loc = rng.uniform(-0.05, 1.05,
                      size=(b, q, heads, len(SHAPES), k, 2)).astype(np.float32)
    w = rng.uniform(size=(b, q, heads, len(SHAPES), k)).astype(np.float32)
    w /= w.reshape(b, q, heads, -1).sum(-1)[..., None, None]
    return value, loc, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_msda_matches_jax_above_gather_threshold(dtype):
    value, loc, w = _msda_inputs(2)
    jout = np.asarray(jmsda.multi_scale_deformable_attention(
        jnp.asarray(value, dtype), SHAPES, jnp.asarray(loc), jnp.asarray(w)))
    tval = torch.from_numpy(value).to(getattr(torch, dtype))
    tout = tmsda.multi_scale_deformable_attention(
        tval, SHAPES, torch.from_numpy(loc), torch.from_numpy(w)).numpy()
    assert tout.shape == jout.shape == (2, 60, 16)
    if dtype == "float32":
        np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=0)
        return
    # per-output bound: sum over the terms of |coeff * v|
    bound = tmsda.multi_scale_deformable_attention(
        tval.float().abs(), SHAPES, torch.from_numpy(loc),
        torch.from_numpy(w)).numpy()        # weights and taps are >= 0
    assert np.all(np.abs(tout - jout) <= 2 ** -7 * bound + 1e-5)



@pytest.mark.parametrize("k", [2, 8])
def test_msda_matches_jax_with_other_point_counts(k):
    value, loc, w = _msda_inputs(3 + k, k)
    jout = np.asarray(jmsda.multi_scale_deformable_attention(
        jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(w)))
    tout = tmsda.multi_scale_deformable_attention(
        torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
        torch.from_numpy(w)).numpy()
    assert tout.shape == jout.shape == (2, 60, 16)
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=0)
    lin, coeff = tmsda._level_rows(torch.from_numpy(loc[0, :, :, 0]),
                                   torch.from_numpy(w[0, :, :, 0]), *SHAPES[0])
    assert lin.shape == coeff.shape == (60, 2, 4 * k)
