"""The port's ViT attention (instance_based_loc_tpu_torch/ops/attention.py)
against the JAX package's: its plain version against `reference_attention`
and the Pallas kernel in interpret mode. The CUDA kernel itself is held to
the plain version on the card in test_torch_cuda_kernels.py.

Tolerances: fp32 atol 1e-5 (the same fp32 maths summed in another order).
bf16 |diff| <= 1e-4 + 2^-7 |ref|: both sides compute in fp32 and round the
output to bf16, so they differ by at most one bf16 step (2^-8 to 2^-7 of the
value) where the fp32 results straddle a rounding boundary. With q, k, v ~
N(0, 1) the outputs are about 0.1 in size and reach about 1.2."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from instance_based_loc_tpu.ops.pallas.attention import (
    fused_attention, reference_attention)
from instance_based_loc_tpu_torch.ops import attention

SHAPE = (2, 3, 128, 32)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype,atol,rtol", [("float32", 1e-5, 0.0),
                                             ("bfloat16", 1e-4, 2 ** -7)])
@pytest.mark.parametrize("valid_len", [None, 77])
@pytest.mark.parametrize("jax_fn", ["reference", "pallas_interpret"])
def test_plain_attention_matches_jax(dtype, atol, rtol, valid_len, jax_fn):
    q, k, v = _inputs(SHAPE)
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    jlen = None if valid_len is None else jnp.int32(valid_len)
    if jax_fn == "reference":
        ref = reference_attention(jq, jk, jv, valid_len=jlen)
    else:
        ref = fused_attention(jq, jk, jv, valid_len=jlen, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    out = attention.vit_attention(tq, tk, tv, valid_len=valid_len)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    rows = SHAPE[2] if valid_len is None else valid_len  # padded query rows
    np.testing.assert_allclose(                          # are unspecified
        out.float().numpy()[:, :, :rows],
        np.asarray(ref.astype(jnp.float32))[:, :, :rows], atol=atol,
        rtol=rtol)


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 2, 16, 8)))
    before = attention.launches
    out = attention.vit_attention(q, k, v, valid_len=9)
    assert attention.launches == before     # no kernel launch on the CPU
    torch.testing.assert_close(
        out, attention.vit_attention_reference(q, k, v, valid_len=9),
        atol=0, rtol=0)


@pytest.mark.parametrize("case", ["shape_mismatch", "three_dims",
                                  "valid_len_zero", "valid_len_past_s",
                                  "dtype_mismatch"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 2, 16, 8)))
    valid = None
    if case == "shape_mismatch":
        k = k[:, :, :8]
    elif case == "three_dims":
        q, k, v = q[0], k[0], v[0]
    elif case == "valid_len_zero":
        valid = 0
    elif case == "valid_len_past_s":
        valid = 17
    elif case == "dtype_mismatch":
        v = v.double()
    with pytest.raises(ValueError):
        attention.vit_attention(q, k, v, valid_len=valid)
