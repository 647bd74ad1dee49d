"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip without a card. This file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch; there, skip the JAX-importing conftest:

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu --noconftest

Tolerances: fp32 atol 1e-5 (the same fp32 maths summed in another order).
bf16 |diff| <= 1e-4 + 2^-7 |ref|: the kernel keeps P to about 16 bits and
both sides round an fp32 result to bf16, so they differ by at most one bf16
step (2^-8 to 2^-7 of the value) where the fp32 results straddle a rounding
boundary. With q, k, v ~ N(0, 1) the outputs are about 0.1 in size and reach
about 1.
"""

import pytest
import torch

from instance_based_loc_tpu_torch.ops import attention

BF16_TOL = (1e-4, 2 ** -7)     # atol, rtol
FP32_TOL = (1e-5, 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,valid_len,tol", [
    # bf16 (D = 64 only): the tensor-core kernel (the ViT embedders' shape)
    ((16, 12, 257, 64), torch.bfloat16, None, BF16_TOL),
    ((16, 12, 257, 64), torch.bfloat16, 200, BF16_TOL),
    ((1, 2, 300, 64), torch.bfloat16, 130, BF16_TOL),
    # fp32: the CUDA-core kernel
    ((2, 3, 70, 32), torch.float32, None, FP32_TOL),
    ((2, 3, 70, 32), torch.float32, 33, FP32_TOL),
    ((1, 2, 257, 64), torch.float32, 100, FP32_TOL),
])
def test_cuda_kernel_matches_plain_version(shape, dtype, valid_len, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    before = attention.launches
    out = attention.vit_attention(q, k, v, valid_len=valid_len)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    ref = attention.vit_attention_reference(q, k, v, valid_len=valid_len)
    rows = shape[2] if valid_len is None else valid_len
    torch.testing.assert_close(out.float()[:, :, :rows],
                               ref.float()[:, :, :rows], atol=tol[0],
                               rtol=tol[1])


@pytest.mark.gpu
def test_cuda_kernel_rejects_bf16_with_other_head_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q = torch.zeros((1, 2, 16, 32), dtype=torch.bfloat16, device="cuda")
    before = attention.launches
    with pytest.raises(ValueError):
        attention.vit_attention(q, q, q)
    assert attention.launches == before
