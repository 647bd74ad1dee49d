"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip without a card. This file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch; there, skip the JAX-importing conftest:

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu --noconftest

Tolerances, ViT attention: fp32 atol 1e-5 (the same fp32 maths summed in
another order). bf16 |diff| <= 1e-4 + 2^-7 |ref|: the kernel keeps P to about
16 bits and both sides round an fp32 result to bf16, so they differ by at most
one bf16 step (2^-8 to 2^-7 of the value) where the fp32 results straddle a
rounding boundary. With q, k, v ~ N(0, 1) the outputs are about 0.1 in size
and reach about 1.

SAM attention: |diff| <= 2e-3 + 2^-7 |ref|, the TPU kernel's own figure
against fp32 attention (P is rounded to bf16 for P.V, as on the TPU) plus one
bf16 step of the output. fp32 inputs are rounded to bf16 for the products, so
they are held against the plain version on the same bf16-rounded q, k, v.

MSDA gather: atol 1e-5 (16 fp32 products of the same values summed in
another order; outputs are a few units in size).
"""

import pytest
import torch

from instance_based_loc_tpu_torch.ops import attention, msda_gather
from instance_based_loc_tpu_torch.ops import sam_attention as sam_attn

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


SAM_TOL = (2e-3, 2 ** -7)


def _sam_inputs(b, h, hk, wk, d, dtype, gen):
    s = hk * wk
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
               for _ in range(3))
    bias_h = 0.3 * torch.randn((b, h, s, hk), generator=gen, device="cuda")
    bias_w = 0.3 * torch.randn((b, h, s, wk), generator=gen, device="cuda")
    return [x.to(dtype) for x in (q, k, v, bias_h, bias_w)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hk,wk,d,dtype", [
    (1, 2, 16, 16, 64, torch.bfloat16),
    (1, 2, 48, 64, 80, torch.bfloat16),     # a 768 px canvas' grid shape
    (2, 3, 20, 13, 80, torch.bfloat16),     # tail rows and keys, odd WK
    (1, 2, 16, 16, 64, torch.float32),
    (1, 1, 13, 20, 80, torch.float32),
])
def test_sam_attention_kernel_matches_plain_version(b, h, hk, wk, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, bias_h, bias_w = _sam_inputs(b, h, hk, wk, d, dtype, gen)
    before = sam_attn.launches
    out = sam_attn.sam_attention(q, k, v, bias_h, bias_w)
    torch.cuda.synchronize()
    assert sam_attn.launches == before + 1
    assert out.dtype == dtype
    # the products take bf16 operands: hold fp32 inputs against the plain
    # version on the same rounded operands
    q, k, v = (x.to(torch.bfloat16).float() if dtype == torch.float32 else x
               for x in (q, k, v))
    ref = sam_attn.sam_attention_reference(q, k, v, bias_h, bias_w)
    torch.testing.assert_close(out.float(), ref.float(), atol=SAM_TOL[0],
                               rtol=SAM_TOL[1])


@pytest.mark.gpu
def test_sam_attention_kernel_rejects_other_head_sizes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, bias_h, bias_w = _sam_inputs(1, 2, 8, 8, 32, torch.bfloat16, gen)
    before = sam_attn.launches
    with pytest.raises(ValueError):
        sam_attn.sam_attention(q, k, v, bias_h, bias_w)
    assert sam_attn.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,d,q,dtype", [
    (10000, 8, 32, 900, torch.bfloat16),    # GroundingDINO@800 level 0
    (10000, 8, 32, 300, torch.float32),
    (4225, 2, 16, 77, torch.bfloat16),
])
def test_msda_gather_kernel_matches_plain_version(s, h, d, q, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    vmap = torch.randn((s, h, d), generator=gen, device="cuda").to(dtype)
    lin = torch.randint(0, s, (q, h, 16), generator=gen, device="cuda",
                        dtype=torch.int32)
    coeff = torch.rand((q, h, 16), generator=gen, device="cuda")
    coeff[:, :, ::5] = 0.0                  # out-of-range taps weigh 0
    before = msda_gather.launches
    out = msda_gather.msda_level_gather(vmap, lin, coeff)
    torch.cuda.synchronize()
    assert msda_gather.launches == before + 1
    ref = msda_gather.msda_level_gather_reference(vmap, lin, coeff)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
