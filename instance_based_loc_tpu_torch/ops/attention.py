"""ViT multi-head attention: the CUDA kernels' wrappers and their plain
versions.

Counterpart of `instance_based_loc_tpu/ops/pallas/attention.py`
(`fused_attention`, kernel `_attn_kernel`). The kernel is
`csrc/vit_attention.cu`; its source notes its bound and design.

`vit_attention` takes the kernel's plain PyTorch version only for tensors on
the CPU. For a CUDA tensor it launches the kernel or raises. `launches`
counts the kernel's launches, so a run can show that its path went through
the kernel.

Training differentiates through it: when an input requires a gradient,
`vit_attention` runs as `VitAttentionFunction`, whose forward is the same
call (the kernel on the card) and whose backward is `_attention_backward`:
on the card a kernel of `csrc/vit_attention_backward.cu` that
`backward_kernel` picks (the fused one-pass kernel for bf16 heads of at
most `FUSED_MAX_S` rows, else two passes: dq with each row's log-sum-exp
and D, then dk and dv), on the CPU `vit_attention_backward`, the plain
version, which recomputes P = softmax(q kᵀ / √D) in fp32 from the saved q,
k and v. `backward_launches` counts the backward kernels' launches (one
per fused call, one per pass), `fused_backward_launches` the fused
kernel's alone.
The JAX package has no backward kernel: its DATOR towers compute attention
as einsums and XLA differentiates them, so this backward is the
counterpart of that autodiff, not of a TPU kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

SOURCE = "vit_attention.cu"
BACKWARD_SOURCE = "vit_attention_backward.cu"
# an H100's per-block dynamic shared memory limit (227 KB)
MAX_SHARED_BYTES = 232_448
# the longest head the fused backward kernel takes (S_max; the source's
# kFusedMaxS): a 64-row tile's whole S row (144 keys) fits a warpgroup's
# registers, and a head's operands with P's staging fit shared memory
FUSED_MAX_S = 144

launches = 0
backward_launches = 0
fused_backward_launches = 0

_lib = None
_backward_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        lib.vit_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.vit_attention_launch.restype = ctypes.c_int
        lib.vit_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.vit_attention_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _backward_library():
    global _backward_lib
    if _backward_lib is None:
        lib = cuda_build.load(BACKWARD_SOURCE)
        # q, k, v, g, dq, lse, delta / q, k, v, g, lse, delta, dk, dv
        lib.vit_attention_backward_dq_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.vit_attention_backward_dkdv_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.vit_attention_backward_dq_launch.restype = ctypes.c_int
        lib.vit_attention_backward_dkdv_launch.restype = ctypes.c_int
        lib.vit_attention_backward_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.vit_attention_backward_smem_bytes.restype = ctypes.c_size_t
        # q, k, v, g, dq, dk, dv
        lib.vit_attention_backward_fused_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_void_p])
        lib.vit_attention_backward_fused_launch.restype = ctypes.c_int
        lib.vit_attention_backward_fused_smem_bytes.argtypes = [ctypes.c_int]
        lib.vit_attention_backward_fused_smem_bytes.restype = ctypes.c_size_t
        lib.vit_attention_backward_fused_max_s.restype = ctypes.c_int
        if lib.vit_attention_backward_fused_max_s() != FUSED_MAX_S:
            raise RuntimeError("the fused backward kernel's S_max differs "
                               "from FUSED_MAX_S")
        _backward_lib = lib
    return _backward_lib


@functools.lru_cache(maxsize=None)
def _smem_bytes(d: int, valid_len: int, elem_bytes: int) -> int:
    return _library().vit_attention_smem_bytes(d, valid_len, elem_bytes)


@functools.lru_cache(maxsize=None)
def _backward_smem_bytes(d: int, s: int, valid_len: int,
                         elem_bytes: int) -> int:
    return _backward_library().vit_attention_backward_smem_bytes(
        d, s, valid_len, elem_bytes)


@functools.lru_cache(maxsize=None)
def _fused_backward_smem_bytes(s: int) -> int:
    return _backward_library().vit_attention_backward_fused_smem_bytes(s)


def backward_kernel(s: int, d: int, dtype: torch.dtype) -> str:
    """Which backward kernel takes heads of `s` rows and head size `d` in
    `dtype`: "fused" for bf16 with D = 64 and S <= FUSED_MAX_S (one pass
    over each head, a persistent kernel), else "two_pass" (bf16 with D = 64
    at longer S on the tensor cores, fp32 at any D on the CUDA cores).
    `_backward_check` raises for what neither takes."""
    if dtype == torch.bfloat16 and d == 64 and s <= FUSED_MAX_S:
        return "fused"
    return "two_pass"


def vit_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            valid_len: int | None = None) -> torch.Tensor:
    """Plain PyTorch attention in fp32 (the kernel's plain version).

    q, k, v: (B, H, S, D). Keys at or past `valid_len` are masked. Returns
    (B, H, S, D) in the input type."""
    s, d = q.shape[-2], q.shape[-1]
    scale = 1.0 / d ** 0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if valid_len is not None:
        keep = torch.arange(s, device=q.device) < valid_len
        scores = scores.masked_fill(~keep, -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def vit_attention_backward(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, grad_out: torch.Tensor,
                           valid_len: int | None = None):
    """(dq, dk, dv) of `vit_attention` for the upstream gradient
    `grad_out`, in fp32 from P recomputed in fp32, returned in the input
    type. Keys at or past `valid_len` have P = 0 in every row, so their dk
    and dv are exactly zero."""
    s, d = q.shape[-2], q.shape[-1]
    scale = 1.0 / d ** 0.5
    qf, kf, vf, go = q.float(), k.float(), v.float(), grad_out.float()
    scores = torch.einsum("bhqd,bhkd->bhqk", qf * scale, kf)
    if valid_len is not None:
        keep = torch.arange(s, device=q.device) < valid_len
        scores = scores.masked_fill(~keep, -1e30)
    p = torch.softmax(scores, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, go)
    dp = torch.einsum("bhqd,bhkd->bhqk", go, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class VitAttentionFunction(torch.autograd.Function):
    """`vit_attention` with a gradient: the forward is the kernel on the
    card (the plain version on the CPU), the backward `_attention_backward`
    (the backward kernel on the card, `vit_attention_backward` on the
    CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, valid_len):
        ctx.save_for_backward(q, k, v)
        ctx.valid_len = valid_len
        return _attention(q, k, v, valid_len)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _attention_backward(q, k, v, grad_out, ctx.valid_len)
        return dq, dk, dv, None


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid_len: int | None = None) -> torch.Tensor:
    """softmax(q kᵀ / √D, keys < valid_len) v for q, k, v of shape
    (B, H, S, D); fp32 scores and sums, output in the input type.
    Differentiable: with an input that requires a gradient (and gradients
    on) it runs as `VitAttentionFunction`.

    Query rows at or past `valid_len` give rows the caller discards."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return VitAttentionFunction.apply(q, k, v, valid_len)
    return _attention(q, k, v, valid_len)


def _check(q, k, v, valid_len) -> int:
    """The checks every device shares; returns the valid key count."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, S, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("q, k and v must share one dtype")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must lie on one device")
    s = q.shape[2]
    valid = s if valid_len is None else int(valid_len)
    if not 1 <= valid <= s:
        raise ValueError(f"valid_len must lie in [1, {s}]; got {valid}")
    return valid


def _kernel_check(q, k, v, valid_len, what: str) -> int:
    """The checks of the forward and backward kernels beyond `_check`;
    returns the valid key count."""
    valid = _check(q, k, v, valid_len)
    b, h, s, d = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the {what} kernel takes bf16 or fp32; got "
                         f"{q.dtype}")
    if q.dtype == torch.bfloat16 and d != 64:
        raise ValueError(f"the {what} kernel takes bf16 only with head size "
                         f"64 (the ViT embedders'); got {d}")
    if b * h > 65535:
        raise ValueError(f"the {what} kernel takes at most 65535 "
                         f"batch*heads; got {b * h}")
    if q.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("bf16 q, k and v must be 16-byte aligned (TMA)")
    return valid


def _attention(q, k, v, valid_len):
    """The forward: the plain version for CPU tensors, else the kernel."""
    global launches
    if q.device.type == "cpu":
        _check(q, k, v, valid_len)
        return vit_attention_reference(q, k, v, valid_len)
    valid = _kernel_check(q, k, v, valid_len, "attention")
    b, h, s, d = q.shape
    is_bf16 = int(q.dtype == torch.bfloat16)
    smem = _smem_bytes(d, valid, 2 if is_bf16 else 4)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"K and V of one head need {smem} B of shared "
                         f"memory, above the {MAX_SHARED_BYTES} B a block "
                         f"can have")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library().vit_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, s, d, valid, 1.0 / d ** 0.5, is_bf16, stream)
    if err != 0:
        raise RuntimeError(f"vit_attention kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return out


def _backward_check(q, k, v, grad_out, valid_len) -> int:
    """Every check of the backward kernel, in the order the CPU tests hold
    it to (those that need no card first, the shared-memory limit last);
    returns the valid key count."""
    if grad_out.shape != q.shape:
        raise ValueError(f"grad_out must have q's shape {tuple(q.shape)}; "
                         f"got {tuple(grad_out.shape)}")
    if grad_out.dtype != q.dtype:
        raise ValueError(f"grad_out must have q's dtype {q.dtype}; got "
                         f"{grad_out.dtype}")
    if grad_out.device != q.device:
        raise ValueError("grad_out must lie on q's device")
    valid = _kernel_check(q, k, v, valid_len, "attention backward")
    b, h, s, d = q.shape
    if backward_kernel(s, d, q.dtype) == "fused":
        smem = _fused_backward_smem_bytes(s)
    else:
        smem = _backward_smem_bytes(d, s, valid, q.element_size())
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"a head of the backward needs {smem} B of shared "
                         f"memory, above the {MAX_SHARED_BYTES} B a block "
                         f"can have")
    return valid


def _attention_backward(q, k, v, grad_out, valid_len, kernel=None):
    """`VitAttentionFunction`'s backward: the plain version for CPU tensors,
    else the kernel `backward_kernel` picks: for bf16 heads of D = 64 and
    S <= FUSED_MAX_S (the DATOR towers' 129, CLIP-B/32's 50) the fused
    kernel, one launch; for longer bf16 heads (DINOv2's 257) and fp32 the
    two passes, two launches. (dq, dk, dv) in the input type.

    `kernel` ("fused" or "two_pass") overrides the rule, so that timings
    and tests can hold the two designs against each other at one shape;
    "fused" raises for a head the fused kernel does not take."""
    global backward_launches, fused_backward_launches
    if q.device.type == "cpu" and grad_out.device.type == "cpu":
        return vit_attention_backward(q, k, v, grad_out, valid_len)
    if kernel not in (None, "fused", "two_pass"):
        raise ValueError(f"unknown backward kernel {kernel!r}")
    valid = _backward_check(q, k, v, grad_out, valid_len)
    b, h, s, d = q.shape
    rule = backward_kernel(s, d, q.dtype)
    if kernel == "fused" and rule != "fused":
        raise ValueError(f"the fused backward kernel takes bf16 heads of D "
                         f"= 64 and S <= {FUSED_MAX_S}; got {q.dtype}, D = "
                         f"{d}, S = {s}")
    if kernel == "two_pass" and rule == "fused":
        smem = _backward_smem_bytes(d, s, valid, q.element_size())
        if smem > MAX_SHARED_BYTES:
            raise ValueError(f"the two passes need {smem} B of shared "
                             f"memory at S = {s}")
    kernel = kernel or rule
    # autograd hands the towers' gradient over as a strided view
    g = grad_out.contiguous()
    if g.data_ptr() % 16:        # TMA reads 16-byte aligned rows
        g = g.clone()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    scale = 1.0 / d ** 0.5
    lib = _backward_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kernel == "fused":
            err = lib.vit_attention_backward_fused_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, s, valid,
                scale, stream)
            if err != 0:
                raise RuntimeError(f"vit_attention backward (fused) launch "
                                   f"failed with CUDA error {err}")
            backward_launches += 1
            fused_backward_launches += 1
            return dq, dk, dv
        stats = torch.empty((2, b * h * s), dtype=torch.float32,
                            device=q.device)
        lse, delta = stats[0], stats[1]
        args = (b * h, s, d, valid, scale, int(q.dtype == torch.bfloat16))
        err = lib.vit_attention_backward_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), lse.data_ptr(), delta.data_ptr(), *args, stream)
        if err != 0:
            raise RuntimeError(f"vit_attention backward (dq pass) launch "
                               f"failed with CUDA error {err}")
        backward_launches += 1
        err = lib.vit_attention_backward_dkdv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *args, stream)
        if err != 0:
            raise RuntimeError(f"vit_attention backward (dk/dv pass) launch "
                               f"failed with CUDA error {err}")
        backward_launches += 1
    return dq, dk, dv
