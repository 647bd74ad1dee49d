"""SAM global-block attention with decomposed relative-position bias: the
CUDA kernel's wrapper and its plain version.

Counterpart of `instance_based_loc_tpu/ops/pallas/sam_attention.py`
(`sam_flash_attention`, kernel `_sam_attn_kernel`). The kernel is
`csrc/sam_attention.cu`; its source notes its bound and design.

`sam_attention` takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises. `launches` counts the kernel's
launches, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

SOURCE = "sam_attention.cu"
HEAD_SIZES = (64, 80)            # SAM-B/L and SAM-H
# an H100's per-block dynamic shared memory limit (227 KB)
MAX_SHARED_BYTES = 232_448

launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        lib.sam_attention_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.sam_attention_launch.restype = ctypes.c_int
        lib.sam_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.sam_attention_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _smem_bytes(d: int, hk: int, wk: int) -> int:
    return _library().sam_attention_smem_bytes(d, hk, wk)


def sam_attention_reference(q, k, v, bias_h, bias_w):
    """Plain PyTorch version in fp32, materialising the (S, S) scores and
    bias (what the kernel avoids).

    q, k, v (B, H, S, D); bias_h (B, H, S, HK), bias_w (B, H, S, WK) with
    S = HK * WK. Returns (B, H, S, D) in q's type."""
    b, h, s, d = q.shape
    scale = 1.0 / d ** 0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    bias = bias_h.float()[..., :, None] + bias_w.float()[..., None, :]
    scores = scores + bias.reshape(b, h, s, s)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def sam_attention(q, k, v, bias_h, bias_w):
    """softmax(q kᵀ / √D + bias_h[..., key // WK] + bias_w[..., key % WK]) v.

    q, k, v (B, H, S, D); bias_h (B, H, S, HK), bias_w (B, H, S, WK);
    S = HK * WK. On the card: bf16 products with fp32 accumulation, fp32
    softmax, output in q's type (fp32 q, k, v are rounded to bf16 for the
    products, as the TPU kernel's DEFAULT-precision dots do)."""
    global launches
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, S, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    hk, wk = bias_h.shape[-1], bias_w.shape[-1]
    if (bias_h.shape != (b, h, s, hk) or bias_w.shape != (b, h, s, wk)
            or hk * wk != s):
        raise ValueError(f"bias_h {tuple(bias_h.shape)} and bias_w "
                         f"{tuple(bias_w.shape)} must be (B, H, S, HK) and "
                         f"(B, H, S, WK) with HK * WK = S = {s}")
    tensors = (q, k, v, bias_h, bias_w)
    if len({x.dtype for x in tensors}) != 1:
        raise ValueError("q, k, v and the biases must share one dtype")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("q, k, v and the biases must lie on one device")
    if q.device.type == "cpu":
        return sam_attention_reference(q, k, v, bias_h, bias_w)
    if q.device.type != "cuda":
        raise ValueError(f"no attention path for device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel takes bf16 or fp32; got {q.dtype}")
    if d not in HEAD_SIZES:
        raise ValueError(f"the kernel takes head sizes {HEAD_SIZES}; got {d}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, k, v and the biases must be contiguous")
    if b * h > 65535:
        raise ValueError(f"the kernel takes at most 65535 batch*heads; "
                         f"got {b * h}")
    smem = _smem_bytes(d, hk, wk)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"a {hk}x{wk} grid needs {smem} B of shared memory "
                         f"per block, above the {MAX_SHARED_BYTES} B a "
                         f"block can have")
    is_fp32 = int(q.dtype == torch.float32)
    if is_fp32:   # the products take bf16 operands
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned (TMA)")
    out = torch.empty(q.shape, dtype=bias_h.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library().sam_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(),
            bias_w.data_ptr(), out.data_ptr(), b * h, s, d, hk, wk,
            1.0 / d ** 0.5, is_fp32, stream)
    if err != 0:
        raise RuntimeError(f"sam_attention kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return out
