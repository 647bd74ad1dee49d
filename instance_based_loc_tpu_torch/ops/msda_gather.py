"""One MSDA level's sample-and-reduce: the CUDA kernel's wrapper and its
plain version.

Counterpart of `instance_based_loc_tpu/ops/pallas/msda_gather.py`
(`msda_level_gather_pallas`, kernel `_kernel`), whose contract is
`instance_based_loc_tpu/ops/msda.py:_level_gather`'s. The kernel is
`csrc/msda_gather.cu`; its source notes its bound and design. It keeps the
model's (S, H, D) value layout, not the Pallas kernel's head-major copy.

`msda_level_gather` takes the plain version only for tensors on the CPU. For
a CUDA tensor it launches the kernel or raises. `launches` counts the
kernel's launches, and `launches_by_taps` the same launches by tap count.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import cuda_build

SOURCE = "msda_gather.cu"
# the tap counts T = 4K the kernel is built for: K = 1..8 sampling points
KERNEL_TAPS = tuple(range(4, 33, 4))

launches = 0
launches_by_taps: collections.Counter = collections.Counter()

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        lib.msda_gather_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.msda_gather_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def msda_level_gather_reference(vmap_l, lin, coeff):
    """Plain PyTorch version: vmap_l (S, H, D) any float type, lin (Q, H, T)
    integer rows (clamped to [0, S)), coeff (Q, H, T) fp32 ->
    (Q, H, D) fp32 = sum_t coeff[q, h, t] * float(vmap_l[lin[q, h, t], h])."""
    s, h, _ = vmap_l.shape
    rows = lin.long().clamp(0, s - 1)
    heads = torch.arange(h, device=vmap_l.device)[None, :, None]
    gathered = vmap_l[rows, heads].float()                  # (Q, H, T, D)
    return (gathered * coeff.float()[..., None]).sum(dim=2)


def msda_level_gather(vmap_l, lin, coeff):
    """sum over T taps of coeff * float(vmap_l[lin, head]).

    vmap_l (S, H, D) bf16 or fp32; lin (Q, H, T) int32; coeff (Q, H, T)
    fp32, T = 4K for K sampling points (the kernel takes K = 1..8; the
    plain version any T). Returns (Q, H, D) fp32."""
    global launches
    if vmap_l.dim() != 3:
        raise ValueError(f"vmap_l must be (S, H, D); got {tuple(vmap_l.shape)}")
    s, h, d = vmap_l.shape
    q = lin.shape[0]
    taps = lin.shape[-1] if lin.dim() == 3 else -1
    if lin.shape != (q, h, taps) or coeff.shape != (q, h, taps):
        raise ValueError(f"lin {tuple(lin.shape)} and coeff "
                         f"{tuple(coeff.shape)} must be (Q, {h}, T)")
    if not vmap_l.device == lin.device == coeff.device:
        raise ValueError("vmap_l, lin and coeff must lie on one device")
    if vmap_l.device.type == "cpu":
        return msda_level_gather_reference(vmap_l, lin, coeff)
    if vmap_l.device.type != "cuda":
        raise ValueError(f"no gather path for device {vmap_l.device}")
    if vmap_l.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel takes bf16 or fp32 values; got "
                         f"{vmap_l.dtype}")
    if lin.dtype != torch.int32 or coeff.dtype != torch.float32:
        raise ValueError(f"the kernel takes int32 lin and fp32 coeff; got "
                         f"{lin.dtype}, {coeff.dtype}")
    if d % 8:
        raise ValueError(f"the kernel takes a head size that is a multiple "
                         f"of 8; got {d}")
    if taps not in KERNEL_TAPS:
        raise ValueError(f"the kernel takes T = 4K taps for K = 1..8 "
                         f"sampling points; got T = {taps}")
    if not (vmap_l.is_contiguous() and lin.is_contiguous()
            and coeff.is_contiguous()):
        raise ValueError("vmap_l, lin and coeff must be contiguous")
    lib = _library()
    out = torch.empty((q, h, d), dtype=torch.float32, device=vmap_l.device)
    with torch.cuda.device(vmap_l.device):
        stream = torch.cuda.current_stream(vmap_l.device).cuda_stream
        err = lib.msda_gather_launch(
            vmap_l.data_ptr(), lin.data_ptr(), coeff.data_ptr(),
            out.data_ptr(), s, h, d, q, taps,
            int(vmap_l.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"msda_gather kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    launches_by_taps[taps] += 1
    return out
