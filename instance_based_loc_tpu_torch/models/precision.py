"""Inference compute-precision policy for the perception models (counterpart
of `instance_based_loc_tpu/models/precision.py`).

The cascade's models (GroundingDINO, SAM) run bf16 inference by default:
weights are cast once with `module.to(dtype)`, the input image follows, and
outputs are cast back to fp32 before any thresholding. Override per process
with IBL_MODEL_DTYPE=float32 (or per builder with `compute_dtype`).
"""

from __future__ import annotations

import os

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "f32": torch.float32,
}


def resolve_compute_dtype(compute_dtype=None) -> torch.dtype:
    """Explicit argument > IBL_MODEL_DTYPE env > bfloat16 default."""
    if compute_dtype is not None:
        if isinstance(compute_dtype, str):
            return _DTYPES[compute_dtype]
        return compute_dtype
    return _DTYPES[os.environ.get("IBL_MODEL_DTYPE", "bfloat16")]
