"""instance_based_loc_tpu_torch: the PyTorch/CUDA port of instance_based_loc_tpu.

The JAX package beside this one is the reference; this package keeps its
layout (`ops/`, `memory/`, `models/`, `data/`) so each module's counterpart is
easy to find. Plain tensor code is PyTorch; each kernel the JAX package wrote
in Pallas for the TPU is a hand-written CUDA kernel under `csrc/`, built with
`nvcc` at first use.

Geometry and registration are metric-bearing, so fp32 stays full fp32: TF32 is
switched off for matmuls and for cuDNN (which would otherwise run the ViT patch
embedding convolution in TF32). This mirrors the reference's
`jax_default_matmul_precision = "highest"` pin.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Entry points default to the card;
    without one they raise instead of carrying on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
