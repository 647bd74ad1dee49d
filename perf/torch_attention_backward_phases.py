"""Where the fused attention backward kernel spends a head, on the card.

Builds a copy of `csrc/vit_attention_backward.cu` with a `clock64()` stamp
at each phase boundary of `vit_attention_bwd_fused_wgmma` (the copy and
its library go to the package's `_build/`; the source is not changed),
runs it at the DATOR training shape (128 x 12 heads, S = 129, D = 64,
bf16), and prints one JSON line: for each warpgroup of block 0, the mean
SM cycles of each phase over heads 1-10 of the block (head 0 waits for
its first loads), and of a whole head; beside it the kernel's device time
(torch.profiler, from the package's own build) and the card's name and
power limit. The stamps cost a few registers; the kernel's time comes
from the unstamped build.

    python perf/torch_attention_backward_phases.py
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import device_ms, gpu_name_and_power_limit  # noqa: E402
from instance_based_loc_tpu_torch.ops import attention, cuda_build  # noqa: E402

HEADS, PHASES = 16, 13
STAMPS = r'''
__device__ unsigned long long g_stamps[16][3][16];
#define STAMP(k) do { if (blockIdx.x == 0 && threadIdx.x % 128 == 0 && \
    it < 16) g_stamps[it][wg][k] = clock64(); } while (0)
extern "C" int read_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));
}
'''
# (text in the kernel, stamp placed before it) -> the phase that ends there
MARKS = [
    ("    for (int n = n0; n < n0 + 4; ++n)\n      mbar_wait(", "start"),
    ("    const size_t hb = (size_t)head * s * kD;", "loads waited for"),
    ("      if (real_rows) {\n        // each row's kPad keys", "S = q K^T"),
    ("    __syncthreads();   // (0)", "softmax"),
    ("    // ---- P into the staging arrays", "barrier 0, next loads"),
    ("    __syncthreads();   // (1) P staged", "P staged, D (dP sweep)"),
    ("    // ---- dv of this warpgroup's keys", "barrier 1"),
    ("    __syncthreads();   // (2) P read", "dv"),
    ("    // ---- dS = P (dP - D) in place of P", "barrier 2"),
    ("    __syncthreads();   // (3) dS staged", "dS in place (dP again)"),
    ("    // ---- dq of the row tile", "barrier 3, next V"),
    ("    const uint32_t hi_at = stage + job", "dq"),
]
END = "dk"


def stamped_source() -> str:
    with open(os.path.join(cuda_build.CSRC_DIR,
                           attention.BACKWARD_SOURCE)) as f:
        src = f.read()
    src = src.replace('#include "hopper_attention.cuh"\n',
                      '#include "hopper_attention.cuh"\n' + STAMPS, 1)
    for k, (text, _) in enumerate(MARKS):
        if src.count(text) != 1:
            raise RuntimeError(f"the kernel no longer has the phase mark "
                               f"{text.strip()!r}")
        src = src.replace(text, f"    STAMP({k});\n" + text)
    # the last stamp closes the head, at the end of the head loop
    tail = "\n  }\n}\n\ntemplate <int NF, int NS>\ncudaError_t launch_fused("
    if src.count(tail) != 1:
        raise RuntimeError("the kernel's head loop no longer ends as expected")
    return src.replace(tail, f"\n    STAMP({len(MARKS)});" + tail)


def main():
    path = os.path.join(cuda_build.BUILD_DIR, "vit_attention_backward_stamped")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    with open(path + ".cu", "w") as f:
        f.write(stamped_source())
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                    cuda_build.CSRC_DIR, "-o", path + ".so", path + ".cu"],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(path + ".so")
    launch = lib.vit_attention_backward_fused_launch
    launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
    launch.restype = ctypes.c_int
    shape = (128, 12, 129, 64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    outs = [torch.empty_like(q) for _ in range(3)]
    for _ in range(3):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                     *(o.data_ptr() for o in outs), 128 * 12, 129, 129,
                     0.125, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the stamped kernel failed with CUDA error "
                               f"{err}")
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (HEADS * 3 * 16))()
    if lib.read_stamps(buf):
        raise RuntimeError("reading the stamps failed")
    t = np.frombuffer(buf, dtype=np.uint64).reshape(HEADS, 3, 16)
    t = t.astype(np.int64)[:, :, :PHASES]
    names = [name for _, name in MARKS[1:]] + [END]
    result = {"card": gpu_name_and_power_limit(), "shape": list(shape),
              "fused_ms": device_ms(
                  lambda: attention._attention_backward(q, k, v, g, None),
                  "vit_attention_bwd_fused"),
              "cycles": {}}
    for w in range(3):
        phases = np.diff(t[1:11, w], axis=1).mean(axis=0)
        result["cycles"][f"warpgroup {w}"] = {
            **{n: float(c) for n, c in zip(names, phases)},
            "head": float(np.diff(t[1:12, w, 0]).mean())}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
