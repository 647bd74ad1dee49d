"""Ablations of an attention kernel on the card: builds copies of
`csrc/<kernel>.cu` with text substitutions, checks each copy against the
kernel's plain PyTorch version, and prints its device time (torch.profiler,
`chip_smoke.device_ms`) at the main path's shapes.

A variant that removes work (a product, the exponentials) gives wrong
numbers on purpose: its line says WRONG and its time says what that work
costs. Variants are a JSON object {name: [[old, new], ...]}; every `old`
must occur in the source. Each variant runs in a process of its own with a
time limit, so one that hangs costs only its limit.

    python perf/torch_kernel_variants.py vit_attention \
        '{"base": [], "no_pv": [["<text of the P.V product>", ""]]}'
"""

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = {   # (shape, valid_len) for the ViT kernel; (b, h, hk, wk, d) for SAM
    "vit_attention": [((16, 12, 257, 64), 257), ((16, 12, 256, 64), 256),
                      ((16, 12, 257, 64), 64), ((16, 12, 128, 64), 128)],
    "sam_attention": [(1, 16, 64, 64, 80), (1, 12, 64, 64, 64),
                      (1, 16, 48, 48, 80)],
}


def build(kernel, variants, out_dir):
    from instance_based_loc_tpu_torch.ops import cuda_build
    src = open(os.path.join(cuda_build.CSRC_DIR, kernel + ".cu")).read()
    procs = {}
    for name, subs in variants.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        text = src
        for old, new in subs:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        with open(os.path.join(d, kernel + ".cu"), "w") as f:
            f.write(text)
        for header in os.listdir(cuda_build.CSRC_DIR):
            if header.endswith(".cuh"):
                with open(os.path.join(cuda_build.CSRC_DIR, header)) as f, \
                        open(os.path.join(d, header), "w") as g:
                    g.write(f.read())
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
               os.path.join(d, "lib.so"), os.path.join(d, kernel + ".cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill stores" in line
                         and not line.strip().startswith("0 bytes")})
        print(f"{name}: nvcc exit {proc.returncode}; spills: "
              f"{spills or 'none'}", flush=True)


def run(kernel, name, out_dir):
    import torch
    from chip_smoke import device_ms
    from instance_based_loc_tpu_torch.ops import attention
    from instance_based_loc_tpu_torch.ops import sam_attention as sa
    lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).to(
            torch.bfloat16)

    for shape in SHAPES[kernel]:
        if kernel == "vit_attention":
            (b, h, s, d), valid = shape
            q, k, v = (randn((b, h, s, d)) for _ in range(3))
            lib.vit_attention_launch.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

            def call():
                out = torch.empty_like(q)
                assert lib.vit_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b * h, s, d, valid, d ** -0.5, 1, stream) == 0
                return out
            ref = attention.vit_attention_reference(q, k, v, valid)
            rows, tol = valid, (1e-4, 2 ** -7)
        else:
            b, h, hk, wk, d = shape
            s = hk * wk
            q, k, v = (randn((b, h, s, d)) for _ in range(3))
            bias_h, bias_w = randn((b, h, s, hk), 0.3), randn((b, h, s, wk), 0.3)
            lib.sam_attention_launch.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

            def call():
                out = torch.empty_like(q)
                assert lib.sam_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    bias_h.data_ptr(), bias_w.data_ptr(), out.data_ptr(),
                    b * h, s, d, hk, wk, d ** -0.5, 0, stream) == 0
                return out
            ref = sa.sam_attention_reference(q, k, v, bias_h, bias_w)
            rows, tol = s, (2e-3, 2 ** -7)
        out = call().float()[:, :, :rows]
        torch.cuda.synchronize()
        ref = ref.float()[:, :, :rows]
        wrong = bool(((out - ref).abs() - tol[0] - tol[1] * ref.abs()).max() > 0)
        print(f"{kernel} {name} {shape}: {device_ms(call, kernel):.4f} ms on "
              f"the device{' WRONG' if wrong else ''}", flush=True)


def main():
    kernel, variants = sys.argv[1], json.loads(sys.argv[2])
    out_dir = os.path.join(REPO, "instance_based_loc_tpu_torch", "_build",
                           "variants", kernel)
    if len(sys.argv) > 3:            # one variant, in its own process
        run(kernel, sys.argv[3], out_dir)
        return
    build(kernel, variants, out_dir)
    for name in variants:
        try:
            subprocess.run([sys.executable, __file__, kernel, sys.argv[2],
                            name], timeout=120, check=True)
        except (subprocess.TimeoutExpired, subprocess.CalledProcessError) as e:
            print(f"{kernel} {name}: failed ({e})", flush=True)


if __name__ == "__main__":
    main()
