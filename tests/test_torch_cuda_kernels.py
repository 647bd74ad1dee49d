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
and reach about 1. The bf16 cases cover the TMA + wgmma kernel's edges: one
64-row tile, a remainder of query rows short enough for the producer warp
(S = 65, 72) and one that takes a tile (S = 300), a last key chunk of at most
16 keys (valid_len 1, 65, 70, 130, 200, 257) and a full one (64), and 384
batch*heads. SAM cases cover both head sizes at SAM's 64x64 grid, the
general bias path (WK != 64), WK = 64 with an odd HK (the last 128-key tile
half past the grid) and S not a multiple of 128, and fp32 in and out. Every
case checks that the launch count moved by one.

SAM attention: |diff| <= 2e-3 + 2^-7 |ref|, the TPU kernel's own figure
against fp32 attention (P is rounded to bf16 for P.V, as on the TPU) plus one
bf16 step of the output. fp32 inputs are rounded to bf16 for the products, so
they are held against the plain version on the same bf16-rounded q, k, v.

MSDA gather: atol 1e-5 (T fp32 products of the same values summed in
another order; outputs are a few units in size), at T = 16 (K = 4 sampling
points) and at every other tap count the kernel is built for (T = 4K,
K = 1..8); other tap counts raise before a launch.

The ViT attention's gradient (`VitAttentionFunction`: the kernel forward,
then the backward kernel `attention.backward_kernel` picks: the fused
one-pass kernel for bf16 heads of S <= S_max = 144, else the two passes):
dq, dk, dv against autograd of the plain version, bf16 |diff| <= 2e-3 +
2^-7 |ref| (the kernels keep P and dS to ~16 bits as a bf16 high part and
remainder, and both sides round fp32 gradients to bf16), fp32 1e-5; at
the training shape, the embedders' S = 257 and S = 50, masked tails (keys
past valid_len get exactly zero dk and dv), short last chunks, a head
shorter than a tile (S = 5), a strided upstream gradient, the fused
kernel's edges (S = 128, 129, 144 = S_max, and 145, which the two passes
take) and head counts that leave its persistent blocks a partial last
wave (1, 21 and 1536 heads), each with one launch of the fused kernel or
one of each pass; two runs of each give bitwise-equal gradients (no
atomics); one DATOR training step on the card (fp32, the kernels' fp32
paths, hidden 64) launches the forward kernel and the backward's two
passes once per tower block and gives the CPU step's loss within 1e-4
relative.

The query program's CUDA-graph replay (`ops/query_graph.py`): on a small
scene, every `localise_many` result of the replay equals the eager run's
bit for bit for the same seeds, and a configuration that cannot be captured
raises rather than running eager.
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
    # the wgmma kernel's edges: one tile, a one-row remainder (the producer
    # warp's rows), masks inside the first, a full and a short last key
    # chunk, and 384 batch*heads
    ((2, 3, 64, 64), torch.bfloat16, None, BF16_TOL),
    ((2, 3, 65, 64), torch.bfloat16, None, BF16_TOL),
    ((1, 2, 257, 64), torch.bfloat16, 1, BF16_TOL),
    ((1, 2, 257, 64), torch.bfloat16, 64, BF16_TOL),
    ((1, 2, 257, 64), torch.bfloat16, 65, BF16_TOL),
    ((1, 2, 257, 64), torch.bfloat16, 257, BF16_TOL),
    ((1, 2, 72, 64), torch.bfloat16, 70, BF16_TOL),
    ((32, 12, 257, 64), torch.bfloat16, None, BF16_TOL),
    # the DATOR towers' shape (2 towers x 16 crops, 1 + 16 x 8 tokens): one
    # key past two 64-key TMA tiles
    ((32, 12, 129, 64), torch.bfloat16, None, BF16_TOL),
    ((16, 12, 129, 64), torch.bfloat16, None, BF16_TOL),
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
@pytest.mark.parametrize("shape,dtype,valid_len,strided,tol", [
    ((128, 12, 129, 64), torch.bfloat16, None, False, (2e-3, 2 ** -7)),
    ((4, 12, 129, 64), torch.bfloat16, 100, False, (2e-3, 2 ** -7)),
    # the embedders' shapes: DINOv2-base (S = 257, one key and one query
    # row for the producer warp) and CLIP-B/32 (S = 50, one short tile)
    ((16, 12, 257, 64), torch.bfloat16, None, False, (2e-3, 2 ** -7)),
    ((16, 12, 50, 64), torch.bfloat16, None, False, (2e-3, 2 ** -7)),
    # the towers hand the Function a transposed view as its gradient
    ((16, 12, 129, 64), torch.bfloat16, None, True, (2e-3, 2 ** -7)),
    # short last chunks (S = 72: 8 rows; S = 136: 8 rows past two tiles),
    # a tile of its own (S = 100) and a head shorter than a tile (S = 5)
    ((2, 3, 72, 64), torch.bfloat16, 70, False, (2e-3, 2 ** -7)),
    ((2, 3, 100, 64), torch.bfloat16, 30, True, (2e-3, 2 ** -7)),
    ((4, 12, 136, 64), torch.bfloat16, 130, False, (2e-3, 2 ** -7)),
    ((2, 3, 5, 64), torch.bfloat16, None, False, (2e-3, 2 ** -7)),
    ((2, 3, 70, 32), torch.float32, 33, False, FP32_TOL),
    ((2, 3, 70, 32), torch.float32, None, True, FP32_TOL),
    # the fused kernel's edges: whole tiles (128), one row and key past
    # them (129), S_max (144, with a masked tail) and S_max + 1 (the two
    # passes); 1, 21 and 1536 heads leave a partial last wave of its
    # one-block-per-SM grid
    ((4, 12, 128, 64), torch.bfloat16, None, False, (2e-3, 2 ** -7)),
    ((4, 12, 129, 64), torch.bfloat16, None, False, (2e-3, 2 ** -7)),
    ((4, 12, 144, 64), torch.bfloat16, 130, False, (2e-3, 2 ** -7)),
    ((4, 12, 145, 64), torch.bfloat16, None, False, (2e-3, 2 ** -7)),
    ((1, 1, 129, 64), torch.bfloat16, None, False, (2e-3, 2 ** -7)),
    ((3, 7, 129, 64), torch.bfloat16, None, False, (2e-3, 2 ** -7)),
])
def test_attention_gradient_on_the_card(shape, dtype, valid_len, strided,
                                        tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    if strided:
        b, h, s, d = shape
        g = torch.randn((b, s, h, d), generator=gen, device="cuda") \
            .to(dtype).transpose(1, 2)
        assert not g.is_contiguous()
    else:
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = attention.launches
    before_bwd = attention.backward_launches
    before_fused = attention.fused_backward_launches
    out = attention.vit_attention(*ins, valid_len=valid_len)
    grads = torch.autograd.grad(out, ins, g)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    # one launch of the fused kernel, or one of each pass: the gradient
    # came from the kernel the rule picks
    fused = attention.backward_kernel(shape[2], shape[3], dtype) == "fused"
    assert attention.backward_launches == before_bwd + (1 if fused else 2)
    assert attention.fused_backward_launches == before_fused + int(fused)
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = attention.vit_attention_reference(*refs, valid_len=valid_len)
    for a, r in zip(grads, torch.autograd.grad(ref, refs, g)):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), r.float(), atol=tol[0],
                                   rtol=tol[1])
    if valid_len is not None:       # keys past valid_len: no gradient
        assert not grads[1][:, :, valid_len:].any()
        assert not grads[2][:, :, valid_len:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 12, 129, 64), (16, 12, 50, 64),
                                   (16, 12, 257, 64)])
def test_attention_gradient_is_deterministic_on_the_card(shape):
    """Two runs of the backward kernel give bitwise-equal dq, dk and dv:
    each head's sums run in one block in a fixed order (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    first = attention._attention_backward(q, k, v, g, None)
    again = attention._attention_backward(q, k, v, g, None)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_dator_train_step_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import numpy as np
    from instance_based_loc_tpu_torch.models.dator import train
    from instance_based_loc_tpu_torch.models.dator.fourdnet import (
        FourDNetConfig)
    from instance_based_loc_tpu_torch.models.dator.transreid_vit import (
        TransReIDConfig)
    cfg = FourDNetConfig(backbone=TransReIDConfig(
        img_height=32, img_width=16, patch_size=8, stride_size=8,
        hidden_size=64, num_layers=3, num_heads=4, local_feature=True,
        dtype=torch.float32), reduced_dim=16, num_classes=4,
        dtype=torch.float32)
    tcfg = train.TrainConfig(augment=True)
    cpu = train.create_train_state(cfg, tcfg, device="cpu")
    card = train.create_train_state(cfg, tcfg, device="cuda")
    card.model.load_state_dict(cpu.model.state_dict())
    rng = np.random.default_rng(0)
    rgb = torch.as_tensor(rng.integers(0, 256, (8, 32, 16, 3))
                          .astype(np.uint8))
    depth = torch.as_tensor(rng.integers(0, 65536, (8, 32, 16))
                            .astype(np.int32))
    labels = torch.arange(4).repeat_interleave(2)
    draws = train.make_step_draws(torch.Generator().manual_seed(0), 8, True,
                                  True)
    card_draws = train.StepDraws(draws.modality_p.cuda(), train.AugmentDraws(
        *(x.cuda() for x in draws.augment)))
    before = attention.launches
    before_bwd = attention.backward_launches
    before_fused = attention.fused_backward_launches
    m_card = train.train_step(card, rgb.cuda(), depth.cuda(), labels.cuda(),
                              card_draws)
    torch.cuda.synchronize()
    assert attention.launches == before + cfg.backbone.num_blocks
    # one backward call per tower block: fp32 heads of D = 16 take the two
    # passes (the fused kernel takes bf16 with D = 64), two launches each
    assert attention.backward_kernel(9, 16, torch.float32) == "two_pass"
    assert attention.backward_launches == (before_bwd
                                           + 2 * cfg.backbone.num_blocks)
    assert attention.fused_backward_launches == before_fused
    m_cpu = train.train_step(cpu, rgb, depth, labels, draws)
    for key in m_cpu:
        torch.testing.assert_close(m_card[key].cpu(), m_cpu[key], rtol=1e-4,
                                   atol=1e-6)


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
    # SAM-B and SAM-H widths at the 64x64 grid; WK = 64 with an odd HK
    # (S = 1216, not a multiple of 128); fp32 in and out on both paths
    (1, 12, 64, 64, 64, torch.bfloat16),
    (1, 16, 64, 64, 80, torch.bfloat16),
    (1, 2, 19, 64, 80, torch.bfloat16),
    (2, 2, 19, 64, 64, torch.bfloat16),
    (1, 2, 19, 64, 80, torch.float32),
    (1, 2, 48, 48, 64, torch.float32),
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


@pytest.mark.gpu
@pytest.mark.parametrize("taps,dtype", [
    (4, torch.bfloat16), (8, torch.bfloat16), (12, torch.float32),
    (20, torch.bfloat16), (24, torch.float32), (28, torch.bfloat16),
    (32, torch.bfloat16)])
def test_msda_gather_kernel_any_sampling_points(taps, dtype):
    """K = taps / 4 sampling points: each instantiation of the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(taps)
    s, h, d, q = 10000, 8, 32, 700
    vmap = torch.randn((s, h, d), generator=gen, device="cuda").to(dtype)
    lin = torch.randint(0, s, (q, h, taps), generator=gen, device="cuda",
                        dtype=torch.int32)
    coeff = torch.rand((q, h, taps), generator=gen, device="cuda")
    coeff[:, :, ::3] = 0.0
    before = dict(msda_gather.launches_by_taps)
    out = msda_gather.msda_level_gather(vmap, lin, coeff)
    torch.cuda.synchronize()
    assert msda_gather.launches_by_taps[taps] == before.get(taps, 0) + 1
    ref = msda_gather.msda_level_gather_reference(vmap, lin, coeff)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("taps", [2, 36])
def test_msda_gather_kernel_raises_for_other_taps(taps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    vmap = torch.zeros((100, 2, 16), device="cuda")
    lin = torch.zeros((5, 2, taps), dtype=torch.int32, device="cuda")
    coeff = torch.zeros((5, 2, taps), device="cuda")
    before = msda_gather.launches
    with pytest.raises(ValueError, match="T = 4K"):
        msda_gather.msda_level_gather(vmap, lin, coeff)
    assert msda_gather.launches == before


def _served_memory():
    """A small scene's memory on the card and four query frames."""
    from instance_based_loc_tpu_torch.data.synthetic import (
        default_scene, render_scene, ring_poses)
    from instance_based_loc_tpu_torch.memory import (ColorRegionDetector,
                                                     ObjectMemory)
    from instance_based_loc_tpu_torch.models.embedders import get_embedder
    scene = default_scene(num_objects=4, seed=3)
    poses = ring_poses(8, radius=4.5, height=1.3, target=(0, 0.4, 0))
    frames = [render_scene(scene, p, 120, 160, 150.0) for p in poses]
    memory = ObjectMemory(
        detector=ColorRegionDetector(min_area=80,
                                     floor_colors=[scene.floor_color]),
        camera_focal_lenth_x=150.0, camera_focal_lenth_y=150.0,
        get_embeddings_func=get_embedder("color"), log_enabled=False,
        device="cuda")
    for i in range(6):
        memory.process_image(frames[i][0], frames[i][1], poses[i],
                             consider_floor=True, min_points=150,
                             outlier_removal_config=None)
    memory.downsample_all_objects(voxel_size=0.02)
    memory.recluster_objects_with_dbscan(eps=0.1, min_points_per_cluster=40)
    return memory, [(frames[i][0], frames[i][1]) for i in (6, 7, 0, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 3])
def test_query_graph_replay_equals_eager(batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    import numpy as np
    memory, frames = _served_memory()
    base = memory._frame_counter
    runs = []
    for graph in (False, True, True):       # capture, then a replay
        memory._frame_counter = base
        runs.append(memory._localise_many_chunked(
            frames, batch, "vmap", True, graph=graph,
            outlier_removal_config=None))
    for run in runs[1:]:
        for (p_e, a_e), (p_g, a_g) in zip(runs[0], run):
            assert a_g[0] == a_e[0]
            assert np.array_equal(p_g, p_e)


@pytest.mark.gpu
def test_query_graph_refuses_a_host_synced_configuration():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    memory, frames = _served_memory()
    with pytest.raises(ValueError, match="cannot be captured"):
        memory._localise_many_chunked(
            frames[:1], 1, "vmap", False, graph=True,
            outlier_removal_config={"radius_nb_points": 8, "radius": 0.05})
