"""The port's multi-query serving (`ObjectMemory.localise_many` /
`localise_batched`, `ops.localise_kernels.localise_frames_batched`) on the
CPU, on the scene of `tests/test_memory_misc.py::
test_localise_batched_matches_single` (4 objects, 8 ring views at 120x160,
memory from views 0-5).

The equality tests run the query program at reduced capacities (256
registration points, 64 RANSAC hypotheses, 3 + 3 ICP steps; `SMALL`) to
stay CPU-fast: they hold the batched program to the single one, whatever
its sizes. The test against the JAX package runs the defaults.

Tolerances: every batched row gives the frame the same assignment as
`localise` under the same seed and the same pose bit for bit (each query
runs the single query's kernels with its own generator; the contract the
card is held to, 1e-5 on the pose, follows). Against the JAX
package, which cannot reproduce the port's random draws, the gate is the
reference's success thresholds (0.6 m, 0.3 rad): on one memory, every view
the JAX package's `localise_many` localises, the port's localises too.
"""

import numpy as np
import pytest
import torch

from instance_based_loc_tpu.memory import (ColorRegionDetector as
                                           JaxDetector)
from instance_based_loc_tpu.memory import ObjectMemory as JaxObjectMemory
from instance_based_loc_tpu.models.embedders import (
    get_embedder as jax_get_embedder)
from instance_based_loc_tpu_torch.data.synthetic import (default_scene,
                                                         render_scene,
                                                         ring_poses)
from instance_based_loc_tpu_torch.memory import (ColorRegionDetector,
                                                 ObjectMemory)
from instance_based_loc_tpu_torch.memory import object_memory as om
from instance_based_loc_tpu_torch.models.embedders import get_embedder
from instance_based_loc_tpu_torch.ops import localise_kernels as lk
from instance_based_loc_tpu_torch.utils.metrics import is_success, pose_errors

FOCAL, H, W = 150.0, 120, 160
KW = dict(outlier_removal_config=None)
EVAL_VIEWS = (6, 7, 0, 3, 5)
SMALL = dict(REGISTRATION_CAPACITY=256, FPFH_CAPACITY=64, EVAL_CAPACITY=512,
             NUM_HYPOTHESES=64, ICP_COARSE_ITERS=3, ICP_FINE_ITERS=3)


def _small(mp):
    for name, value in SMALL.items():
        mp.setattr(om, name, value)


@pytest.fixture
def small(monkeypatch):
    _small(monkeypatch)


@pytest.fixture(scope="module")
def served():
    """The built memory, the eval frames, their truths, and their single
    `localise` results from a fixed seed."""
    scene = default_scene(num_objects=4, seed=3)
    poses = ring_poses(8, radius=4.5, height=1.3, target=(0, 0.4, 0))
    frames = [render_scene(scene, p, H, W, FOCAL) for p in poses]
    memory = ObjectMemory(
        detector=ColorRegionDetector(min_area=80,
                                     floor_colors=[scene.floor_color]),
        camera_focal_lenth_x=FOCAL, camera_focal_lenth_y=FOCAL,
        get_embeddings_func=get_embedder("color"), log_enabled=False,
        device="cpu")
    for i in range(6):
        rgb, depth, _ = frames[i]
        memory.process_image(rgb, depth, poses[i], consider_floor=True,
                             min_points=150, outlier_removal_config=None)
    memory.downsample_all_objects(voxel_size=0.02)
    memory.recluster_objects_with_dbscan(eps=0.1, min_points_per_cluster=40)
    eval_frames = [(frames[i][0], frames[i][1]) for i in EVAL_VIEWS]
    base = memory._frame_counter
    with pytest.MonkeyPatch.context() as mp:
        _small(mp)
        singles = [memory.localise(rgb, depth, **KW)
                   for rgb, depth in eval_frames]
    return memory, base, eval_frames, [poses[i] for i in EVAL_VIEWS], singles


def _same(results, singles):
    assert len(results) == len(singles)
    for (p1, a1), (p2, a2) in zip(singles, results):
        assert a2[0] == a1[0]
        np.testing.assert_array_equal(p2, p1)


def test_localise_batched_rows_equal_localise(served, small):
    memory, base, frames, _, singles = served
    memory._frame_counter = base
    _same(memory.localise_batched(frames, **KW), singles)
    assert memory._frame_counter == base + len(frames)


@pytest.mark.parametrize("batch,overlap", [(1, True), (1, False), (3, True),
                                           (3, False), (4, True)])
def test_localise_many_equals_localise_batched(served, small, batch,
                                               overlap):
    """Batch 3 over 5 frames ends in a partial chunk of 2 (padded to 3),
    batch 4 in one of 1."""
    memory, base, frames, _, singles = served
    memory._frame_counter = base
    _same(memory.localise_many(frames, overlap=overlap, batch=batch, **KW),
          singles)


def test_scan_mode_raises(served):
    memory, _, frames, _, _ = served
    with pytest.raises(ValueError, match="scan"):
        memory.localise_batched(frames[:1], batch_mode="scan", **KW)
    with pytest.raises(ValueError, match="scan"):
        memory.localise_many(frames[:1], batch=2, batch_mode="scan", **KW)


def test_frames_without_detections_skip_the_device(served, small):
    memory, base, frames, _, singles = served
    blank = (np.zeros((H, W, 3), np.uint8), np.zeros((H, W), np.float32))
    memory._frame_counter = base
    out = memory.localise_many([frames[0], blank, frames[1]], batch=2, **KW)
    np.testing.assert_array_equal(out[1][0], [0, 0, 0, 0, 0, 0, 1])
    assert out[1][1] == [[], []]
    # the blank frame draws no seed: frame 1 takes frame 0's successor
    assert out[0][1][0] == singles[0][1][0]
    np.testing.assert_array_equal(out[0][0], singles[0][0])


def test_batched_program_rows_equal_single_programs(served, small):
    """`localise_frames_batched` against `localise_frame` row by row, on
    the staged host arrays of two frames: every output."""
    memory, _, frames, _, _ = served
    hosts = [memory._localise_host(rgb, depth, **KW) for rgb, depth in
             frames[:2]]
    h0 = hosts[0]
    query = [torch.as_tensor(np.stack([h["query"][name] for h in hosts]))
             for name in ("depth", "rgb", "masks", "det_embs", "det_valid")]
    gens = [torch.Generator().manual_seed(h["seed"]) for h in hosts]
    batched = lk.localise_frames_batched(*query, *h0["mem_args"],
                                         *h0["scalars"], gens,
                                         **h0["statics"])
    for g, h in enumerate(hosts):
        single = lk.localise_frame(
            *(torch.as_tensor(h["query"][name]) for name in
              ("depth", "rgb", "masks", "det_embs", "det_valid")),
            *h["mem_args"], *h["scalars"],
            torch.Generator().manual_seed(h["seed"]), **h["statics"])
        assert set(single) == set(batched)
        for key, value in single.items():
            np.testing.assert_array_equal(batched[key][g].numpy(),
                                          value.numpy(), err_msg=key)


def test_localise_many_localises_what_jax_localises(served, tmp_path):
    """One memory (the port's, through its pkl) served by both packages'
    `localise_many`: every view the JAX package localises within the gate,
    the port localises too."""
    memory, base, frames, truths, _ = served
    frames, truths = frames[:3], truths[:3]
    path = str(tmp_path / "memory.pkl")
    memory.save_to_pkl(path)
    scene = default_scene(num_objects=4, seed=3)
    jax_mem = JaxObjectMemory(
        detector=JaxDetector(min_area=80, floor_colors=[scene.floor_color]),
        camera_focal_lenth_x=FOCAL, camera_focal_lenth_y=FOCAL,
        get_embeddings_func=jax_get_embedder("color"), log_enabled=False)
    jax_mem.load(path)
    jax_mem._frame_counter = base
    memory._frame_counter = base
    jax_out = jax_mem.localise_many(frames, batch=1, **KW)
    port_out = memory.localise_many(frames, batch=2, **KW)
    jax_ok = [is_success(*pose_errors(t, p)) for t, (p, _) in
              zip(truths, jax_out)]
    port_ok = [is_success(*pose_errors(t, p)) for t, (p, _) in
               zip(truths, port_out)]
    assert sum(jax_ok) >= 2, jax_ok
    assert all(p or not j for j, p in zip(jax_ok, port_ok)), (jax_ok, port_ok)
