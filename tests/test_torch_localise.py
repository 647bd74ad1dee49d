"""The port's localisation programs and object memory against the JAX
package's.

Op level, with the random draws fed to both sides where there are any:
the masked subsamples, the query preparation (`_prepare_body`'s
deterministic outputs: ordering, counts, similarities, SimVolume top-k),
assignment selection and the memory-build frame step. Integer outputs must be
equal; floats within 1e-5 (fp32 in another order).

The slice as a whole: the `test_memory_e2e.py` scene (160x220, 5 objects,
7 views) built and localised by both packages with the `color` embedder.
The built memories must hold the same objects; both localisations must meet
the reference's success thresholds (0.6 m, 0.3 rad), and their poses must
agree within them. They are never compared bitwise: the two packages draw
different random numbers for subsampling and RANSAC.
"""

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from instance_based_loc_tpu.data.synthetic import (
    default_scene, render_scene, ring_poses)
from instance_based_loc_tpu.memory import (
    ObjectMemory as JaxObjectMemory, ColorRegionDetector as JaxDetector)
from instance_based_loc_tpu.models.embedders import (
    get_embedder as jax_get_embedder)
from instance_based_loc_tpu.ops import localise_kernels as jlk
from instance_based_loc_tpu.ops.transforms import (
    quaternion_error as jax_quaternion_error)
from instance_based_loc_tpu_torch.memory import (
    ObjectMemory, ColorRegionDetector)
from instance_based_loc_tpu_torch.models.embedders import get_embedder
from instance_based_loc_tpu_torch.ops import localise_kernels as tlk

FOCAL = 200.0
H, W = 160, 220
TRANS_OK, ROT_OK = 0.6, 0.3


def _t(x):
    return torch.as_tensor(np.array(x))


def _rot_err(q_true, q_est):
    return float(jax_quaternion_error(jnp.asarray(q_true, jnp.float32),
                                      jnp.asarray(q_est, jnp.float32)))


# --------------------------------------------------------------------------- #
# op level
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n,cap", [(300, 64), (40, 64)])
def test_masked_subsample_matches_jax(n, cap):
    rng = np.random.default_rng(n)
    valid = rng.uniform(size=(3, n)) < 0.5
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    for i in range(3):
        jidx, jkeep = jlk._masked_subsample(None, jnp.asarray(valid[i]), cap,
                                            keys[i])
        uniform = jax.random.uniform(keys[i], (n,))   # the reference's draw
        tidx, tkeep = tlk._masked_subsample(_t(valid[i]), cap,
                                            uniform=_t(uniform))
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
        keep = np.asarray(jkeep)
        np.testing.assert_array_equal(tidx.numpy()[keep],
                                      np.asarray(jidx)[keep])


def test_masked_subsample_linear_matches_jax():
    rng = np.random.default_rng(5)
    n, cap = 500, 96
    valid = rng.uniform(size=(2, n)) < 0.4
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    for i in range(2):
        jidx, jkeep = jlk._masked_subsample_linear(jnp.asarray(valid[i]), cap,
                                                   keys[i])
        shift = jax.random.randint(keys[i], (), 0, n)   # the reference's draw
        tidx, tkeep = tlk._masked_subsample_linear(_t(valid[i]), cap,
                                                   shift=_t(shift).long())
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def test_masked_median_matches_jax():
    rng = np.random.default_rng(6)
    values = rng.normal(size=(5, 9)).astype(np.float32)
    valid = rng.uniform(size=(5, 9)) < 0.6
    valid[0] = False
    ref = np.stack([np.asarray(jlk._masked_median(jnp.asarray(v),
                                                  jnp.asarray(m)))
                    for v, m in zip(values, valid)])
    np.testing.assert_allclose(
        tlk._masked_median(_t(values), _t(valid)).numpy(), ref, atol=1e-6)


def _query_inputs():
    """A small query: blob masks on a random depth image and a memory."""
    rng = np.random.default_rng(7)
    h, w, d_pad, e = 40, 50, 8, 16
    depth = rng.uniform(1.0, 3.0, size=(h, w)).astype(np.float32)
    depth[:, :5] = 0.0
    rgb = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:h, :w]
    masks = np.zeros((d_pad, h, w), bool)
    for i in range(6):
        cy, cx, r = rng.uniform(5, 35), rng.uniform(8, 45), 4 + i % 3
        masks[i] = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    det_embs = rng.normal(size=(d_pad, e)).astype(np.float32)
    det_valid = np.arange(d_pad) < 6
    mem_ex = rng.normal(size=(8, 2, e)).astype(np.float32)
    mem_ex /= np.linalg.norm(mem_ex, axis=-1, keepdims=True)
    mem_ex_valid = np.ones((8, 2), bool)
    mem_ex_valid[:, 1] = rng.uniform(size=8) < 0.5
    mem_valid = np.arange(8) < 5
    subsets = tlk.make_subsets(7, 3)
    np.testing.assert_array_equal(subsets, jlk.make_subsets(7, 3))
    return (depth, rgb, masks, det_embs, det_valid, mem_ex, mem_ex_valid,
            mem_valid, subsets)


# no outlier pass here: whether a neighbour within ~1e-7 of the radius
# counts depends on fp32 rounding (one such point on these inputs,
# |d^2 - r^2| = 6.8e-8), which moves a count by one; the outlier op is held
# to the JAX one in test_torch_geometry.py and in process_frame below
STATICS = dict(top_n=7, det_cap=64, budget=112, outlier_passes=0,
               nb_points=3, min_det_points=16)


def test_prepare_and_select_match_jax():
    args = _query_inputs()
    jfetch, _ = jlk.prepare_frame(*(jnp.asarray(a) for a in args),
                                  jnp.float32(60.0), jnp.float32(60.0),
                                  jnp.float32(0.1), jax.random.PRNGKey(0),
                                  **STATICS)
    tfetch, tkept = tlk._prepare_body(
        *(_t(a) for a in args[:8]), _t(args[8]).long(), 60.0, 60.0, 0.1,
        torch.Generator().manual_seed(0), **STATICS)
    for key in ("order", "counts", "active", "vol_idx"):
        np.testing.assert_array_equal(tfetch[key].numpy(),
                                      np.asarray(jfetch[key]), err_msg=key)
    for key in ("sims", "vol_vals"):
        np.testing.assert_allclose(tfetch[key].numpy(),
                                   np.asarray(jfetch[key]), atol=1e-5,
                                   err_msg=key)
    assert tkept["sel_pts"].shape == (7, 64, 3)

    # selection on the reference's volume entries, in both packages
    vals, idx = np.asarray(jfetch["vol_vals"]), np.asarray(jfetch["vol_idx"])
    subsets = args[8]
    ref = jlk._select_body(jnp.asarray(subsets), jnp.asarray(vals),
                           jnp.asarray(idx), 8, 8)
    out = tlk._select_body(_t(subsets).long(), _t(vals), _t(idx).long(), 8, 8)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert (tlk.select_assignments(subsets, vals, idx, 8)
            == jlk.select_assignments(subsets, vals, idx, 8))


@pytest.mark.parametrize("kinect,outliers", [(False, False), (True, False),
                                             (False, True)])
def test_process_frame_matches_jax(kinect, outliers):
    depth, rgb, masks, *_ = _query_inputs()
    pose = np.array([0.3, -0.2, 1.0, 0.1, 0.2, -0.1, 0.97], np.float32)
    kw = dict(proc_cap=128, apply_outlier=outliers, nb_points=3,
              kinect=kinect, add_noise=False)
    jpc, jraw, jsub = jlk.process_frame(
        jnp.asarray(depth), jnp.asarray(rgb), jnp.asarray(masks),
        jnp.asarray(pose), jnp.float32(60.0), jnp.float32(60.0),
        jnp.float32(0.1), jnp.float32(0.0), jax.random.PRNGKey(0), **kw)
    tpc, traw, tsub = tlk.process_frame(
        _t(depth), _t(rgb), _t(masks), _t(pose), 60.0, 60.0, 0.1, 0.0,
        torch.Generator().manual_seed(0), **kw)
    if outliers:
        # a neighbour at the radius (see STATICS) may move a count by one
        assert np.abs(traw.numpy() - np.asarray(jraw)).max() <= 1
        assert np.abs(tsub.numpy() - np.asarray(jsub)).max() <= 1
        return
    np.testing.assert_array_equal(traw.numpy(), np.asarray(jraw))
    np.testing.assert_array_equal(tsub.numpy(), np.asarray(jsub))
    # every mask holds < proc_cap points, so both keep all of them, each
    # in its own random order: compare the rows as sorted sets
    for i, n in enumerate(np.asarray(jsub)):
        a = np.asarray(jpc)[i, :n]
        b = tpc.numpy()[i, :n]
        np.testing.assert_allclose(b[np.lexsort(b.T)], a[np.lexsort(a.T)],
                                   atol=1e-5)


# --------------------------------------------------------------------------- #
# the slice end to end
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def world():
    scene = default_scene(num_objects=5, seed=3)
    poses = ring_poses(7, radius=4.5, height=1.3, target=(0, 0.4, 0))
    frames = [render_scene(scene, p, H, W, FOCAL) for p in poses]
    return scene, poses, frames


def _build(memory, poses, frames):
    for i in range(len(poses) - 1):   # the last view is held out
        rgb, depth, _ = frames[i]
        memory.process_image(rgb, depth, poses[i], consider_floor=True,
                             min_points=200, outlier_removal_config=None)
    built = copy.deepcopy(memory)
    memory.downsample_all_objects(voxel_size=0.02)
    memory.recluster_objects_with_dbscan(eps=0.1, min_points_per_cluster=40)
    return built, memory


@pytest.fixture(scope="module")
def memories(world):
    scene, poses, frames = world
    jax_mem = JaxObjectMemory(
        detector=JaxDetector(min_area=80, floor_colors=[scene.floor_color]),
        camera_focal_lenth_x=FOCAL, camera_focal_lenth_y=FOCAL,
        get_embeddings_func=jax_get_embedder("color"), log_enabled=False)
    port_mem = ObjectMemory(
        detector=ColorRegionDetector(min_area=80,
                                     floor_colors=[scene.floor_color]),
        camera_focal_lenth_x=FOCAL, camera_focal_lenth_y=FOCAL,
        get_embeddings_func=get_embedder("color"), log_enabled=False,
        device="cpu")
    return _build(jax_mem, poses, frames), _build(port_mem, poses, frames)


def test_slice_builds_the_same_memory(world, memories):
    scene = world[0]
    (jax_built, jax_mem), (port_built, port_mem) = memories
    # every detection holds fewer points than the per-detection budget, so
    # both packages keep the same point sets (each in its own random order)
    assert len(port_built.memory) == len(jax_built.memory) > len(scene.boxes)
    assert port_built.floors is not None and jax_built.floors is not None
    for a, b in zip(port_built.memory, jax_built.memory):
        assert a.names == b.names
        np.testing.assert_allclose(np.sort(a.pts, axis=0),
                                   np.sort(b.pts, axis=0), atol=1e-5)
        np.testing.assert_array_equal(a.mean_emb, b.mean_emb)
    assert len(port_mem.memory) == len(jax_mem.memory) == len(scene.boxes)
    for a, b in zip(port_mem.memory, jax_mem.memory):
        assert a.names == b.names
        assert abs(a.num_points() - b.num_points()) <= 2
        np.testing.assert_allclose(a.centroid, b.centroid, atol=1e-3)


def test_slice_localises_like_jax(world, memories):
    _, poses, frames = world
    (_, jax_mem), (_, port_mem) = memories
    rgb, depth, _ = frames[-1]
    truth = poses[-1]
    jax_pose, _ = jax_mem.localise(rgb, depth, outlier_removal_config=None)
    port_pose, (assn, _) = port_mem.localise(rgb, depth,
                                             outlier_removal_config=None)
    assert port_pose.shape == (7,) and np.all(np.isfinite(port_pose))
    assert assn
    for name, pose in (("jax", jax_pose), ("port", port_pose)):
        assert np.linalg.norm(pose[:3] - truth[:3]) < TRANS_OK, (name, pose)
        assert _rot_err(truth[3:], pose[3:]) < ROT_OK, (name, pose)
    assert np.linalg.norm(port_pose[:3] - jax_pose[:3]) < TRANS_OK
    assert _rot_err(jax_pose[3:], port_pose[3:]) < ROT_OK


def test_port_loads_and_localises_a_jax_memory(world, memories, tmp_path):
    scene, poses, frames = world
    (_, jax_mem), _ = memories
    path = str(tmp_path / "jax_memory.pkl")
    jax_mem.save_to_pkl(path)
    port_mem = ObjectMemory(
        detector=ColorRegionDetector(min_area=80,
                                     floor_colors=[scene.floor_color]),
        camera_focal_lenth_x=FOCAL,
        camera_focal_lenth_y=FOCAL, get_embeddings_func=get_embedder("color"),
        log_enabled=False, device="cpu")
    port_mem.load(path)
    assert len(port_mem.memory) == len(jax_mem.memory)
    rgb, depth, _ = frames[-1]
    pose, _ = port_mem.localise(rgb, depth, outlier_removal_config=None)
    assert np.linalg.norm(pose[:3] - poses[-1][:3]) < TRANS_OK
    assert _rot_err(poses[-1][3:], pose[3:]) < ROT_OK


@pytest.mark.parametrize("knob,value", [("RANSAC_PAIRS_MAX", 1),
                                        ("REG_SEEDS", 2),
                                        ("ICP_EARLY_EXIT", True)])
def test_registration_knobs_keep_the_gate(world, memories, monkeypatch,
                                          knob, value):
    """The IBL_* registration knobs' other paths (RANSAC only on 1-pair
    slots, seed-redundant registration, early-exit ICP) also localise the
    held-out view within the reference's thresholds, as the JAX package's
    test_ransac_partition_knob_quality holds for its partition knob."""
    from instance_based_loc_tpu_torch.memory import object_memory as om
    _, poses, frames = world
    _, (_, port_mem) = memories
    memory = copy.deepcopy(port_mem)
    memory._frame_counter = 100          # the JAX test's fixed query stream
    monkeypatch.setattr(om, knob, value)
    rgb, depth, _ = frames[-1]
    pose, (assn, _) = memory.localise(rgb, depth, outlier_removal_config=None)
    assert assn
    assert np.linalg.norm(pose[:3] - poses[-1][:3]) < TRANS_OK
    assert _rot_err(poses[-1][3:], pose[3:]) < ROT_OK


def test_floor_removal_and_pkl_round_trip_match_jax(memories, tmp_path):
    """remove_points_below_floor gives the JAX package's objects, and a pkl
    saved by the port loads in the JAX package unchanged."""
    (_, jax_mem), (_, port_mem) = memories
    jax_copy, port_copy = copy.deepcopy(jax_mem), copy.deepcopy(port_mem)
    path = str(tmp_path / "jax.pkl")
    jax_copy.save_to_pkl(path)
    port_copy.load(path)                 # the same objects in both
    jax_copy.remove_points_below_floor()
    port_copy.remove_points_below_floor()
    assert len(port_copy.memory) == len(jax_copy.memory) > 0
    for a, b in zip(port_copy.memory, jax_copy.memory):
        np.testing.assert_array_equal(a.pts, b.pts)
        np.testing.assert_array_equal(a.mean_emb, b.mean_emb)

    port_path = str(tmp_path / "port.pkl")
    port_copy.save_to_pkl(port_path)
    reloaded = copy.deepcopy(jax_mem)
    reloaded.load(port_path)
    assert [o.names for o in reloaded.memory] == \
        [o.names for o in port_copy.memory]
    for a, b in zip(reloaded.memory, port_copy.memory):
        np.testing.assert_array_equal(a.pts, b.pts)


# --------------------------------------------------------------------------- #
# reclustering: each strategy after downsampling, both packages
# --------------------------------------------------------------------------- #
RECLUSTER = {
    # the trial CLI's default strategy with the arguments it passes
    "clustering_and_IoU": ("recluster_via_clustering_and_IoU",
                           dict(embedding_distance_threshold=0.5, eps=0.1,
                                min_points_per_cluster=40,
                                IoU_threshold=0.25)),
    "agglomerative": ("recluster_via_agglomerative_clustering",
                      dict(embedding_distance_threshold=0.4)),
    "combined": ("recluster_via_combined",
                 dict(embedding_distance_threshold=0.4, eps=0.1,
                      min_points_per_cluster=40)),
}


def _downsampled(memories, monkeypatch, tmp_path):
    """The JAX package's built memory in both packages (through its pkl:
    the same points in the same order), downsampled; the JAX package on
    its numpy paths (its compiled helpers switched off), which the port
    matches row for row."""
    from instance_based_loc_tpu.ops import native
    monkeypatch.setattr(native, "voxel_downsample_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(native, "dbscan_native", lambda *a, **k: None)
    (jax_built, _), (port_built, _) = memories
    jax_mem, port_mem = copy.deepcopy(jax_built), copy.deepcopy(port_built)
    path = str(tmp_path / "built.pkl")
    jax_mem.save_to_pkl(path)
    port_mem.load(path)
    for mem in (jax_mem, port_mem):
        mem.downsample_all_objects(voxel_size=0.02)
    return jax_mem, port_mem


@pytest.mark.parametrize("strategy", sorted(RECLUSTER))
def test_recluster_matches_jax(memories, monkeypatch, tmp_path, strategy):
    jax_mem, port_mem = _downsampled(memories, monkeypatch, tmp_path)
    method, kwargs = RECLUSTER[strategy]
    getattr(jax_mem, method)(**kwargs)
    getattr(port_mem, method)(**kwargs)
    assert 0 < len(port_mem.memory) == len(jax_mem.memory)
    for a, b in zip(port_mem.memory, jax_mem.memory):
        assert a.names == b.names
        assert a.id == b.id
        assert a.pts.shape == b.pts.shape
        np.testing.assert_allclose(a.pts, b.pts, atol=1e-5)
        np.testing.assert_allclose(a.mean_emb, b.mean_emb, atol=1e-6)


def test_recluster_iou_matrix_matches_jax(memories, monkeypatch, tmp_path):
    """`_recluster_IoU`'s staged clouds (numpy's default_rng(0) draw of at
    most 2048 points per object) and its IoU matrix, against the JAX
    package's staging (object_memory.py:445-456) and matrix; the
    clustering of both matrices at the CLI's IoU threshold (0.25) is the
    same."""
    from instance_based_loc_tpu.ops.iou3d import (
        pairwise_obb_iou as jax_pairwise_obb_iou)
    from instance_based_loc_tpu.ops.pointcloud import round_up_pow2
    from instance_based_loc_tpu_torch.ops.iou3d import pairwise_obb_iou
    jax_mem, port_mem = _downsampled(memories, monkeypatch, tmp_path)
    k = len(jax_mem.memory)
    cap = round_up_pow2(
        min(max(max(o.num_points() for o in jax_mem.memory), 8), 2048))
    rng = np.random.default_rng(0)
    pts = np.zeros((k, cap, 3), np.float32)
    msk = np.zeros((k, cap), bool)
    for i, obj in enumerate(jax_mem.memory):
        p = obj.points()
        if len(p) > cap:
            p = p[rng.choice(len(p), cap, replace=False)]
        pts[i, :len(p)] = p
        msk[i, :len(p)] = True
    ref = np.asarray(jax_pairwise_obb_iou(jnp.asarray(pts), jnp.asarray(msk)))

    tpts, tmsk = port_mem._iou_clouds()
    np.testing.assert_array_equal(tmsk, msk)
    np.testing.assert_allclose(tpts, pts, atol=1e-6)
    out = pairwise_obb_iou(torch.as_tensor(tpts),
                           torch.as_tensor(tmsk)).numpy()
    assert k > 5 and (ref[~np.eye(k, dtype=bool)] > 0).any()
    # 1e-4, not 1e-5: both packages sum volume tetrahedra that reach from
    # the world origin to boxes ~3 m out, each of size |p|^3 ~ 20 m^3, in
    # fp32 and in their own order (4.4e-5 here; each is 1.4e-4 off the
    # same sums in float64)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    from instance_based_loc_tpu.ops.clustering import (
        agglomerative_precomputed as jax_agglomerative)
    from instance_based_loc_tpu_torch.ops.clustering import (
        agglomerative_precomputed)
    np.testing.assert_array_equal(
        agglomerative_precomputed(1.0 - out, 0.75),
        jax_agglomerative(1.0 - ref, 0.75))
    port_mem._recluster_IoU(0.25)
    assert port_mem.timer.counts["recluster.iou_matrix"] == 1
