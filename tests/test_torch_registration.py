"""The port's registration library API, semantic ICP and the PointCloud
container against the JAX package's, on the CPU.

Inputs are made with numpy from a seed. Where the JAX function draws
RANSAC hypotheses, the test draws them as the JAX function does (its key;
the batched call splits its key per assignment) and feeds them to the port
as `samples`. Tolerances: transforms 1e-4, fitness and rmse 1e-5 (the same
fp32 arithmetic in another order, through 30 ICP iterations); container
values and masks exact. The golden recoveries of
tests/test_registration_golden.py run on the port with that file's
thresholds.
"""

import zlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from instance_based_loc_tpu.ops import (
    fpfh as jfpfh, icp as jicp, normals as jnorm, pointcloud as jpc,
    ransac as jran, registration as jreg)
from instance_based_loc_tpu_torch.ops import icp, pointcloud, registration
from instance_based_loc_tpu_torch.ops.pointcloud import PointCloud

CAP = 256
HYP = 128


def _box_surface(rng, n, size=(1.0, 0.6, 0.4)):
    """Points on the surface of a box (tests/test_registration.py's
    sampler): distinctive geometry for FPFH."""
    size = np.asarray(size)
    face = rng.integers(0, 6, size=n)
    uv = rng.uniform(-0.5, 0.5, size=(n, 2))
    axis = face % 3
    pts = np.zeros((n, 3))
    rows = np.arange(n)
    pts[rows, axis] = np.where(face < 3, 0.5, -0.5) * size[axis]
    other0 = (axis + 1) % 3
    other1 = (axis + 2) % 3
    lo, hi = np.minimum(other0, other1), np.maximum(other0, other1)
    pts[rows, lo] = uv[:, 0] * size[lo]
    pts[rows, hi] = uv[:, 1] * size[hi]
    return pts.astype(np.float32)


def _rigid(rng, angle=0.6, shift=0.4):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_euler("xyz", rng.uniform(-angle, angle, 3)
                                    ).as_matrix()
    T[:3, 3] = rng.uniform(-shift, shift, 3)
    return T


def _blobs(rng, n):
    """tests/test_registration_golden.py's scene: three Gaussian clusters
    and a plane patch (FPFH tells its points apart; a box's flat faces
    leave most mutual feature matches to rounding)."""
    k = n // 4
    return np.concatenate([
        rng.normal(size=(k, 3)) * 0.12 + np.array([0.5, 0, 0]),
        rng.normal(size=(k, 3)) * 0.08 + np.array([-0.4, 0.3, 0.2]),
        rng.normal(size=(k, 3)) * 0.05 + np.array([0, -0.4, 0.5]),
        np.concatenate([rng.uniform(-0.5, 0.5, size=(n - 3 * k, 2)),
                        np.zeros((n - 3 * k, 1))], axis=1),
    ]).astype(np.float32)


def _pair(rng, n=200):
    src = _blobs(rng, n)
    T = _rigid(rng)
    tgt = (src @ T[:3, :3].T + T[:3, 3]
           + 0.002 * rng.normal(size=src.shape)).astype(np.float32)
    cols = rng.uniform(size=src.shape).astype(np.float32)
    return src, tgt, cols, T


def _clouds(pts, cols, cap=CAP):
    return (jpc.PointCloud.from_numpy(pts, cols, capacity=cap),
            PointCloud.from_numpy(pts, cols, capacity=cap, device="cpu"))


def _jax_samples(src, tgt, voxel, key, hyp=HYP):
    """The draws of JAX `_register_impl` for one pair: its correspondence
    validity (normals, FPFH, mutual matches), then `ransac_registration`'s
    `jax.random.choice`."""
    v = jnp.float32(voxel)
    sn = jnorm.estimate_normals(src.points, src.mask, v * 2.0, max_nn=30)
    tn = jnorm.estimate_normals(tgt.points, tgt.mask, v * 2.0, max_nn=30)
    sf = jfpfh.compute_fpfh(src.points, sn, src.mask, v * 5.0, max_nn=100)
    tf = jfpfh.compute_fpfh(tgt.points, tn, tgt.mask, v * 5.0, max_nn=100)
    _, valid = jran.feature_correspondences(sf, src.mask, tf, tgt.mask)
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return np.asarray(jax.random.choice(key, src.capacity, shape=(hyp, 3),
                                        p=probs))


def _t(x):
    return torch.as_tensor(np.array(x))


def case_register_point_clouds(rng):
    src, tgt, cols, _ = _pair(rng)
    js, ts = _clouds(src, cols)
    jt, tt = _clouds(tgt, cols)
    jT, jr, jf = jreg.register_point_clouds(js, jt, 0.05, seed=3,
                                            num_hypotheses=HYP)
    samples = _jax_samples(js, jt, 0.05, jax.random.PRNGKey(3))
    tT, tr, tf = registration.register_point_clouds(
        ts, tt, 0.05, num_hypotheses=HYP, samples=_t(samples).long())
    return [(jT, tT, 1e-4), (jr, tr, 1e-5), (jf, tf, 1e-5)]


def case_refine_registration(rng):
    src, tgt, cols, T = _pair(rng)
    js, ts = _clouds(src, cols)
    jt, tt = _clouds(tgt, cols)
    init = T.copy()
    init[:3, 3] += [0.03, -0.02, 0.02]
    init[:3, :3] = init[:3, :3] @ Rotation.from_euler(
        "z", 0.05).as_matrix().astype(np.float32)
    jT, jr, jf = jreg.refine_registration(js, jt, init, 0.05,
                                          icp_iterations=10)
    tT, tr, tf = registration.refine_registration(ts, tt, init, 0.05,
                                                  icp_iterations=10)
    return [(jT, tT, 1e-4), (jr, tr, 1e-5), (jf, tf, 1e-5)]


def case_evaluate_transform(rng):
    src, tgt, cols, T = _pair(rng)
    js, ts = _clouds(src, cols)
    jt, tt = _clouds(tgt, cols)
    out = []
    for thr in (0.02, 0.005):
        ref = jreg.evaluate_transform(js, jt, T, threshold=thr)
        got = registration.evaluate_transform(ts, tt, T, threshold=thr)
        out += [(ref[0], got[0], 1e-5), (ref[1], got[1], 1e-5)]
    return out


def case_register_assignments_batched(rng):
    a, voxel, seed = 3, 0.05, 5
    srcs, tgts, inits = [], [], []
    for _ in range(a):
        src, tgt, cols, T = _pair(rng, n=150)
        srcs.append((src, cols))
        tgts.append((tgt, cols))
        init = T.copy()
        init[:3, 3] += rng.uniform(-0.03, 0.03, 3)
        inits.append(init)
    has_init = np.array([True, False, True])
    det_means = rng.normal(size=(a, 3)).astype(np.float32)
    mem_means = rng.normal(size=(a, 3)).astype(np.float32)

    def batch(pairs, mod, **kw):
        one = [mod.PointCloud.from_numpy(p, c, capacity=CAP, **kw)
               for p, c in pairs]
        stack = jnp.stack if mod is jpc else torch.stack
        return mod.PointCloud(stack([c.points for c in one]),
                              stack([c.colors for c in one]),
                              stack([c.mask for c in one]))

    jsrc, jtgt = batch(srcs, jpc), batch(tgts, jpc)
    tsrc = batch(srcs, pointcloud, device="cpu")
    ttgt = batch(tgts, pointcloud, device="cpu")
    # the full clouds: each assignment's clouds moved to their means
    eval_src = np.concatenate([p + m for (p, _), m in zip(srcs, det_means)])
    eval_tgt = np.concatenate([p + m for (p, _), m in zip(tgts, mem_means)])
    je_s, te_s = _clouds(eval_src, None, 512)
    je_t, te_t = _clouds(eval_tgt, None, 512)
    args = (np.stack(inits), has_init, det_means, mem_means)
    ref = jreg.register_assignments_batched(
        jsrc, jtgt, *args, je_s, je_t, voxel, seed=seed, num_hypotheses=HYP)
    keys = jax.random.split(jax.random.PRNGKey(seed), a)
    samples = np.stack([_jax_samples(
        jpc.PointCloud(jsrc.points[i], jsrc.colors[i], jsrc.mask[i]),
        jpc.PointCloud(jtgt.points[i], jtgt.colors[i], jtgt.mask[i]),
        voxel, keys[i]) for i in range(a)])
    got = registration.register_assignments_batched(
        tsrc, ttgt, *args, te_s, te_t, voxel, num_hypotheses=HYP,
        samples=_t(samples).long())
    tols = (1e-4, 1e-5, 1e-5, 1e-5, 1e-5)
    return [(r, g, tol) for r, g, tol in zip(ref, got, tols)]


def case_semantic_icp(rng):
    # four identical boxes that only the labels tell apart (at a
    # tetrahedron's corners: a well-conditioned fp32 Kabsch; boxes in a
    # row leave both packages' closed-form SVD 1e-3 off), plus a label no
    # target carries (its points map to row 0 and are no inliers)
    blob = _box_surface(rng, 60, size=(0.5, 0.4, 0.3))
    corners = 0.6 * np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1],
                              [-1, -1, 1]])
    src = np.concatenate([blob + c for c in corners]).astype(np.float32)
    labels = np.repeat(np.arange(4, dtype=np.int32), 60)
    T = _rigid(rng, angle=0.1, shift=0.3)
    tgt = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    lab_s = np.full(CAP, 7, np.int32)
    lab_s[:240] = labels
    lab_s[230:240] = 5                       # no target carries label 5
    lab_t = np.zeros(CAP, np.int32)
    lab_t[:240] = labels
    js, ts = _clouds(src, None)
    jt, tt = _clouds(tgt, None)
    ref = jicp.semantic_icp(js.points, jnp.asarray(lab_s), js.mask,
                            jt.points, jnp.asarray(lab_t), jt.mask, 1.0,
                            max_iterations=20)
    got = icp.semantic_icp(ts.points, _t(lab_s), ts.mask, tt.points,
                           _t(lab_t), tt.mask, 1.0, max_iterations=20)
    nn_idx, nn_d2 = icp._nearest_same_label(ts.points, _t(lab_s),
                                            tt.points, _t(lab_t), tt.mask)
    assert (nn_idx[230:240] == 0).all() and (nn_d2[230:240] >= 1e29).all()
    assert abs(float(got[1]) - 230 / 240) < 1e-6     # the label-5 points
    np.testing.assert_allclose(got[0].numpy(), T, atol=1e-3)
    return [(np.asarray(r), g.numpy(), tol)
            for r, g, tol in zip(ref, got, (1e-4, 1e-5, 1e-5))]


def case_pointcloud_container(rng):
    pts = rng.normal(size=(37, 3)).astype(np.float32)
    cols = rng.uniform(size=(37, 3)).astype(np.float32)
    j = jpc.PointCloud.from_numpy(pts, cols)
    t = PointCloud.from_numpy(pts, cols, device="cpu")
    assert t.capacity == j.capacity == 64
    keep = rng.uniform(size=64) < 0.6
    out = [(j.points, t.points, 0), (j.colors, t.colors, 0),
           (j.mask, t.mask, 0), (j.count(), t.count(), 0),
           (j.centroid(), t.centroid(), 1e-6)]
    out += [(a, b, 0) for a, b in zip(j.bounds(), t.bounds())]
    out += [(a, b, 0) for a, b in zip(j.to_numpy(), t.to_numpy())]
    for jc, tc in ((j.compact(40), t.compact(40)), (j.pad_to(100),
                                                   t.pad_to(100)),
                   (jpc.apply_point_mask(j, jnp.asarray(keep)),
                    pointcloud.apply_point_mask(t, _t(keep))),
                   (jpc.concatenate([j, j.compact()], capacity=200),
                    pointcloud.concatenate([t, t.compact()], capacity=200)),
                   (jreg.pad_for_registration(j),
                    registration.pad_for_registration(t)),
                   (jreg.pad_for_registration(j, 64),
                    registration.pad_for_registration(t, 64)),
                   (jpc.PointCloud.empty(16), PointCloud.empty(16, "cpu"))):
        out += [(jc.points, tc.points, 0), (jc.colors, tc.colors, 0),
                (jc.mask, tc.mask, 0)]
    empty = PointCloud.empty(8, "cpu")
    mn, mx = empty.bounds()
    assert torch.isinf(mn).all() and (mn > 0).all() and (mx < 0).all()
    assert int(empty.count()) == 0 and not empty.centroid().any()
    # a batched cloud: per-cloud queries
    two = pointcloud.concatenate([t, t])
    assert two.capacity == 128
    batched = PointCloud(torch.stack([t.points, t.points]),
                         torch.stack([t.colors, t.colors]),
                         torch.stack([t.mask, _t(keep)]))
    out += [(np.array([37, keep.sum()]), batched.count(), 0)]
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_registration_matches_jax(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    for i, (ref, out, atol) in enumerate(CASES[name](rng)):
        ref = np.asarray(ref)
        out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        assert ref.shape == out.shape, (name, i, ref.shape, out.shape)
        if atol == 0:
            np.testing.assert_array_equal(out, ref, err_msg=f"{name}[{i}]")
        else:
            np.testing.assert_allclose(out, ref, atol=atol, rtol=0,
                                       err_msg=f"{name}[{i}]")


# --------------------------------------------------------------------------- #
# tests/test_registration_golden.py's recoveries, on the port
# --------------------------------------------------------------------------- #
def _np_evaluate_registration(src, tgt, threshold, T):
    """Open3D's evaluate_registration contract in numpy."""
    src_t = src @ T[:3, :3].T + T[:3, 3]
    d = np.linalg.norm(src_t[:, None, :] - tgt[None, :, :], axis=-1)
    nearest = d.min(axis=1)
    inlier = nearest <= threshold
    rmse = float(np.sqrt((nearest[inlier] ** 2).mean())) if inlier.any() \
        else 0.0
    return rmse, float(inlier.mean())


def _pc(points, cols=None):
    pts = torch.as_tensor(np.asarray(points, np.float32))
    return PointCloud(pts, torch.zeros_like(pts) if cols is None
                      else torch.as_tensor(cols),
                      torch.ones(len(pts), dtype=torch.bool))


def test_golden_evaluate_transform_matches_numpy():
    rng = np.random.default_rng(0)
    for trial in range(5):
        src = rng.normal(size=(80, 3)).astype(np.float32)
        tgt = rng.normal(size=(100, 3)).astype(np.float32)
        tgt[:40] = src[:40] + rng.normal(scale=0.005, size=(40, 3))
        ref_rmse, ref_fit = _np_evaluate_registration(src, tgt, 0.02,
                                                      np.eye(4))
        rmse, fit = registration.evaluate_transform(_pc(src), _pc(tgt),
                                                    np.eye(4), 0.02)
        assert abs(fit - ref_fit) < 1e-6, trial
        assert abs(rmse - ref_rmse) < 1e-5, trial


@pytest.mark.parametrize("delta,thr,want_fit,want_rmse",
                         [(0.010, 0.02, 1.0, 0.010), (0.019, 0.02, 1.0, 0.019),
                          (0.021, 0.02, 0.0, 0.0)])
def test_golden_analytic(delta, thr, want_fit, want_rmse):
    g = np.stack(np.meshgrid(np.arange(5), np.arange(5), np.arange(2),
                             indexing="ij"), -1).reshape(-1, 3) * 0.1
    g = g.astype(np.float32)
    tgt = g + np.array([delta, 0, 0], np.float32)
    rmse, fit = registration.evaluate_transform(_pc(g), _pc(tgt), np.eye(4),
                                                threshold=thr)
    assert abs(fit - want_fit) < 1e-6
    assert abs(rmse - want_rmse) < 1e-5


def test_golden_pipeline_recovers_known_transform():
    rng = np.random.default_rng(3)
    pts = np.concatenate([
        rng.normal(size=(150, 3)) * 0.12 + np.array([0.5, 0, 0]),
        rng.normal(size=(150, 3)) * 0.08 + np.array([-0.4, 0.3, 0.2]),
        rng.normal(size=(100, 3)) * 0.05 + np.array([0, -0.4, 0.5]),
        np.concatenate([rng.uniform(-0.5, 0.5, size=(100, 2)),
                        np.zeros((100, 1))], axis=1),
    ]).astype(np.float32)
    cols = rng.uniform(0, 1, size=pts.shape).astype(np.float32)
    angle = 0.4
    R = np.array([[np.cos(angle), -np.sin(angle), 0],
                  [np.sin(angle), np.cos(angle), 0],
                  [0, 0, 1]], np.float32)
    t = np.array([0.3, -0.2, 0.15], np.float32)
    T, rmse, fitness = registration.register_point_clouds(
        _pc(pts, cols), _pc(pts @ R.T + t, cols), voxel_size=0.05,
        global_dist_factor=1.5, local_dist_factor=1.5, num_hypotheses=256)
    assert fitness > 0.95, fitness
    assert rmse < 0.02, rmse
    np.testing.assert_allclose(T[:3, :3], R, atol=0.03)
    np.testing.assert_allclose(T[:3, 3], t, atol=0.03)
