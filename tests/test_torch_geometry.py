"""The port's geometry ops against the JAX package's, one parametrised test.

Inputs are made with numpy from a seed and go through both functions.
Where the JAX function draws random numbers (RANSAC), the test draws them
with JAX and feeds the same draws to the port. Tolerances (stated per case):
fp32 ops that repeat the reference's arithmetic in another order get
1e-5..1e-4; iterated solvers (ICP, RANSAC's Kabsch) 1e-4 on transforms;
integer outputs (indices, labels, counts) must be equal.
"""

import zlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from instance_based_loc_tpu.ops import (
    backprojection as jbp, clustering as jcl, distance as jdist,
    eigen3 as jeig, fpfh as jfpfh, icp as jicp, kabsch as jkab,
    normals as jnorm, outliers as jout, pointcloud as jpc, ransac as jran,
    transforms as jtf, voxel as jvox)
from instance_based_loc_tpu_torch.ops import (
    backprojection, clustering, distance, eigen3, fpfh, icp, kabsch, normals,
    outliers, pointcloud, ransac, transforms, voxel)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return np.asarray(jtf.quat_xyzw_to_rotmat(jnp.asarray(q, jnp.float32)))


def _surface_points(rng, n=160):
    """Points on two patches of a box-like surface, with slight noise."""
    a = rng.uniform(-0.3, 0.3, size=(n // 2, 2))
    top = np.stack([a[:, 0], np.full(n // 2, 0.3), a[:, 1]], -1)
    b = rng.uniform(-0.3, 0.3, size=(n - n // 2, 2))
    side = np.stack([np.full(n - n // 2, 0.3), b[:, 0], b[:, 1]], -1)
    pts = np.concatenate([top, side]) + 0.002 * rng.normal(size=(n, 3))
    return (pts + np.array([0.2, -0.1, 1.5])).astype(np.float32)


def case_transforms(rng):
    q = rng.normal(size=(6, 4)).astype(np.float32)
    q2 = rng.normal(size=(6, 4)).astype(np.float32)
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    pose = np.concatenate([rng.normal(size=3), q[0]]).astype(np.float32)
    r = jtf.quat_xyzw_to_rotmat(_j(q))
    pairs = [
        (r, transforms.quat_xyzw_to_rotmat(_t(q))),
        (jtf.rotmat_to_quat_xyzw(r),
         transforms.rotmat_to_quat_xyzw(_t(np.asarray(r)))),
        (jtf.quaternion_error(_j(q), _j(q2)),
         transforms.quaternion_error(_t(q), _t(q2))),
        (jtf.transform_points(_j(pts), _j(pose)),
         transforms.transform_points(_t(pts), _t(pose))),
        (jtf.transform_points_kinect(_j(pts), _j(pose)),
         transforms.transform_points_kinect(_t(pts), _t(pose))),
    ]
    return [(np.asarray(a), b.numpy(), 1e-5) for a, b in pairs]


def case_pose_helpers(rng):
    euler = rng.uniform(-3, 3, size=(5, 3)).astype(np.float32)
    deg = np.degrees(euler).astype(np.float32)
    pts = rng.normal(size=(30, 3)).astype(np.float32)
    cols = rng.uniform(size=(30, 3)).astype(np.float32)
    mask = rng.uniform(size=30) < 0.7
    q = rng.normal(size=4).astype(np.float32)
    pose = np.concatenate([rng.normal(size=3), q / np.linalg.norm(q)]
                          ).astype(np.float32)
    jc = jpc.PointCloud(_j(pts), _j(cols), _j(mask))
    tc = pointcloud.PointCloud(_t(pts), _t(cols), _t(mask))
    r = np.asarray(jtf.quat_xyzw_to_rotmat(_j(pose[3:])))
    m = np.asarray(jtf.compose_pose_matrix(_j(r), _j(pose[:3])))
    out = [(jtf.euler_xyz_to_quat_xyzw(_j(euler)),
            transforms.euler_xyz_to_quat_xyzw(_t(euler)), 1e-5),
           (jtf.euler_xyz_to_quat_xyzw(_j(deg), degrees=True),
            transforms.euler_xyz_to_quat_xyzw(_t(deg), degrees=True), 1e-5),
           (m, transforms.compose_pose_matrix(_t(r), _t(pose[:3])), 0),
           (jtf.decompose_pose_matrix(_j(m)),
            transforms.decompose_pose_matrix(_t(m)), 1e-6)]
    for jfn, tfn in ((jtf.transform_pointcloud, transforms.transform_pointcloud),
                     (jtf.transform_pointcloud_kinect,
                      transforms.transform_pointcloud_kinect)):
        a, b = jfn(jc, _j(pose)), tfn(tc, _t(pose))
        out += [(a.points, b.points, 1e-5), (a.colors, b.colors, 0),
                (a.mask, b.mask, 0)]
    return [(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b,
             tol) for a, b, tol in out]


def case_kabsch_helpers(rng):
    p = rng.normal(size=(40, 3)).astype(np.float32)
    q = (p @ _random_rotation(rng).T + rng.normal(size=3)
         + 0.01 * rng.normal(size=p.shape)).astype(np.float32)
    mask = rng.uniform(size=40) < 0.6
    # the masked solve: float64 here, fp32 in JAX
    return [(jkab.kabsch_masked(_j(p), _j(q), _j(mask)),
             kabsch.kabsch_masked(_t(p), _t(q), _t(mask)).numpy(), 1e-4),
            (jkab.kabsch_numpy(p[:5], q[:5]), kabsch.kabsch_numpy(p[:5], q[:5]),
             0)]


def case_distance_helpers(rng):
    a = rng.normal(size=(20, 5)).astype(np.float32)
    b = rng.normal(size=(30, 5)).astype(np.float32)
    c = rng.normal(size=(5, 7)).astype(np.float32)
    return [(np.asarray(jdist.gram(_j(a), _j(b))),
             distance.gram(_t(a), _t(b)).numpy(), 1e-5),
            (np.asarray(jdist.matmul_hp(_j(a), _j(c))),
             distance.matmul_hp(_t(a), _t(c)).numpy(), 1e-5)]


def case_depth_clouds(rng):
    depth = rng.uniform(0.5, 1.5, size=(24, 32)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    rgb = rng.integers(0, 256, size=(24, 32, 3), dtype=np.uint8)
    masks = rng.uniform(size=(3, 24, 32)) < 0.5
    cfg = {"radius": 0.05, "radius_nb_points": 4}
    out = []
    for kw in ({}, {"rgb": rgb}, {"outlier_removal_config": None},
               {"rgb": rgb, "outlier_removal_config": cfg}):
        a = jbp.pointcloud_from_depth(_j(depth), 200.0, 180.0, **kw)
        b = backprojection.pointcloud_from_depth(depth, 200.0, 180.0,
                                                 device="cpu", **kw)
        out += [(a.points, b.points, 1e-5), (a.colors, b.colors, 1e-6),
                (a.mask, b.mask, 0)]
    for removal in (True, False):
        a = jbp.mask_pointclouds_from_depth(
            _j(depth), _j(rgb), _j(masks), jnp.float32(200.0),
            jnp.float32(180.0), apply_outlier_removal=removal, radius=0.05,
            radius_nb_points=4)
        b = backprojection.mask_pointclouds_from_depth(
            _t(depth), _t(rgb), _t(masks), 200.0, 180.0,
            apply_outlier_removal=removal, radius=0.05, radius_nb_points=4)
        out += [(a.points, b.points, 1e-5), (a.colors, b.colors, 1e-6),
                (a.mask, b.mask, 0)]
    assert 0 < int(b.mask.sum()) < b.mask.numel()
    pts = np.concatenate([rng.normal(size=(150, 3)) * 0.05,
                          rng.uniform(-1, 1, size=(50, 3))]).astype(np.float32)
    mask = rng.uniform(size=200) < 0.9
    jc = jpc.PointCloud(_j(pts), _j(pts), _j(mask))
    tc = pointcloud.PointCloud(_t(pts), _t(pts), _t(mask))
    for a, b in ((jout.remove_radius_outliers(jc, 0.05, 6),
                  outliers.remove_radius_outliers(tc, 0.05, 6)),
                 (jout.remove_radius_outliers(jc, config=cfg),
                  outliers.remove_radius_outliers(tc, config=cfg))):
        out += [(a.points, b.points, 0), (a.mask, b.mask, 0)]
    return [(np.asarray(a), b.numpy(), tol) for a, b, tol in out]


def case_backprojection(rng):
    depth = rng.uniform(0.5, 4.0, size=(24, 32)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    jp, jv = jbp.backproject(_j(depth), jnp.float32(200.0), jnp.float32(180.0))
    tp, tv = backprojection.backproject(_t(depth), 200.0, 180.0)
    return [(np.asarray(jp), tp.numpy(), 1e-5),
            (np.asarray(jv), tv.numpy(), 0)]


def case_outliers(rng):
    pts = np.concatenate([rng.normal(size=(150, 3)) * 0.05,
                          rng.uniform(-1, 1, size=(50, 3))]).astype(np.float32)
    masks = rng.uniform(size=(3, 200)) < 0.8
    out = outliers.radius_outlier_keep_mask(_t(pts), _t(masks), 0.05, 6)
    ref = np.stack([np.asarray(jout.radius_outlier_keep_mask(
        _j(pts), _j(m), 0.05, 6)) for m in masks])
    return [(ref, out.numpy(), 0)]


def case_pointcloud(rng):
    values = rng.normal(size=(4, 50, 3)).astype(np.float32)
    mask = rng.uniform(size=(4, 50)) < 0.5
    mask[0] = False                      # an empty cloud gives zeros
    ref = np.stack([np.asarray(jpc.masked_mean(_j(v), _j(m)))
                    for v, m in zip(values, mask)])
    out = pointcloud.masked_mean(_t(values), _t(mask)).numpy()
    pows = [(jpc.round_up_pow2(n, minimum=m), pointcloud.round_up_pow2(n, m))
            for n in (0, 1, 7, 8, 9, 1000) for m in (1, 4, 8)]
    return [(ref, out, 1e-6), (np.array([a for a, _ in pows]),
                               np.array([b for _, b in pows]), 0)]


def case_distance(rng):
    a = rng.normal(size=(40, 3)).astype(np.float32)
    b = rng.normal(size=(50, 3)).astype(np.float32)
    bm = rng.uniform(size=50) < 0.7
    ji, jd = jdist.masked_nearest(_j(a), _j(b), _j(bm))
    ti, td = distance.masked_nearest(_t(a), _t(b), _t(bm))
    return [(np.asarray(jdist.pairwise_sq_dists(_j(a), _j(b))),
             distance.pairwise_sq_dists(_t(a), _t(b)).numpy(), 1e-5),
            (np.asarray(ji), ti.numpy(), 0), (np.asarray(jd), td.numpy(), 1e-5)]


def case_eigen3(rng):
    a = rng.normal(size=(64, 3, 3)).astype(np.float32)
    sym = a @ np.swapaxes(a, -1, -2)
    jw, jv = jax.jit(jeig.eigh3x3)(_j(sym))
    tw, tv = eigen3.eigh3x3(_t(sym))
    # eigenvectors up to sign: |<v_jax, v_port>| per column
    dots = np.abs(np.sum(np.asarray(jv) * tv.numpy(), axis=-2))
    ju, js, jvt = jax.jit(jeig.svd3x3)(_j(a))
    tu, ts, tvt = eigen3.svd3x3(_t(a))
    recon = (tu * ts[..., None, :]) @ tvt
    return [(np.asarray(jw), tw.numpy(), 1e-4), (np.ones_like(dots), dots, 1e-4),
            (np.asarray(js), ts.numpy(), 1e-4), (a, recon.numpy(), 1e-4)]


def case_kabsch(rng):
    p = rng.normal(size=(4, 30, 3)).astype(np.float32)
    r = np.stack([_random_rotation(rng) for _ in range(4)])
    q = (p @ np.swapaxes(r, -1, -2) + rng.normal(size=(4, 1, 3))
         + 0.01 * rng.normal(size=p.shape)).astype(np.float32)
    w = rng.uniform(size=(4, 30)).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(jkab.kabsch_transform))(
        _j(p), _j(q), _j(w)))
    out = kabsch.kabsch_transform(_t(p), _t(q), _t(w))
    return [(ref, out.numpy(), 1e-4),
            (np.asarray(jkab.apply_transform(_j(p[0]), _j(ref[0]))),
             kabsch.apply_transform(_t(p[0]), _t(ref[0])).numpy(), 1e-5)]


def case_kabsch_fp32(rng):
    # the port's solve in fp32 (`kabsch_transform` solves in float64) is the
    # reference's fp32 solve: same maths, same type
    p = rng.normal(size=(4, 30, 3)).astype(np.float32)
    r = np.stack([_random_rotation(rng) for _ in range(4)])
    q = (p @ np.swapaxes(r, -1, -2) + rng.normal(size=(4, 1, 3))
         + 0.01 * rng.normal(size=p.shape)).astype(np.float32)
    w = rng.uniform(size=(4, 30)).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(jkab.kabsch_transform))(
        _j(p), _j(q), _j(w)))
    out = kabsch.kabsch_solve(_t(p), _t(q), _t(w))
    assert out.dtype == torch.float32
    return [(ref, out.numpy(), 1e-5)]


def case_normals(rng):
    # 400 points: every radius-0.1 neighbourhood is a well-spread planar
    # patch. Three nearly collinear neighbours leave the normal
    # ill-conditioned: there the JAX package's own jitted and eager runs
    # differ by 1.6e-2.
    pts = _surface_points(rng, 400)
    mask = rng.uniform(size=len(pts)) < 0.9
    ref = jnorm.estimate_normals(_j(pts), _j(mask), 0.1, max_nn=30)
    out = normals.estimate_normals(_t(pts), _t(mask), 0.1, max_nn=30)
    return [(np.asarray(ref), out.numpy(), 1e-4)]


def case_fpfh(rng):
    pts = _surface_points(rng)
    mask = rng.uniform(size=len(pts)) < 0.9
    nrm = np.asarray(jnorm.estimate_normals(_j(pts), _j(mask), 0.1, max_nn=30))
    # against the JAX function run op by op: XLA's fused program rounds
    # differently, and a rounding that flips PCL's swap rule (|n_s.d| vs
    # |n_t.d|, near-equal on a plane) moves histogram mass, so the JAX
    # package's own jitted and eager FPFH differ by up to 0.15 here
    with jax.disable_jit():
        ref = jfpfh.compute_fpfh(_j(pts), _j(nrm), _j(mask), 0.25, max_nn=50)
    out = fpfh.compute_fpfh(_t(pts), _t(nrm), _t(mask), 0.25, max_nn=50)
    return [(np.asarray(ref), out.numpy(), 1e-4)]


def _registration_pair(rng):
    src = _surface_points(rng, 200)
    ang = 0.2   # a yaw and a shift inside ICP's basin
    r = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    tgt = (src @ r.T + np.array([0.05, -0.03, 0.04])
           + 0.002 * rng.normal(size=src.shape)).astype(np.float32)
    sm = rng.uniform(size=len(src)) < 0.95
    tm = rng.uniform(size=len(tgt)) < 0.95
    cols = rng.uniform(size=src.shape).astype(np.float32)
    return src, sm, tgt, tm, cols


def case_icp(rng):
    src, sm, tgt, tm, cols = _registration_pair(rng)
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.02, 0.0, 0.01]
    out = []
    for early in (False, True):
        jT, jf, jr = jicp.icp(_j(src), _j(sm), _j(tgt), _j(tm), 0.1,
                              init_transform=_j(init), src_colors=_j(cols),
                              tgt_colors=_j(cols), max_iterations=10,
                              use_colors=True, early_exit=early)
        tT, tf, tr = icp.icp(_t(src), _t(sm), _t(tgt), _t(tm), 0.1,
                             init_transform=_t(init), src_colors=_t(cols),
                             tgt_colors=_t(cols), max_iterations=10,
                             use_colors=True, early_exit=early)
        out += [(np.asarray(jT), tT.numpy(), 1e-4),
                (np.asarray(jf), tf.numpy(), 1e-5),
                (np.asarray(jr), tr.numpy(), 1e-5)]
    sched = [0.2] * 4 + [0.05] * 5
    jT, jf, jr = jicp.icp_scheduled(_j(src), _j(sm), _j(tgt), _j(tm),
                                    jnp.asarray(sched, jnp.float32),
                                    init_transform=_j(init))
    tT, tf, tr = icp.icp_scheduled(_t(src), _t(sm), _t(tgt), _t(tm), sched,
                                   init_transform=_t(init))
    return out + [(np.asarray(jT), tT.numpy(), 1e-4),
                  (np.asarray(jf), tf.numpy(), 1e-5),
                  (np.asarray(jr), tr.numpy(), 1e-5)]


def case_ransac(rng):
    src, sm, tgt, tm, _ = _registration_pair(rng)
    sn = jnorm.estimate_normals(_j(src), _j(sm), 0.1, max_nn=30)
    tn = jnorm.estimate_normals(_j(tgt), _j(tm), 0.1, max_nn=30)
    sf = np.asarray(jfpfh.compute_fpfh(_j(src), sn, _j(sm), 0.25, max_nn=50))
    tf = np.asarray(jfpfh.compute_fpfh(_j(tgt), tn, _j(tm), 0.25, max_nn=50))
    ji, jv = jran.feature_correspondences(_j(sf), _j(sm), _j(tf), _j(tm))
    ti, tv = ransac.feature_correspondences(_t(sf), _t(sm), _t(tf), _t(tm))
    key, hyp = jax.random.PRNGKey(3), 256
    jT, jfit, jrmse = jran.ransac_registration(
        _j(src), _j(sm), _j(tgt), ji, jv, 0.1, key, num_hypotheses=hyp)
    # the reference's own draws (ransac.py:63-65), fed to the port
    probs = jv.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    samples = jax.random.choice(key, len(src), shape=(hyp, 3), p=probs)
    tT, tfit, trmse = ransac.ransac_registration(
        _t(src), _t(sm), _t(tgt), _t(ji), _t(jv), 0.1,
        samples=_t(samples).long())
    return [(np.asarray(ji), ti.numpy(), 0), (np.asarray(jv), tv.numpy(), 0),
            (np.asarray(jT), tT.numpy(), 1e-4),
            (np.asarray(jfit), tfit.numpy(), 1e-5),
            (np.asarray(jrmse), trmse.numpy(), 1e-5)]


def _voxel_pair(monkeypatch, pts, cols, size):
    # the JAX package's exact numpy path (its compiled helper switched off)
    from instance_based_loc_tpu.ops import native
    monkeypatch.setattr(native, "voxel_downsample_native",
                        lambda *a, **k: None)
    jp, jc = jvox.voxel_downsample_numpy(pts, cols, size)
    tp, tc = voxel.voxel_downsample_numpy(pts, cols, size)
    return [(jp, tp, 0), (jc, tc, 0)]


def case_voxel(rng, monkeypatch):
    pts = rng.uniform(-1, 1, size=(3000, 3)).astype(np.float32)
    cols = rng.uniform(size=(3000, 3)).astype(np.float32)
    return _voxel_pair(monkeypatch, pts, cols, 0.1)


def case_voxel_negative(rng, monkeypatch):
    # every coordinate below zero, keys down to -250, and keys of mixed sign
    pts = rng.uniform(-5, -0.01, size=(4000, 3)).astype(np.float32)
    mixed = rng.uniform(-0.3, 0.3, size=(2000, 3)).astype(np.float32)
    cols = rng.uniform(size=(6000, 3)).astype(np.float32)
    return (_voxel_pair(monkeypatch, pts, cols[:4000], 0.02)
            + _voxel_pair(monkeypatch, mixed, cols[4000:], 0.05))


def case_voxel_large(rng, monkeypatch):
    # a cascade-sized object: 300 k points, many per voxel, in input order
    pts = rng.normal(scale=0.4, size=(300_000, 3)).astype(np.float32)
    cols = rng.uniform(size=(300_000, 3)).astype(np.float32)
    return _voxel_pair(monkeypatch, pts, cols, 0.02)


def case_voxel_huge_extent(rng, monkeypatch):
    # a span product past int64 (1e12 keys per axis): the row-wise path
    pts = np.concatenate([rng.uniform(-1e6, 1e6, size=(500, 3)),
                          rng.uniform(0, 1e-5, size=(500, 3))]
                         ).astype(np.float32)
    cols = rng.uniform(size=(1000, 3)).astype(np.float32)
    keys = np.floor(pts / np.float32(1e-6)).astype(np.int64)
    span = [int(x) for x in keys.max(0) - keys.min(0) + 1]
    assert span[0] * span[1] * span[2] > np.iinfo(np.int64).max
    return _voxel_pair(monkeypatch, pts, cols, 1e-6)


def case_dbscan(rng):
    centers = rng.uniform(-2, 2, size=(5, 3))
    pts = np.concatenate([c + 0.15 * rng.normal(size=(300, 3))
                          for c in centers]
                         + [rng.uniform(-3, 3, size=(200, 3))])
    out = []
    for eps, min_points in ((0.1, 5), (0.2, 12), (0.3, 40)):
        ref = jcl.dbscan(pts, eps, min_points, prefer_native=False)
        out.append((ref, clustering.dbscan(pts, eps, min_points), 0))
    # the same surface seen by several overlapping objects (the cascade's
    # many detections): dense sub-cells, plus scattered border and noise
    grid = np.stack(np.meshgrid(np.arange(12), np.arange(12), indexing="ij"),
                    -1).reshape(-1, 2) * 0.02
    surface = np.concatenate([grid, np.zeros((len(grid), 1))], 1)
    dense = np.concatenate([surface + 0.004 * rng.normal(size=surface.shape)
                            for _ in range(8)]
                           + [rng.uniform(-0.3, 0.5, size=(150, 3))])
    for eps, min_points in ((0.05, 40), (0.1, 200)):
        ref = jcl.dbscan(dense, eps, min_points, prefer_native=False)
        out.append((ref, clustering.dbscan(dense, eps, min_points), 0))
    # clusters on a 2 cm lattice in float32 (equal distances, ties at eps)
    quant = (np.round(pts[::3] / 0.02) * 0.02).astype(np.float32)
    for eps, min_points in ((0.02, 3), (0.1, 20)):
        ref = jcl.dbscan(quant, eps, min_points, prefer_native=False)
        out.append((ref, clustering.dbscan(quant, eps, min_points), 0))
    # several small surfaces, each seen 1-12 times, and noise: core
    # sub-cells next to sparse ones, so representatives and block searches
    # both join clusters
    parts = []
    for _ in range(3):
        side = rng.uniform(0.1, 0.3, size=2)
        g = np.stack(np.meshgrid(np.arange(0, side[0], 0.02),
                                 np.arange(0, side[1], 0.02), indexing="ij"),
                     -1).reshape(-1, 2)
        g = np.concatenate([g, np.zeros((len(g), 1))], 1) \
            + rng.uniform(-0.5, 0.5, size=3)
        parts += [g + rng.normal(scale=0.004, size=g.shape)
                  for _ in range(rng.integers(1, 13))]
    surf = np.concatenate(parts + [rng.uniform(-1, 1, size=(200, 3))])
    for eps, min_points in ((0.03, 10), (0.05, 30), (0.1, 55)):
        ref = jcl.dbscan(surf, eps, min_points, prefer_native=False)
        out.append((ref, clustering.dbscan(surf, eps, min_points), 0))
    return out


def case_agglomerative(rng):
    # embeddings in a few groups (cosine distances, as the memory's
    # reclustering builds them) and a random symmetric matrix, both
    # linkages, thresholds that merge some and not all
    embs = np.concatenate([c + 0.3 * rng.normal(size=(12, 8))
                           for c in rng.normal(size=(4, 8))])
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    cos = 1.0 - embs @ embs.T
    noise = rng.uniform(size=(30, 30))
    noise = (noise + noise.T) / 2
    np.fill_diagonal(noise, 0.0)
    out = []
    for dist in (cos, noise):
        for linkage in ("average", "complete"):
            for thr in (0.2, 0.5, 0.9):
                ref = jcl.agglomerative_precomputed(dist, thr, linkage)
                got = clustering.agglomerative_precomputed(dist, thr, linkage)
                out.append((ref, got, 0))
    assert len(np.unique(out[1][0])) not in (1, len(embs))
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_geometry_op_matches_jax(name, monkeypatch):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    fn = CASES[name]
    args = (rng, monkeypatch) if name.startswith("voxel") else (rng,)
    for i, (ref, out, atol) in enumerate(fn(*args)):
        ref, out = np.asarray(ref), np.asarray(out)
        assert ref.shape == out.shape, (name, i, ref.shape, out.shape)
        if atol == 0:
            np.testing.assert_array_equal(out, ref, err_msg=f"{name}[{i}]")
        else:
            np.testing.assert_allclose(out, ref, atol=atol, rtol=0,
                                       err_msg=f"{name}[{i}]")
