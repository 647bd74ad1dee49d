"""The port's 3D IoU ops (`instance_based_loc_tpu_torch/ops/iou3d.py`)
against the JAX package's, on clouds made with numpy from a seed.

Every function is held to JAX at atol 1e-5 (fp32, the same arithmetic in
another summation order): the axis-aligned IoU and strict overlap, the PCA
box (centre and extents; the axes up to each column's sign, which an
eigensolver may flip), the box volume, the exact box intersection volume,
`obb_iou`, the polygon clip, and `pairwise_obb_iou` at K = 40. The pairs
cover identical, touching, rotated, nested and disjoint boxes, and clouds
of fewer than 4 points.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from instance_based_loc_tpu.ops import iou3d as J
from instance_based_loc_tpu_torch.ops import iou3d as T

ATOL = 1e-5


def _box_cloud(rng, center, size, rot=None, n=400):
    """Points filling a box, with its 8 corners so the bounds are exact."""
    corners = np.array(np.meshgrid([-.5, .5], [-.5, .5], [-.5, .5],
                                   indexing="ij")).reshape(3, -1).T
    local = np.concatenate([corners, rng.uniform(-0.5, 0.5, (n - 8, 3))])
    local = local * np.asarray(size)
    if rot is not None:
        local = local @ rot.T
    return (local + np.asarray(center)).astype(np.float32)


def _pair(name, rng):
    rot = Rotation.from_euler("xyz", [0.4, -0.3, 0.7]).as_matrix()
    if name == "identical":
        a = _box_cloud(rng, [0.2, 0.1, -0.3], [1.0, 0.6, 0.8], rot)
        return a, a.copy()
    if name == "touching":
        return (_box_cloud(rng, [0, 0, 0], [1, 1, 1]),
                _box_cloud(rng, [1, 0, 0], [1, 1, 1]))
    if name == "rotated":
        return (_box_cloud(rng, [0, 0, 0], [1.0, 0.5, 0.7]),
                _box_cloud(rng, [0.3, 0.1, 0.0], [1.0, 0.5, 0.7], rot))
    if name == "nested":
        return (_box_cloud(rng, [0, 0, 0], [2, 1.5, 1.8]),
                _box_cloud(rng, [0.1, -0.1, 0.2], [0.5, 0.4, 0.3], rot))
    if name == "disjoint":
        return (_box_cloud(rng, [0, 0, 0], [1, 1, 1], rot),
                _box_cloud(rng, [3, 0.5, 0], [1, 1, 1]))
    if name == "few_points":
        return (_box_cloud(rng, [0, 0, 0], [1, 1, 1])[:3],
                _box_cloud(rng, [0.2, 0, 0], [1, 1, 1]))
    raise KeyError(name)


PAIRS = ["identical", "touching", "rotated", "nested", "disjoint",
         "few_points"]


def _pad(a, n=512):
    pts = np.zeros((n, 3), np.float32)
    pts[:len(a)] = a
    return pts, np.arange(n) < len(a)


def _close(out, ref, what):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=ATOL,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("name", PAIRS)
def test_iou_functions_match_jax(name):
    rng = np.random.default_rng(len(name))
    (p1, m1), (p2, m2) = (_pad(c) for c in _pair(name, rng))
    j = [jnp.asarray(x) for x in (p1, m1, p2, m2)]
    t = [torch.as_tensor(x) for x in (p1, m1, p2, m2)]
    for fn in ("aabb_iou", "strict_overlap", "obb_iou"):
        _close(getattr(T, fn)(*t), getattr(J, fn)(*j), f"{name} {fn}")

    boxes_j, boxes_t = [], []
    for pts, msk in ((j[0], j[1]), (j[2], j[3])):
        c, r, e = J.pca_obb(pts, msk)
        boxes_j.append([np.asarray(x) for x in (c, r, e)])
    for pts, msk in ((t[0], t[1]), (t[2], t[3])):
        boxes_t.append(list(T.pca_obb(pts, msk)))
    for (cj, rj, ej), (ct, rt, et) in zip(boxes_j, boxes_t):
        _close(ct, cj, f"{name} pca_obb center")
        _close(et, ej, f"{name} pca_obb extents")
        # each axis up to its sign
        sign = np.sign(np.sum(rt.numpy() * rj, axis=0))
        _close(rt.numpy() * sign, rj, f"{name} pca_obb axes")
        assert np.linalg.det(rt.numpy()) > 0          # right-handed
        _close(T.obb_volume(et), J.obb_volume(ej), f"{name} obb_volume")
    # the intersection volume from the same boxes on both sides
    (c1, r1, e1), (c2, r2, e2) = boxes_j
    ref = J.box_intersection_volume(*(jnp.asarray(x) for x in
                                      (c1, r1, e1, c2, r2, e2)))
    out = T.box_intersection_volume(*(torch.tensor(x) for x in
                                      (c1, r1, e1, c2, r2, e2)))
    _close(out, ref, f"{name} box_intersection_volume")


def test_clip_polygon_matches_jax():
    """One clip with rejected candidates (the JAX scatter drops them on one
    slot; the port gathers by prefix sums)."""
    rng = np.random.default_rng(3)
    verts = np.zeros((16, 3), np.float32)
    verts[:6] = rng.normal(size=(6, 3))
    for normal, d in ((np.array([1.0, 0.2, -0.1]), 0.1),
                      (np.array([0.0, 0.0, 1.0]), -5.0),
                      (np.array([0.0, 1.0, 0.0]), 5.0)):
        normal = normal.astype(np.float32)
        jv, jc = J._clip_polygon(jnp.asarray(verts), jnp.int32(6),
                                 jnp.asarray(normal), jnp.float32(d))
        tv, tc = T._clip_polygon(torch.as_tensor(verts), torch.tensor(6),
                                 torch.as_tensor(normal),
                                 torch.tensor(d, dtype=torch.float32))
        assert int(tc) == int(jc)
        _close(tv, jv, f"clip by {normal}, {d}")


def test_pairwise_obb_iou_matches_jax():
    rng = np.random.default_rng(40)
    k, n = 40, 256
    pts = np.zeros((k, n, 3), np.float32)
    msk = np.zeros((k, n), bool)
    for i in range(k):
        cnt = int(rng.integers(2, n)) if i % 10 else 3   # some below 4
        rot = Rotation.random(random_state=i).as_matrix()
        cloud = _box_cloud(rng, rng.uniform(-1, 1, 3), rng.uniform(0.2, 1, 3),
                           rot, n=max(cnt, 8))[:cnt]
        pts[i, :cnt] = cloud
        msk[i, :cnt] = True
    ref = np.asarray(J.pairwise_obb_iou(jnp.asarray(pts), jnp.asarray(msk)))
    # a small pair block runs several blocks and a partial last one
    out = T.pairwise_obb_iou(torch.as_tensor(pts), torch.as_tensor(msk),
                             pair_block=300).numpy()
    assert (ref > 0).sum() > 2 * k                 # overlapping pairs exist
    _close(out, ref, "pairwise_obb_iou")
    np.testing.assert_array_equal(out, out.T)
