"""3D IoU ops (counterpart of `instance_based_loc_tpu/ops/iou3d.py`):
axis-aligned IoU and strict overlap, PCA oriented boxes, and the exact
oriented-box IoU by halfspace clipping, batched over leading dimensions in
fp32.

Oriented boxes are fitted by PCA (eigh of the covariance, the port's
closed-form `eigen3.eigh3x3`). Two boxes intersect in a polytope whose
boundary is the part of each box's faces inside the other box: every face
quad is clipped by the other box's six halfspaces (Sutherland-Hodgman in a
fixed buffer of 16 vertices) and the clipped polygons' origin tetrahedra
sum to the volume. Each clip compacts the emitted vertices by a stable
prefix-sum gather, deterministic on the card and the CPU alike.
"""

from __future__ import annotations

import numpy as np
import torch

from .eigen3 import det3x3, eigh3x3
from .pointcloud import gather_rows, masked_mean

_MAX_POLY_VERTS = 16   # a quad clipped by 6 planes has at most 10 vertices
_PAIR_BLOCK = 2048
_BIG = 1e30

# Unit-box face quads (outward, counter-clockwise) in the box's frame,
# coordinates in {-0.5, +0.5}. Faces: +x, -x, +y, -y, +z, -z.
_FACE_QUADS = np.array([
    [[+.5, -.5, -.5], [+.5, +.5, -.5], [+.5, +.5, +.5], [+.5, -.5, +.5]],
    [[-.5, -.5, -.5], [-.5, -.5, +.5], [-.5, +.5, +.5], [-.5, +.5, -.5]],
    [[-.5, +.5, -.5], [-.5, +.5, +.5], [+.5, +.5, +.5], [+.5, +.5, -.5]],
    [[-.5, -.5, -.5], [+.5, -.5, -.5], [+.5, -.5, +.5], [-.5, -.5, +.5]],
    [[-.5, -.5, +.5], [+.5, -.5, +.5], [+.5, +.5, +.5], [-.5, +.5, +.5]],
    [[-.5, -.5, -.5], [-.5, +.5, -.5], [+.5, +.5, -.5], [+.5, -.5, -.5]],
], np.float32)  # (6, 4, 3)


# --------------------------------------------------------------------------- #
# axis-aligned
# --------------------------------------------------------------------------- #
def _masked_bounds(points, mask):
    m = mask[..., None]
    mn = torch.where(m, points, _BIG).amin(dim=-2)
    mx = torch.where(m, points, -_BIG).amax(dim=-2)
    return mn, mx


def _aabb_overlap(points1, mask1, points2, mask2):
    mn1, mx1 = _masked_bounds(points1, mask1)
    mn2, mx2 = _masked_bounds(points2, mask2)
    omn = torch.maximum(mn1, mn2)
    omx = torch.minimum(mx1, mx2)
    overlap = torch.where((omn > omx).any(dim=-1), 0.0,
                          torch.prod(omx - omn, dim=-1))
    empty = (mask1.sum(-1) == 0) | (mask2.sum(-1) == 0)
    return (overlap, torch.prod(mx1 - mn1, dim=-1),
            torch.prod(mx2 - mn2, dim=-1), empty)


def aabb_iou(points1, mask1, points2, mask2):
    """IoU of the axis-aligned bounds of two masked clouds (..., N, 3)."""
    overlap, v1, v2, empty = _aabb_overlap(points1, mask1, points2, mask2)
    denom = v1 + v2 - overlap
    iou = torch.where(denom > 0, overlap / denom, 0.0)
    return torch.where(empty, 0.0, iou)


def strict_overlap(points1, mask1, points2, mask2):
    """Overlap of the axis-aligned bounds over the smaller box's volume."""
    overlap, v1, v2, empty = _aabb_overlap(points1, mask1, points2, mask2)
    denom = torch.minimum(v1, v2)
    ov = torch.where(denom > 0, overlap / denom, 0.0)
    return torch.where(empty, 0.0, ov)


# --------------------------------------------------------------------------- #
# PCA oriented bounding box
# --------------------------------------------------------------------------- #
def pca_obb(points: torch.Tensor, mask: torch.Tensor):
    """Fit an oriented box to masked clouds points (..., N, 3), mask
    (..., N): returns (center (..., 3), rot (..., 3, 3) with the axes in
    columns, extents (..., 3) full side lengths). Degenerate inputs give
    zero extents."""
    mu = masked_mean(points, mask)
    centered = (points - mu[..., None, :]) * mask[..., None]
    n = torch.clamp(mask.float().sum(-1), min=1.0)
    cov = centered.transpose(-1, -2) @ centered / n[..., None, None]
    _, vecs = eigh3x3(cov)          # columns = axes, ascending eigenvalue
    # a left-handed basis mirrors the frame and flips face orientations
    # downstream (negative clipped volumes): make it right-handed
    sign = torch.where(det3x3(vecs) < 0, -1.0, 1.0)
    vecs = torch.cat([vecs[..., :2], vecs[..., 2:] * sign[..., None, None]],
                     dim=-1)
    proj = (points - mu[..., None, :]) @ vecs
    pm = mask[..., None]
    lo = torch.where(pm, proj, _BIG).amin(dim=-2)
    hi = torch.where(pm, proj, -_BIG).amax(dim=-2)
    center = mu + (vecs @ ((lo + hi) / 2.0)[..., None])[..., 0]
    extents = torch.clamp(hi - lo, min=0.0)
    return center, vecs, extents


def obb_volume(extents):
    return torch.prod(extents, dim=-1)


# --------------------------------------------------------------------------- #
# oriented box-box intersection volume
# --------------------------------------------------------------------------- #
def _box_faces_world(center, rot, extents):
    """(..., 6, 4, 3) world-space face quads, outward counter-clockwise."""
    quads = torch.as_tensor(_FACE_QUADS, device=center.device)
    local = quads * extents[..., None, None, :]
    return (local @ rot.transpose(-1, -2)[..., None, :, :]
            + center[..., None, None, :])


def _box_halfspaces(center, rot, extents):
    """(..., 6, 3) normals and (..., 6) offsets: n.x <= d inside the box."""
    axes = rot.transpose(-1, -2)                       # rows = axes
    normals = torch.cat([axes, -axes], dim=-2)
    ac = (axes @ center[..., None])[..., 0]
    half = extents / 2.0
    return normals, torch.cat([ac + half, -ac + half], dim=-1)


def _clip_polygon(verts, count, normal, d):
    """Clip padded polygons verts (..., V, 3) with `count` (...,) valid
    vertices by n.x <= d: per edge, emit the current vertex if inside and
    the crossing point if the edge crosses, then compact the emissions to
    the front in order."""
    v_max = verts.shape[-2]
    eps = 1e-7
    idx = torch.arange(v_max, device=verts.device)
    valid = idx < count[..., None]
    nxt_idx = torch.where(idx + 1 >= count[..., None], 0, idx + 1)
    nxt = gather_rows(verts, nxt_idx)

    s_cur = (verts * normal[..., None, :]).sum(-1)
    s_nxt = (nxt * normal[..., None, :]).sum(-1)
    d = d[..., None]
    cur_in = s_cur <= d + eps
    nxt_in = s_nxt <= d + eps
    denom = s_nxt - s_cur
    t = torch.where(denom.abs() > eps, (d - s_cur) / denom, 0.0)
    inter = verts + torch.clamp(t, 0.0, 1.0)[..., None] * (nxt - verts)

    # candidates [cur_0, int_0, cur_1, int_1, ...] and their flags; slot s
    # of the output takes the flagged candidate of rank s (prefix sums)
    cand = torch.stack([verts, inter], dim=-2).flatten(-3, -2)
    flags = torch.stack([valid & cur_in, valid & (cur_in != nxt_in)],
                        dim=-1).flatten(-2)
    csum = torch.cumsum(flags.to(torch.int32), dim=-1)
    m = csum[..., -1]
    slots = torch.arange(1, 2 * v_max + 1, device=verts.device,
                         dtype=torch.int32).expand_as(csum).contiguous()
    src = torch.searchsorted(csum.contiguous(), slots).clamp(max=2 * v_max - 1)
    out = gather_rows(cand, src)
    out = torch.where((slots <= m[..., None])[..., None], out, 0.0)
    return out[..., :v_max, :], torch.clamp(m, max=v_max)


def _clipped_face_volume(quads, normals, ds):
    """Clip face quads (..., 4, 3) by six halfspaces (..., 6, 3), (..., 6);
    returns each clipped polygon's signed volume contribution (the sum of
    origin tetrahedra over its fan triangulation)."""
    lead = quads.shape[:-2]
    verts = torch.zeros(lead + (_MAX_POLY_VERTS, 3), dtype=quads.dtype,
                        device=quads.device)
    verts[..., :4, :] = quads
    count = torch.full(lead, 4, dtype=torch.int64, device=quads.device)
    for k in range(normals.shape[-2]):
        verts, count = _clip_polygon(verts, count, normals[..., k, :],
                                     ds[..., k])
    idx = torch.arange(_MAX_POLY_VERTS, device=quads.device)
    tri_valid = (idx >= 1) & (idx + 1 < count[..., None])
    b = torch.roll(verts, -1, dims=-2)
    dets = (verts[..., :1, :] * torch.linalg.cross(verts, b)).sum(-1)
    return torch.where(tri_valid, dets, 0.0).sum(-1) / 6.0


def box_intersection_volume(center1, rot1, ext1, center2, rot2, ext2):
    """Exact intersection volume of oriented boxes, batched over leading
    dimensions.

    The boundary of A∩B is (∂A ∩ B) ∪ (∂B ∩ A); where ∂A and ∂B coincide
    (identical boxes, touching axis-aligned boxes) the piece must count
    once. Coincident pieces stay on A's side: A's faces are clipped by a
    slightly grown B, B's faces by a slightly shrunk A.

    As in the JAX package, the tetrahedra reach to the world origin: each
    is of size |p|^3, so boxes a few metres out lose ~1e-6 m^3 per term in
    fp32 (IoUs move by up to ~1e-4)."""
    scale = torch.maximum(ext1.amax(-1), ext2.amax(-1)) + 1.0
    eps = (1e-5 * scale)[..., None, None]
    faces = torch.cat([_box_faces_world(center1, rot1, ext1),
                       _box_faces_world(center2, rot2, ext2)], dim=-3)
    n1, d1 = _box_halfspaces(center1, rot1, ext1)
    n2, d2 = _box_halfspaces(center2, rot2, ext2)
    # every face of one box meets the other box's six planes
    lead = n1.shape[:-2]
    normals = torch.cat([n2[..., None, :, :].expand(*lead, 6, 6, 3),
                         n1[..., None, :, :].expand(*lead, 6, 6, 3)], dim=-3)
    ds = torch.cat([d2[..., None, :].expand(*lead, 6, 6) + eps,
                    d1[..., None, :].expand(*lead, 6, 6) - eps], dim=-2)
    vol = _clipped_face_volume(faces, normals, ds).sum(-1)
    return torch.clamp(vol, min=0.0)


def _iou_from_boxes(inter, v1, v2, valid):
    denom = v1 + v2 - inter
    iou = torch.where(denom > 1e-12, inter / denom, 0.0)
    return torch.where(valid, torch.clamp(iou, 0.0, 1.0), 0.0)


def obb_iou(points1, mask1, points2, mask2):
    """Object-aligned 3D IoU of masked clouds (..., N, 3): the IoU of
    their PCA boxes; 0 where a cloud has fewer than 4 points."""
    c1, r1, e1 = pca_obb(points1, mask1)
    c2, r2, e2 = pca_obb(points2, mask2)
    inter = box_intersection_volume(c1, r1, e1, c2, r2, e2)
    valid = (mask1.sum(-1) >= 4) & (mask2.sum(-1) >= 4)
    return _iou_from_boxes(inter, obb_volume(e1), obb_volume(e2), valid)


def pairwise_obb_iou(points: torch.Tensor, masks: torch.Tensor,
                     pair_block: int = _PAIR_BLOCK) -> torch.Tensor:
    """(K, K) IoU matrix over K padded clouds (points (K, N, 3), masks
    (K, N)). Each box is fitted once; the K(K-1)/2 unique pairs run in
    blocks of `pair_block`, so memory stays bounded at any K. The diagonal
    is 1 for a cloud of >= 4 points, else 0."""
    k = points.shape[0]
    dev = points.device
    if k < 2:
        return torch.zeros((k, k), dtype=points.dtype, device=dev)
    centers, rots, exts = pca_obb(points, masks)
    vols = obb_volume(exts)
    valid = masks.sum(-1) >= 4
    iu, ju = (torch.as_tensor(x, device=dev) for x in np.triu_indices(k, 1))
    flat = []
    for s in range(0, len(iu), pair_block):
        i, j = iu[s:s + pair_block], ju[s:s + pair_block]
        inter = box_intersection_volume(centers[i], rots[i], exts[i],
                                        centers[j], rots[j], exts[j])
        flat.append(_iou_from_boxes(inter, vols[i], vols[j],
                                    valid[i] & valid[j]))
    mat = torch.zeros((k, k), dtype=points.dtype, device=dev)
    mat[iu, ju] = torch.cat(flat)
    return mat + mat.T + torch.diag(valid.to(points.dtype))
