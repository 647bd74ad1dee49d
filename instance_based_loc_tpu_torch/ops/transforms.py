"""Pose / quaternion maths (counterpart of
`instance_based_loc_tpu/ops/transforms.py`).

Conventions, kept from the reference:

* Poses are 7-vectors ``[x, y, z, qx, qy, qz, qw]`` (scipy "xyzw" order).
* ``transform_points`` applies ``(R @ P.T).T + t``.
* ``transform_points_kinect`` pre-rotates by euler ``[0, pi, 0]`` and
  *subtracts* t (the TUM Kinect frame fix).
* ``quaternion_error`` unpacks its 4-vectors as ``w, x, y, z`` (the
  reference's component-order quirk), so callers passing xyzw get the same
  numbers the reference trial scripts got.
"""

from __future__ import annotations

import functools
import math

import torch


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor, made once per type and device, so a
    captured program copies nothing from the host."""
    return torch.tensor(values, dtype=dtype, device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_xyzw_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from an xyzw quaternion (scipy's convention)."""
    q = quat_normalize(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat_xyzw(m: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion from a rotation matrix (scipy's up to sign);
    branch-free Shepperd-style construction."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    t0 = 1.0 + m00 + m11 + m22
    t1 = 1.0 + m00 - m11 - m22
    t2 = 1.0 - m00 + m11 - m22
    t3 = 1.0 - m00 - m11 + m22
    # each candidate is (x, y, z, w) times a positive factor; the
    # best-conditioned one, normalised, is the exact quaternion
    cand_w = torch.stack([m21 - m12, m02 - m20, m10 - m01, t0], dim=-1)
    cand_x = torch.stack([t1, m01 + m10, m02 + m20, m21 - m12], dim=-1)
    cand_y = torch.stack([m01 + m10, t2, m12 + m21, m02 - m20], dim=-1)
    cand_z = torch.stack([m02 + m20, m12 + m21, t3, m10 - m01], dim=-1)
    choice = torch.argmax(torch.stack([t1, t2, t3, t0], dim=-1), dim=-1)
    cands = torch.stack([cand_x, cand_y, cand_z, cand_w], dim=-2)
    idx = choice[..., None, None].expand(choice.shape + (1, 4))
    q = torch.gather(cands, -2, idx).squeeze(-2)
    return quat_normalize(q)


def euler_xyz_to_rotmat(euler: torch.Tensor,
                        degrees: bool = False) -> torch.Tensor:
    """Extrinsic xyz euler angles (radians, or degrees) -> rotation matrix
    (scipy `from_euler('xyz', e)`: R = Rz @ Ry @ Rx)."""
    if degrees:
        euler = euler * (math.pi / 180.0)
    cx, cy, cz = (torch.cos(euler[..., i]) for i in range(3))
    sx, sy, sz = (torch.sin(euler[..., i]) for i in range(3))
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    shape = euler.shape[:-1] + (3, 3)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx],
                     dim=-1).reshape(shape)
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy],
                     dim=-1).reshape(shape)
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one],
                     dim=-1).reshape(shape)
    return rz @ ry @ rx


def euler_xyz_to_quat_xyzw(euler: torch.Tensor,
                           degrees: bool = False) -> torch.Tensor:
    return rotmat_to_quat_xyzw(euler_xyz_to_rotmat(euler, degrees=degrees))


def transform_points(points: torch.Tensor, pose7: torch.Tensor) -> torch.Tensor:
    """Apply pose [t(3), q_xyzw(4)]: ``(R @ P.T).T + t``."""
    r = quat_xyzw_to_rotmat(pose7[3:])
    return points @ r.T + pose7[:3]


def transform_points_kinect(points: torch.Tensor,
                            pose7: torch.Tensor) -> torch.Tensor:
    """TUM Kinect-frame variant: pre-rotate by euler [0, pi, 0], negate t."""
    r = quat_xyzw_to_rotmat(pose7[3:])
    r2 = euler_xyz_to_rotmat(_constant((0.0, math.pi, 0.0), torch.float32,
                                       pose7.device))
    return points @ (r @ r2).T - pose7[:3]


def transform_pointcloud(cloud, pose7: torch.Tensor):
    """`PointCloud` version of `transform_points` (mask and colors pass
    through)."""
    from .pointcloud import PointCloud
    return PointCloud(transform_points(cloud.points, pose7), cloud.colors,
                      cloud.mask)


def transform_pointcloud_kinect(cloud, pose7: torch.Tensor):
    from .pointcloud import PointCloud
    return PointCloud(transform_points_kinect(cloud.points, pose7),
                      cloud.colors, cloud.mask)


def decompose_pose_matrix(pose_matrix: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous matrix -> 7-vector [t, q_xyzw]."""
    return torch.cat([pose_matrix[:3, 3],
                      rotmat_to_quat_xyzw(pose_matrix[:3, :3])])


def compose_pose_matrix(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    m = torch.eye(4, dtype=r.dtype, device=r.device)
    m[:3, :3] = r
    m[:3, 3] = t
    return m


def quaternion_multiply_wxyz(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quaternion_conjugate_wxyz(q: torch.Tensor) -> torch.Tensor:
    return q * _constant((1.0, -1.0, -1.0, -1.0), q.dtype, q.device)


def quaternion_error(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between two quaternions exactly as the reference
    computes it: min over q2 / -q2 of |atan2(|vec(dq)|, scalar(dq))| with
    wxyz unpack order."""
    q_del = quaternion_multiply_wxyz(quaternion_conjugate_wxyz(q1), q2)
    q_del_neg = quaternion_multiply_wxyz(quaternion_conjugate_wxyz(q1), -q2)
    a = torch.abs(torch.atan2(torch.linalg.norm(q_del[..., 1:], dim=-1),
                              q_del[..., 0]))
    b = torch.abs(torch.atan2(torch.linalg.norm(q_del_neg[..., 1:], dim=-1),
                              q_del_neg[..., 0]))
    return torch.minimum(a, b)
