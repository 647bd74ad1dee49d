"""Vectorised frustum culling (counterpart of
`instance_based_loc_tpu/ops/frustum.py`): move the map cloud into the
camera frame and keep the points inside the field-of-view cone between
the near and far clip planes. Points come back in the camera frame, as in
the reference."""

from __future__ import annotations

import torch

from .transforms import quat_normalize, quat_xyzw_to_rotmat


def visible_mask(points: torch.Tensor, mask: torch.Tensor,
                 pose7: torch.Tensor, fov_deg, near_clip, far_clip):
    """Returns (camera-frame points, visibility mask): p_cam = (p - t) @ R,
    visible iff near <= z <= far and |x/z|, |y/z| <= tan(fov / 2)."""
    pose7 = pose7.to(torch.float32)
    r = quat_xyzw_to_rotmat(quat_normalize(pose7[3:]))
    p_cam = (points - pose7[:3]) @ r
    x, y, z = p_cam[:, 0], p_cam[:, 1], p_cam[:, 2]
    fov = torch.tensor(fov_deg, dtype=torch.float32, device=points.device)
    tan_half = torch.tan(torch.deg2rad(fov) / 2.0)
    zsafe = torch.where(z == 0, 1e-12, z)
    ok = ((z >= near_clip) & (z <= far_clip)
          & (torch.abs(x / zsafe) <= tan_half)
          & (torch.abs(y / zsafe) <= tan_half))
    return p_cam, mask & ok


def get_visible_pointcloud(points: torch.Tensor, colors: torch.Tensor,
                           mask: torch.Tensor, pose7, fov_deg, near_clip,
                           far_clip):
    """The camera-frame visible subset of a masked cloud: returns
    (camera-frame points, colors, visibility mask), capacity kept."""
    pose7 = torch.as_tensor(pose7, dtype=torch.float32, device=points.device)
    p_cam, vis = visible_mask(points, mask, pose7, fov_deg, near_clip,
                              far_clip)
    return p_cam, colors, vis
