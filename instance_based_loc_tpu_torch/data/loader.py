"""One parameterised RGB-D dataset loader for the five reference dataset
conventions (counterpart of `instance_based_loc_tpu/data/loader.py`):

| convention | poses | depth | pose quirks | map build |
|---|---|---|---|---|
| synth  | poses.json, euler degrees | .npy, /1 | - | every frame |
| tum    | groundtruth.txt | 16-bit png, /5000 | R1 @ R2 Kinect fix, negated t, Kinect transform | every 50th, voxel 0.025 |
| real   | poses_odom.txt, header skipped, columns 1:-1 | png, /1000 | - | every frame |
| 8room  | one pose/ file per frame, `ast.literal_eval` | png, /1000 | rot_correction on euler x | disabled |
| hm3d   | poses.npy | .npy squeezed, /1 | pose[-2] *= -1 | every frame |

Images are PNG files read by the port's own codec (`utils/png.py`), depth
also .npy. The map cloud is built on the dataset's device (backprojection,
world transform, radius outliers one full frame at a time, the device voxel
grid) and cached as .npz.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..ops.backprojection import backproject
from ..ops.frustum import get_visible_pointcloud
from ..ops.outliers import (DEFAULT_OUTLIER_REMOVAL_CONFIG,
                            radius_outlier_keep_mask)
from ..ops.transforms import transform_points, transform_points_kinect
from ..ops.voxel import voxel_downsample
from ..utils.png import read_png


def natsort_key(s: str):
    """Natural sort key of a path's file name."""
    return [int(tok) if tok.isdigit() else tok.lower()
            for tok in re.split(r"(\d+)", os.path.basename(s))]


def _listdir_sorted(path: str) -> list[str]:
    return [os.path.join(path, f)
            for f in sorted(os.listdir(path), key=natsort_key)]


def load_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 from a PNG file; grey images are repeated to 3
    channels."""
    img = read_png(path)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


def load_depth(path: str) -> np.ndarray:
    """Raw depth as float32 (H, W) from .npy or PNG (not yet scaled by the
    convention's depth factor)."""
    if path.endswith(".npy"):
        return np.squeeze(np.load(path)).astype(np.float32)
    return read_png(path).astype(np.float32)


CONVENTIONS = {
    "synth": dict(depth_factor=1.0, kinect=False, map_every=1, map_voxel=None),
    "tum": dict(depth_factor=5000.0, kinect=True, map_every=50,
                map_voxel=0.025),
    "real": dict(depth_factor=1000.0, kinect=False, map_every=1,
                 map_voxel=None),
    "8room": dict(depth_factor=1000.0, kinect=False, map_every=1,
                  map_voxel=None, map_disabled=True),
    "hm3d": dict(depth_factor=1.0, kinect=False, map_every=1, map_voxel=None),
}


class RGBDDataset:
    """The reference's `BaseDataLoader` (base_dataloader.py:7-90) with its
    per-dataset subclasses folded into `convention`. The map cloud is a
    pair of (N, 3) float32 tensors (points, colours) on `device`."""

    def __init__(
        self,
        data_path: str,
        evaluation_indices: Optional[Sequence[int]],
        convention: str = "synth",
        focal_length_x: Optional[float] = None,
        focal_length_y: Optional[float] = None,
        map_pointcloud_cache_path: Optional[str] = None,
        start_file_index: int = 0,
        last_file_index: Optional[int] = None,
        sampling_period: int = 1,
        rot_correction: float = 0.0,
        build_map: bool = True,
        map_outlier_config: Optional[dict] = DEFAULT_OUTLIER_REMOVAL_CONFIG,
        device="cuda",
    ):
        if convention not in CONVENTIONS:
            raise ValueError(f"unknown convention {convention!r}; have "
                             f"{sorted(CONVENTIONS)}")
        self.device = resolve_device(device)
        self.convention = convention
        self.spec = CONVENTIONS[convention]
        self.data_path = data_path
        self.evaluation_indices = list(evaluation_indices or [])
        self.focal_length_x = focal_length_x
        self.focal_length_y = focal_length_y
        self.map_outlier_config = map_outlier_config
        self.depth_factor = self.spec["depth_factor"]

        self._rgb_images_paths = _listdir_sorted(os.path.join(data_path, "rgb"))
        self._depth_images_paths = _listdir_sorted(
            os.path.join(data_path, "depth"))
        if len(self._rgb_images_paths) != len(self._depth_images_paths):
            raise ValueError("No. of depth and RGB images are not the same!")

        self._poses = self._parse_poses(rot_correction)

        sl = slice(start_file_index, last_file_index, sampling_period)
        self._rgb_images_paths = self._rgb_images_paths[sl]
        self._depth_images_paths = self._depth_images_paths[sl]
        self._poses = self._poses[sl]

        self.map_pointcloud: Optional[tuple[torch.Tensor, torch.Tensor]] = None
        if build_map and not self.spec.get("map_disabled", False):
            cache = map_pointcloud_cache_path
            if cache is not None and os.path.exists(cache):
                data = np.load(cache)
                self.map_pointcloud = tuple(
                    torch.as_tensor(data[k], dtype=torch.float32,
                                    device=self.device)
                    for k in ("points", "colors"))
            else:
                self.setup_map_pointcloud()
                if cache is not None:
                    pts, cols = (x.cpu().numpy() for x in self.map_pointcloud)
                    os.makedirs(os.path.dirname(os.path.abspath(cache)),
                                exist_ok=True)
                    np.savez(cache, points=pts, colors=cols)

    # ------------------------------------------------------------------ #
    # pose parsing per convention
    # ------------------------------------------------------------------ #
    def _parse_poses(self, rot_correction: float) -> list[np.ndarray]:
        from scipy.spatial.transform import Rotation

        conv = self.convention
        poses: list[np.ndarray] = []
        if conv == "synth":
            with open(os.path.join(self.data_path, "poses.json")) as f:
                for view in json.load(f)["views"]:
                    t = np.array([view["position"]["x"], view["position"]["y"],
                                  view["position"]["z"]])
                    e = [view["rotation"]["x"], view["rotation"]["y"],
                         view["rotation"]["z"]]
                    q = Rotation.from_euler("xyz", e, degrees=True).as_quat()
                    poses.append(np.concatenate([t, q]))
        elif conv == "tum":
            r2 = Rotation.from_euler("xyz", [0, np.pi, 0]).as_matrix()
            with open(os.path.join(self.data_path, "groundtruth.txt")) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    vals = line.split()
                    # the reference reads columns [0:3] as t and [3:7] as
                    # the quaternion; Kinect frame fix: R1 @ R2, -t
                    r1 = Rotation.from_quat(
                        [float(v) for v in vals[3:7]]).as_matrix()
                    q = Rotation.from_matrix(r1 @ r2).as_quat()
                    t = -np.array([float(v) for v in vals[0:3]])
                    poses.append(np.concatenate([t, q]))
        elif conv == "real":
            with open(os.path.join(self.data_path, "poses_odom.txt")) as f:
                for line in f.readlines()[1:]:
                    vals = line.split()
                    poses.append(np.array([float(v) for v in vals[1:-1]]))
        elif conv == "8room":
            for path in _listdir_sorted(os.path.join(self.data_path, "pose")):
                with open(path) as f:
                    pose_dict = ast.literal_eval(f.read())
                t = np.array([pose_dict[0]["x"], pose_dict[0]["y"],
                              pose_dict[0]["z"]])
                e = [pose_dict[1]["x"] + rot_correction, pose_dict[1]["y"],
                     pose_dict[1]["z"]]
                q = Rotation.from_euler("xyz", e, degrees=True).as_quat()
                poses.append(np.concatenate([t, q]))
        elif conv == "hm3d":
            for pose in np.load(os.path.join(self.data_path, "poses.npy")):
                adjusted = np.array(pose, dtype=np.float64)
                adjusted[-2] *= -1   # hm3d_dataloder.py:70-75
                poses.append(adjusted)
        return poses

    # ------------------------------------------------------------------ #
    # BaseDataLoader API (base_dataloader.py:27-90)
    # ------------------------------------------------------------------ #
    @property
    def environment_indices(self) -> list[int]:
        return [i for i in range(len(self._rgb_images_paths))
                if i not in self.evaluation_indices]

    def __len__(self) -> int:
        return len(self._rgb_images_paths)

    def get_image_data(self, index: int):
        return (self._rgb_images_paths[index],
                self._depth_images_paths[index], self._poses[index])

    def load_depth_scaled(self, index: int) -> np.ndarray:
        return load_depth(self._depth_images_paths[index]) / self.depth_factor

    def setup_map_pointcloud(self) -> None:
        """Build the environment map: backproject every map_every-th
        environment frame, move it to the world, drop radius outliers,
        merge, and voxel-downsample where the convention says so
        (tum_dataloader.py:95-112)."""
        dev = self.device
        pts_acc, col_acc = [], []
        for idx in self.environment_indices[::self.spec["map_every"]]:
            rgb = load_rgb(self._rgb_images_paths[idx])
            depth = torch.as_tensor(self.load_depth_scaled(idx), device=dev)
            points, valid = backproject(depth, self.focal_length_x,
                                        self.focal_length_y)
            colors = (torch.as_tensor(rgb, device=dev).to(torch.float32)
                      / 255.0).reshape(-1, 3)
            pose = torch.as_tensor(self._poses[idx], dtype=torch.float32,
                                   device=dev)
            move = (transform_points_kinect if self.spec["kinect"]
                    else transform_points)
            p, c = move(points, pose)[valid], colors[valid]
            cfg = self.map_outlier_config
            if cfg is not None and len(p):
                keep = radius_outlier_keep_mask(
                    p, torch.ones(len(p), dtype=torch.bool, device=dev),
                    radius=cfg["radius"], nb_points=cfg["radius_nb_points"])
                p, c = p[keep], c[keep]
            pts_acc.append(p)
            col_acc.append(c)
        empty = torch.zeros((0, 3), dtype=torch.float32, device=dev)
        pts = torch.cat(pts_acc) if pts_acc else empty
        cols = torch.cat(col_acc) if col_acc else empty
        if self.spec["map_voxel"] is not None and len(pts):
            pts, cols, keep = voxel_downsample(
                pts, cols, torch.ones(len(pts), dtype=torch.bool, device=dev),
                self.spec["map_voxel"])
            pts, cols = pts[keep], cols[keep]
        self.map_pointcloud = (pts, cols)

    def get_pointcloud(self, bounding_box=None):
        """The map cloud: (points (N, 3), colors (N, 3)) tensors."""
        if bounding_box is not None:
            raise NotImplementedError
        return self.map_pointcloud

    def get_visible_pointcloud(self, pose, fov, near_clip, far_clip):
        """The map's points inside the view frustum of `pose`, in the
        camera frame: (points, colors, mask) tensors, capacity kept."""
        pts, cols = self.map_pointcloud
        return get_visible_pointcloud(
            pts, cols, torch.ones(len(pts), dtype=torch.bool,
                                  device=pts.device),
            np.asarray(pose, np.float32), fov, near_clip, far_clip)
