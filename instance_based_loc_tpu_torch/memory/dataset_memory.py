"""ObjectDatasetMemory, ReID training-data collection (counterpart of
`instance_based_loc_tpu/memory/dataset_memory.py`, reference
`object_memory/data_collection.py`): an ObjectMemory that also keeps the
RGB and depth crops of every observation of an instance, and dumps them as
a dir-per-instance ReID dataset (`{name}_{id}/obs{k}_rgb.png` +
`obs{k}_depth.npy`), the layout `models.dator.data.scan_instance_dirs`
reads. This closes the loop: memory build -> ReID dataset -> DATOR
training -> a better embedder.

Its `process_image` is the JAX package's: every detection's whole cloud
(no per-detection point budget, outlier removal only when configured), in
world coordinates, kept when it has `min_points` points.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.backprojection import backproject
from ..ops.outliers import radius_outlier_keep_mask
from ..ops.transforms import transform_points, transform_points_kinect
from ..utils.png import write_png
from .object_info import ObjectInfo
from .object_memory import ObjectMemory
from .phrases import check_if_floor


class ObjectDatasetInfo(ObjectInfo):
    """ObjectInfo + per-observation RGB / depth crops
    (data_collection.py:33-56)."""

    def __init__(self, id, name, emb, cloud, max_embeddings_num,
                 rgb_crop, depth_crop):
        super().__init__(id, name, emb, cloud, max_embeddings_num)
        self.rgb_imgs: list[np.ndarray] = [np.asarray(rgb_crop)]
        self.depth_imgs: list[np.ndarray] = [np.asarray(depth_crop)]

    def __add__(self, other):
        super().__add__(other)
        self.rgb_imgs += list(getattr(other, "rgb_imgs", []))
        self.depth_imgs += list(getattr(other, "depth_imgs", []))
        return self

    def __repr__(self):
        return (f"TRAINING INFO OBJ == Names: {self.names}, "
                f"Num. Points: {self.num_points()}, "
                f"Num images: {len(self.rgb_imgs)},{len(self.depth_imgs)}")


class ObjectDatasetMemory(ObjectMemory):
    """process_image keeps crops; dump_dataset writes the ReID tree."""

    def process_image(self, rgb_image_path, depth_image_path, pose,
                      consider_floor: bool, min_points: int = 500,
                      outlier_removal_config=None, depth_factor: float = 1.0,
                      kinect_frame: bool = False, **kwargs):
        rgb, depth = self._load_images(rgb_image_path, depth_image_path,
                                       depth_factor)
        det = (self.detector.find(rgb, consider_floor, depth=depth)
               if getattr(self.detector, "wants_depth", False)
               else self.detector.find(rgb, consider_floor))
        if len(det) == 0:
            self._log("ObjectDatasetMemory.process_image found nothing")
            return
        embs = np.asarray(self.get_embeddings_func(
            detections=det, full_rgb_image=rgb, full_depth_image=depth,
            consider_floor=consider_floor))
        dev = self.device
        points, valid = backproject(torch.as_tensor(depth, device=dev),
                                    float(self.camera_focal_lenth_x),
                                    float(self.camera_focal_lenth_y))
        colors = (torch.as_tensor(np.asarray(rgb), device=dev).float()
                  / 255.0).reshape(-1, 3)
        masks = torch.as_tensor(np.asarray(det.masks), device=dev) \
            .reshape(len(det), -1).bool() & valid[None]
        cfg = outlier_removal_config
        if cfg is not None:
            masks = radius_outlier_keep_mask(points, masks, cfg["radius"],
                                             cfg["radius_nb_points"])
        pose_t = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
        world = (transform_points_kinect(points, pose_t) if kinect_frame
                 else transform_points(points, pose_t))
        world, colors, masks = (x.cpu().numpy() for x in
                                (world, colors, masks))
        for i, (phrase, emb) in enumerate(zip(det.phrases, embs)):
            keep = masks[i]
            if int(keep.sum()) < min_points:
                continue
            x1, y1, x2, y2 = det.boxes_xyxy[i].astype(int)
            depth_crop = depth[max(y1, 0):max(y2, y1 + 1),
                               max(x1, 0):max(x2, x1 + 1)]
            new_obj = ObjectDatasetInfo(
                len(self.memory), phrase, emb, (world[keep], colors[keep]),
                self.object_info_max_embeddings_num,
                rgb_crop=det.crops[i], depth_crop=depth_crop)
            if check_if_floor(new_obj.names):
                self.floors = (new_obj if self.floors is None
                               else self.floors + new_obj)
            else:
                self.memory.append(new_obj)
                self._log(f"\tObject Added: {new_obj}")
        self._invalidate_pack()

    def dump_dataset(self, save_dir: str):
        """{name}_{id}/obs{k}_rgb.png + obs{k}_depth.npy per instance
        (data_collection.py:208-225)."""
        os.makedirs(save_dir, exist_ok=True)
        for obj in self.memory:
            inst_dir = os.path.join(save_dir, f"{obj.names[0]}_{obj.id}")
            os.makedirs(inst_dir, exist_ok=True)
            for k, (rgb, dep) in enumerate(zip(obj.rgb_imgs,
                                               obj.depth_imgs)):
                write_png(os.path.join(inst_dir, f"obs{k}_rgb.png"),
                          np.asarray(rgb).astype(np.uint8))
                np.save(os.path.join(inst_dir, f"obs{k}_depth.npy"),
                        np.asarray(dep))
        self._log(f"Dumped ReID dataset to {save_dir}")
