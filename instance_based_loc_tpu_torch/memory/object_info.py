"""Per-instance record (counterpart of
`instance_based_loc_tpu/memory/object_info.py`).

Host-side container: names, exemplar embeddings (with a budget) and the
instance's point cloud as plain numpy arrays. Bookkeeping (merge, mask,
means, voxel consolidation) is small irregular work, so instance state lives
on the host; ObjectMemory packs the device tensors once per memory version.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..ops.pointcloud import PointCloud
from ..ops.voxel import voxel_downsample_numpy


def _cloud_to_numpy(cloud) -> tuple[np.ndarray, np.ndarray]:
    """Accept a PointCloud, a (points, colors) tuple or a bare points
    array; return host numpy (points, colors)."""
    if isinstance(cloud, PointCloud):
        return cloud.to_numpy()
    if isinstance(cloud, tuple):
        pts, cols = cloud
        pts = np.asarray(pts, np.float32).reshape(-1, 3)
        cols = (np.zeros_like(pts) if cols is None
                else np.asarray(cols, np.float32).reshape(-1, 3))
        return pts, cols
    pts = np.asarray(cloud, np.float32).reshape(-1, 3)
    return pts, np.zeros_like(pts)


class ObjectInfo:
    """One object instance in memory (reference object_info.py:7-118)."""

    def __init__(self, id: int, name: str, emb: np.ndarray,
                 cloud, max_embeddings_num: int = 1_000_000):
        self.id = id
        self.names: list[str] = [name]
        self.embeddings: list[np.ndarray] = [np.asarray(emb)]
        self.pts, self.cols = _cloud_to_numpy(cloud)
        self.max_embeddings_num = int(max_embeddings_num)
        self.mean_emb: np.ndarray | None = None
        self.centroid: np.ndarray | None = None
        self._compute_means()

    def __repr__(self):
        return (f"ObjectInfo == ID: {self.id}, Names: {self.names}, "
                f"Mean_Emb: {self.mean_emb.shape}, "
                f"Num. Points: {self.num_points()}")

    def cloud(self, device="cuda") -> PointCloud:
        """The instance's points as a padded PointCloud on `device` (an
        upload; host work reads .pts / .cols). The JAX package's is a
        property on its default device."""
        return PointCloud.from_numpy(self.pts, self.cols, device=device)

    def num_points(self) -> int:
        return len(self.pts)

    def points(self) -> np.ndarray:
        return self.pts

    def _add_name(self, new_name: str):
        if new_name not in self.names:
            self.names.append(new_name)

    def _add_embedding(self, new_emb: np.ndarray):
        """Budgeted exemplar set: append below budget; at budget replace the
        most redundant exemplar if the new one is more diverse."""
        new_emb = np.asarray(new_emb)
        if len(self.embeddings) < self.max_embeddings_num:
            self.embeddings.append(new_emb)
            return
        arr = np.stack(self.embeddings)
        d = np.linalg.norm(arr[:, None] - arr[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        redundancy = d.min(1)
        victim = int(np.argmin(redundancy))
        if np.linalg.norm(arr - new_emb, axis=-1).min() > redundancy[victim]:
            self.embeddings[victim] = new_emb

    def _add_embeddings(self, new_embs: list[np.ndarray]):
        self.embeddings += [np.asarray(e) for e in new_embs]

    def _add_cloud(self, new_cloud):
        p2, c2 = _cloud_to_numpy(new_cloud)
        self.pts = np.concatenate([self.pts, p2])
        self.cols = np.concatenate([self.cols, c2])

    def _compute_means(self):
        self.mean_emb = np.mean(np.stack(self.embeddings), axis=0).squeeze()
        self.centroid = self.pts.mean(0) if len(self.pts) else np.zeros(3)

    def __add__(self, other: "ObjectInfo") -> "ObjectInfo":
        """Merge `other` into self (the reference mutates self too)."""
        for name in other.names:
            self._add_name(name)
        self._add_embeddings(other.embeddings)
        self._add_cloud((other.pts, other.cols))
        self._compute_means()
        return self

    def add_info(self, new_name: str, new_emb: np.ndarray, new_cloud):
        self._add_name(new_name)
        self._add_embedding(new_emb)
        self._add_cloud(new_cloud)
        self._compute_means()

    def downsample(self, voxel_size: float):
        self.pts, self.cols = voxel_downsample_numpy(self.pts, self.cols,
                                                     voxel_size)
        self._compute_means()

    def update_pointcloud_with_mask(self, keep: np.ndarray):
        """Keep only rows where `keep` is True."""
        keep = np.asarray(keep, bool)
        self.pts = self.pts[keep]
        self.cols = self.cols[keep]
        self._compute_means()

    def save(self, save_directory: str):
        """pointcloud.ply and info.pkl (names, embeddings, budget), the JAX
        package's layout."""
        from ..utils.ply import write_ply
        os.makedirs(save_directory, exist_ok=True)
        write_ply(os.path.join(save_directory, "pointcloud.ply"),
                  self.pts, self.cols)
        with open(os.path.join(save_directory, "info.pkl"), "wb") as f:
            pickle.dump({
                "names": self.names,
                "embeddings": self.embeddings,
                "max_embeddings_num": self.max_embeddings_num,
            }, f)

    def to_tuple(self):
        """Pickle-friendly (meta, points, colors), the JAX package's format."""
        meta = {
            "id": self.id,
            "names": self.names,
            "embeddings": [np.asarray(e) for e in self.embeddings],
            "max_embeddings_num": self.max_embeddings_num,
        }
        return meta, self.pts, self.cols

    @staticmethod
    def from_tuple(tup) -> "ObjectInfo":
        meta, pts, cols = tup
        obj = ObjectInfo(meta["id"], meta["names"][0], meta["embeddings"][0],
                         (pts, cols), meta["max_embeddings_num"])
        obj.names = list(meta["names"])
        obj.embeddings = [np.asarray(e) for e in meta["embeddings"]]
        obj._compute_means()
        return obj
