"""ObjectMemory: build / consolidate / persist / localise (counterpart of
`instance_based_loc_tpu/memory/object_memory.py`).

* detection and embedding are batched per frame (one detector call, one
  embedder call over all crops);
* memory-build frames run `process_frame` on the memory's device:
  backprojection, outlier removal, noise injection, world transform and the
  per-mask subsample, with one fetch per frame;
* the localise query runs `localise_frame` on the device: every point cloud
  stays there and one small fetch brings back the pose and the per-assignment
  statistics. The memory side is packed once per memory version
  (`_pack_memory`);
* instance bookkeeping (ObjectInfo, clustering, merging) is host numpy;
  the reclustering IoU matrix (`ops/iou3d.py`) runs on the device;
* the final pose is composed from the BEST assignment's means (the
  reference composes it from loop-leaked means, a bug the JAX package fixed).

Entry points run on the card (`device="cuda"`) unless the caller asks for the
CPU; without a card they raise.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .. import resolve_device
from ..data.loader import load_depth, load_rgb
from ..ops.clustering import agglomerative_precomputed, dbscan
from ..ops.iou3d import pairwise_obb_iou
from ..ops.localise_kernels import localise_frame, make_subsets, process_frame
from ..ops.outliers import DEFAULT_OUTLIER_REMOVAL_CONFIG
from ..ops.pointcloud import round_up_pow2
from ..utils.logging import conditional_log
from ..utils.ply import write_ply
from ..utils.profiling import StageTimer
from .detection import Detections
from .object_info import ObjectInfo
from .phrases import check_if_floor


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


LOCALISE_OUTLIER_CONFIG = {"radius_nb_points": 8, "radius": 0.05}
# Registration quality/speed knobs: the JAX package's IBL_* names and
# defaults (see instance_based_loc_tpu/memory/object_memory.py for the
# measurements behind each default).
REGISTRATION_CAPACITY = _env_int("IBL_REG_CAP", 1024)  # per-side registration points
FPFH_CAPACITY = _env_int("IBL_FPFH_CAP", 256)   # RANSAC feature subsample
EVAL_CAPACITY = _env_int("IBL_EVAL_CAP", 2048)  # full-memory evaluation points
MEM_OBJECT_CAPACITY = 2048       # per-memory-object resident point budget
PROCESS_CAPACITY = 8192          # per-detection point budget kept at build time
NUM_HYPOTHESES = _env_int("IBL_NUM_HYP", 512)
ICP_COARSE_ITERS = _env_int("IBL_ICP_COARSE", 8)
ICP_FINE_ITERS = _env_int("IBL_ICP_FINE", 10)
ICP_EARLY_EXIT = bool(_env_int("IBL_ICP_EARLY_EXIT", 0))
FPFH_MAX_NN = _env_int("IBL_FPFH_NN", 50)   # Open3D's hybrid search uses 100
REG_SEEDS = _env_int("IBL_REG_SEEDS", 1)
DPAD_MARGIN = _env_int("IBL_DPAD_MARGIN", 1)
                                 # host-side detection staging cap: the
                                 # top_n + margin largest masks (by pixel
                                 # count) are staged per query; -1 stages
                                 # every detection
RANSAC_PAIRS_MAX = _env_int("IBL_RANSAC_PAIRS", 3)
                                 # FPFH+RANSAC for assignments with <= this
                                 # many pairs; the rest seed ICP from the
                                 # centroid-Kabsch init alone


def _subsample_points(pts: np.ndarray, cols: np.ndarray, cap: int,
                      seed: int = 0):
    if len(pts) <= cap:
        return pts, cols
    idx = np.random.default_rng(seed).choice(len(pts), cap, replace=False)
    return pts[idx], cols[idx]


class ObjectMemory:
    """Reference ObjectMemory (object_memory.py:41-1169) with a pluggable
    detector and a batched embedding callback:

        get_embeddings_func(detections: Detections, full_rgb_image,
                            full_depth_image, consider_floor) -> (M, E)

    Images are passed as arrays, or as paths read by `load_rgb_image_func` /
    `load_depth_image_func` (by default the PNG / .npy readers of
    `data/loader.py`). `timer` accumulates the JAX package's stage names
    build.{load,detect,embed,device,bookkeeping} and
    loc.{load,detect,embed,device,finish}, and build.downsample, recluster
    (the CLI's strategy) and recluster.iou_matrix."""

    def __init__(
        self,
        detector,
        camera_focal_lenth_x: float,
        camera_focal_lenth_y: float,
        get_embeddings_func,
        log_enabled: bool = True,
        mem_formation_bounding_box_threshold: float = 0.3,
        mem_formation_occlusion_overlap_threshold: float = 0.9,
        object_info_max_embeddings_num: int = 1_000_000,
        load_rgb_image_func=None,
        load_depth_image_func=None,
        dataset_floor_thickness: float = 0.1,
        device="cuda",
    ):
        if get_embeddings_func is None:
            raise NotImplementedError("Need to pass in get_embeddings_func")
        self.device = resolve_device(device)
        self.detector = detector
        self.camera_focal_lenth_x = camera_focal_lenth_x
        self.camera_focal_lenth_y = camera_focal_lenth_y
        self.get_embeddings_func = get_embeddings_func
        self.log_enabled = log_enabled
        self.mem_formation_bounding_box_threshold = mem_formation_bounding_box_threshold
        self.mem_formation_occlusion_overlap_threshold = mem_formation_occlusion_overlap_threshold
        self.object_info_max_embeddings_num = object_info_max_embeddings_num
        self.load_rgb_image_func = load_rgb_image_func or load_rgb
        self.load_depth_image_func = load_depth_image_func or load_depth
        self.dataset_floor_thickness = dataset_floor_thickness

        self.memory: list[ObjectInfo] = []
        self.floors: ObjectInfo | None = None
        self.timer = StageTimer()
        self._pack = None          # resident device tensors (localise)
        self._frame_counter = 0

    def _log(self, statement):
        conditional_log(statement, self.log_enabled)

    def _invalidate_pack(self):
        self._pack = None

    def __repr__(self):
        rep = "".join(f"\t{obj}\n" for obj in self.memory)
        return rep if rep else "\tNo objects in memory yet."

    def _generator(self) -> torch.Generator:
        """A fresh generator per frame, seeded by the frame counter (the
        reference's PRNGKey(frame_counter))."""
        self._frame_counter += 1
        return torch.Generator(device=self.device).manual_seed(
            self._frame_counter)

    # ------------------------------------------------------------------ #
    # build
    # ------------------------------------------------------------------ #
    def _load_images(self, rgb_image, depth_image, depth_factor):
        rgb = (rgb_image if isinstance(rgb_image, np.ndarray)
               else self.load_rgb_image_func(rgb_image))
        depth = (depth_image if isinstance(depth_image, np.ndarray)
                 else self.load_depth_image_func(depth_image))
        return rgb, np.asarray(depth, np.float32) / depth_factor

    @staticmethod
    def _pad_masks(masks: np.ndarray, minimum: int = 8) -> np.ndarray:
        """Pad the detection axis to a power-of-two bucket with all-False
        masks (they yield empty clouds, dropped downstream)."""
        m = len(masks)
        bucket = max(minimum, 1 << (m - 1).bit_length())
        if bucket == m:
            return np.asarray(masks)
        pad = np.zeros((bucket - m,) + masks.shape[1:], masks.dtype)
        return np.concatenate([masks, pad])

    def process_image(self, rgb_image_path, depth_image_path, pose,
                      consider_floor: bool,
                      outlier_removal_config=DEFAULT_OUTLIER_REMOVAL_CONFIG,
                      add_noise: bool = False,
                      pose_noise: dict = {"trans": 0.0005, "rot": 0.0005},
                      depth_noise: float = 0.003,
                      min_points: int = 500,
                      will_cluster_later: bool = True,
                      depth_factor: float = 1.0,
                      kinect_frame: bool = False,
                      process_capacity: int = PROCESS_CAPACITY,
                      detections: Detections | None = None):
        """Reference process_image (object_memory.py:163-256): detect, embed,
        backproject, (optional noise), world transform, min-points filter,
        floor routing, append. `detections` skips the detect stage."""
        timer = self.timer
        with timer.stage("build.load"):
            rgb, depth = self._load_images(rgb_image_path, depth_image_path,
                                           depth_factor)
        with timer.stage("build.detect"):
            if detections is not None:
                det = detections
            elif getattr(self.detector, "wants_depth", False):
                det = self.detector.find(rgb, consider_floor, depth=depth)
            else:
                det = self.detector.find(rgb, consider_floor)
        if len(det) == 0:
            self._log("ObjectMemory.process_image did NOT find any objects")
            return
        with timer.stage("build.embed"):
            embs = np.asarray(self.get_embeddings_func(
                detections=det, full_rgb_image=rgb, full_depth_image=depth,
                consider_floor=consider_floor))
        if len(embs) != len(det):
            raise ValueError(f"{len(embs)} embeddings for {len(det)} "
                             f"detections")

        pose = np.array(pose, np.float64)
        if add_noise:
            rng = np.random.default_rng(0)
            pose[:3] += rng.normal(0, pose_noise["trans"], 3)
            q = pose[3:] + rng.normal(0, pose_noise["rot"], 4)
            pose[3:] = q / max(np.linalg.norm(q), 1e-12)

        cfg = outlier_removal_config
        dev = self.device
        with timer.stage("build.device"):
            pc6, raw_counts, sub_counts = process_frame(
                torch.as_tensor(depth, device=dev),
                torch.as_tensor(np.asarray(rgb), device=dev),
                torch.as_tensor(self._pad_masks(det.masks), device=dev),
                torch.as_tensor(pose, dtype=torch.float32, device=dev),
                float(self.camera_focal_lenth_x),
                float(self.camera_focal_lenth_y),
                cfg["radius"] if cfg else 0.05, float(depth_noise),
                self._generator(),
                proc_cap=process_capacity, apply_outlier=cfg is not None,
                nb_points=cfg["radius_nb_points"] if cfg else 0,
                kinect=kinect_frame, add_noise=add_noise)
            pc6, raw_counts, sub_counts = (x.cpu().numpy() for x in
                                           (pc6, raw_counts, sub_counts))
        with timer.stage("build.bookkeeping"):
            self._log(f"ObjectMemory.process_image found: {det.phrases}")
            for i, (phrase, emb) in enumerate(zip(det.phrases, embs)):
                n_raw = int(raw_counts[i])
                if n_raw < min_points:
                    self._log(f"\t\tSkipping {phrase}: {n_raw} points "
                              f"< min_points = {min_points}.")
                    continue
                n = int(sub_counts[i])
                new_obj = ObjectInfo(len(self.memory), phrase, emb,
                                     (pc6[i, :n, :3].copy(),
                                      pc6[i, :n, 3:].copy()),
                                     self.object_info_max_embeddings_num)
                if check_if_floor(new_obj.names):
                    self.floors = (new_obj if self.floors is None
                                   else self.floors + new_obj)
                    self._log(f"\tFloor Added: {new_obj}")
                else:
                    self.memory.append(new_obj)
                    self._log(f"\tObject Added: {new_obj}")
        self._invalidate_pack()

    # ------------------------------------------------------------------ #
    # consolidation
    # ------------------------------------------------------------------ #
    def downsample_all_objects(self, voxel_size: float):
        self._log("Downsampling all objects")
        with self.timer.stage("build.downsample"):
            for obj in self.memory:
                obj.downsample(voxel_size)
            if self.floors is not None:
                self.floors.downsample(voxel_size)
        self._invalidate_pack()

    def remove_points_below_floor(self):
        """Reference object_memory.py:265-291: min object height +
        thickness."""
        self._log("Removing points below floor")
        if not self.memory:
            return
        floor_height = min(float(obj.points()[:, 1].min())
                           for obj in self.memory if obj.num_points())
        surviving = []
        for obj in self.memory:
            keep = obj.points()[:, 1] > floor_height + self.dataset_floor_thickness
            obj.update_pointcloud_with_mask(keep)
            if obj.num_points() > 0:
                surviving.append(obj)
        self.memory = surviving
        self._invalidate_pack()

    def _merge_by_labels(self, objects: list[ObjectInfo], labels: np.ndarray,
                         drop_noise: bool = True) -> list[ObjectInfo]:
        merged: dict[int, ObjectInfo] = {}
        for label, obj in zip(labels, objects):
            if label == -1 and drop_noise:
                continue
            if label in merged:
                merged[label] = merged[label] + obj
            else:
                merged[label] = obj
        out = list(merged.values())
        for i, obj in enumerate(out):
            obj.id = i
        return out

    def _dbscan_object_labels(self, objects: list[ObjectInfo], eps,
                              min_points):
        """Each object's label is the DBSCAN cluster of its first point
        (the reference's rule, object_memory.py:326-338)."""
        pts = [obj.points() for obj in objects]
        labels = dbscan(np.concatenate(pts), eps=eps, min_points=min_points)
        starts = np.cumsum([0] + [len(p) for p in pts[:-1]])
        return labels[starts]

    def recluster_objects_with_dbscan(self, eps=0.2,
                                      min_points_per_cluster=300,
                                      visualize: bool = False):
        self._log("Clustering using DBSCAN")
        if not self.memory:
            return
        labels = self._dbscan_object_labels(self.memory, eps,
                                            min_points_per_cluster)
        self.memory = self._merge_by_labels(self.memory, labels)
        self._invalidate_pack()

    def _embedding_distance_matrix(self) -> np.ndarray:
        """1 - the min-max normalised cosine similarity of the objects'
        mean embeddings (reference object_memory.py:444-465)."""
        embs = np.stack([obj.mean_emb for obj in self.memory]) \
            .astype(np.float64)
        embs = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True),
                                 1e-12)
        sim = embs @ embs.T
        sim = sim - sim.min()
        denom = sim.max()
        if denom > 0:
            sim = sim / denom
        return 1.0 - sim

    def recluster_via_agglomerative_clustering(
            self, embedding_distance_threshold=0.4, **_ignored):
        if len(self.memory) < 2:
            return
        self._log("Clustering agglomeratively")
        labels = agglomerative_precomputed(self._embedding_distance_matrix(),
                                           embedding_distance_threshold,
                                           linkage="average")
        self.memory = self._merge_by_labels(self.memory, labels,
                                            drop_noise=False)
        self._invalidate_pack()

    def recluster_via_combined(self, embedding_distance_threshold=0.4,
                               eps=0.4, min_points_per_cluster=150):
        """Agglomerative clustering on the embeddings, then DBSCAN within
        each embedding cluster (reference object_memory.py:444-556)."""
        if len(self.memory) < 2:
            return
        self._log("Clustering agglomeratively")
        labels = agglomerative_precomputed(self._embedding_distance_matrix(),
                                           embedding_distance_threshold,
                                           linkage="average")
        new_memory: list[ObjectInfo] = []
        for u in np.unique(labels):
            group = [obj for lab, obj in zip(labels, self.memory) if lab == u]
            sub_labels = self._dbscan_object_labels(group, eps,
                                                    min_points_per_cluster)
            new_memory += self._merge_by_labels(group, sub_labels)
        self.memory = new_memory
        for i, obj in enumerate(self.memory):
            obj.id = i
        self._invalidate_pack()

    def _iou_clouds(self):
        """The clouds the IoU pass fits its boxes to: per object at most
        2048 points, drawn with numpy's default_rng(0) as the JAX package
        draws them, zero-padded to (K, cap, 3) with a (K, cap) mask."""
        k = len(self.memory)
        cap = round_up_pow2(
            min(max(max(o.num_points() for o in self.memory), 8), 2048))
        rng = np.random.default_rng(0)
        pts = np.zeros((k, cap, 3), np.float32)
        msk = np.zeros((k, cap), bool)
        for i, obj in enumerate(self.memory):
            p = obj.points()
            if len(p) > cap:
                p = p[rng.choice(len(p), cap, replace=False)]
            pts[i, :len(p)] = p
            msk[i, :len(p)] = True
        return pts, msk

    def _recluster_IoU(self, IoU_threshold=0.6):
        """Agglomerative (average) clustering on 1 - the pairwise oriented
        box IoU (reference object_memory.py:710-747); the IoU matrix is
        computed on the memory's device."""
        if len(self.memory) < 2:
            return
        pts, msk = self._iou_clouds()
        with self.timer.stage("recluster.iou_matrix"):
            ious = pairwise_obb_iou(
                torch.as_tensor(pts, device=self.device),
                torch.as_tensor(msk, device=self.device)).cpu().numpy()
        dist = 1.0 - ious
        np.fill_diagonal(dist, 0.0)
        labels = agglomerative_precomputed(dist, 1.0 - IoU_threshold,
                                           linkage="average")
        self._log("Clustering agglomeratively")
        self.memory = self._merge_by_labels(self.memory, labels,
                                            drop_noise=False)
        for obj in self.memory:
            obj._compute_means()
        self._invalidate_pack()

    def recluster_via_clustering_and_IoU(self, embedding_distance_threshold=0.4,
                                         eps=0.4, min_points_per_cluster=150,
                                         IoU_threshold=0.25):
        """The IoU pass, then the combined pass (reference
        object_memory.py:562-708)."""
        with self.timer.stage("recluster"):
            self._recluster_IoU(IoU_threshold)
            self.recluster_via_combined(embedding_distance_threshold, eps,
                                        min_points_per_cluster)

    # ------------------------------------------------------------------ #
    # persistence (the JAX package's ply dumps and pkl format)
    # ------------------------------------------------------------------ #
    def save(self, save_directory: str):
        """memory.txt, the combined clouds as ply, and one directory per
        object (and the floors) holding its ply and info.pkl."""
        obj_dir = os.path.join(save_directory, "objects")
        floor_dir = os.path.join(save_directory, "floors")
        os.makedirs(obj_dir, exist_ok=True)
        os.makedirs(floor_dir, exist_ok=True)
        with open(os.path.join(save_directory, "memory.txt"), "w") as f:
            f.write(repr(self))
        if self.memory:
            pts = np.concatenate([o.pts for o in self.memory])
            cols = np.concatenate([o.cols for o in self.memory])
            write_ply(os.path.join(save_directory, "combined_pointcloud.ply"),
                      pts, cols)
            if self.floors is not None:
                write_ply(os.path.join(save_directory,
                                       "combined_pointcloud_with_floor.ply"),
                          np.concatenate([pts, self.floors.pts]),
                          np.concatenate([cols, self.floors.cols]))
        for obj in self.memory:
            obj.save(os.path.join(obj_dir, str(obj.id)))
        if self.floors is not None:
            self.floors.save(os.path.join(floor_dir, "all_floors"))
        self._log(f"Saved memory to {save_directory}")

    def save_to_pkl(self, save_path: str):
        payload = {
            "memory": [obj.to_tuple() for obj in self.memory],
            "floors": self.floors.to_tuple() if self.floors is not None else None,
        }
        with open(save_path, "wb") as f:
            pickle.dump(payload, f)

    def load(self, load_path: str):
        """Load a memory pkl written by `save_to_pkl` of either package.
        Unpickling runs code: load only files this program wrote."""
        with open(load_path, "rb") as f:
            payload = pickle.load(f)
        self.memory = [ObjectInfo.from_tuple(t) for t in payload["memory"]]
        self.floors = (ObjectInfo.from_tuple(payload["floors"])
                       if payload["floors"] is not None else None)
        self._invalidate_pack()

    # ------------------------------------------------------------------ #
    # memory packing: host instances -> resident device tensors
    # ------------------------------------------------------------------ #
    def _pack_memory(self):
        """Per-object point banks, centroids, unit-norm exemplar embeddings
        and the full-memory evaluation cloud, uploaded once per memory
        version."""
        if self._pack is not None:
            return self._pack
        m = len(self.memory)
        if m == 0:
            raise ValueError("the memory holds no objects")
        m_pad = round_up_pow2(m, minimum=4)
        mcap = min(MEM_OBJECT_CAPACITY,
                   round_up_pow2(max(o.num_points() for o in self.memory)))
        e_dim = int(np.asarray(self.memory[0].mean_emb).size)
        e_pad = round_up_pow2(max(len(o.embeddings) for o in self.memory),
                              minimum=1)

        pts = np.zeros((m_pad, mcap, 3), np.float32)
        cols = np.zeros((m_pad, mcap, 3), np.float32)
        msk = np.zeros((m_pad, mcap), bool)
        cent = np.zeros((m_pad, 3), np.float32)
        ex = np.zeros((m_pad, e_pad, e_dim), np.float32)
        ex_valid = np.zeros((m_pad, e_pad), bool)
        valid = np.zeros((m_pad,), bool)
        for i, obj in enumerate(self.memory):
            p, c = _subsample_points(obj.pts, obj.cols, mcap, seed=i)
            pts[i, :len(p)] = p
            cols[i, :len(p)] = c
            msk[i, :len(p)] = True
            cent[i] = obj.pts.mean(0)
            e = np.stack([np.asarray(x).reshape(-1) for x in obj.embeddings])
            e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
            ex[i, :len(e)] = e
            ex_valid[i, :len(e)] = True
            valid[i] = True

        all_pts = np.concatenate([o.pts for o in self.memory])
        all_cols = np.concatenate([o.cols for o in self.memory])
        ev_pts, _ = _subsample_points(all_pts, all_cols, EVAL_CAPACITY)
        ev = np.zeros((EVAL_CAPACITY, 3), np.float32)
        ev_msk = np.zeros((EVAL_CAPACITY,), bool)
        ev[:len(ev_pts)] = ev_pts
        ev_msk[:len(ev_pts)] = True

        def put(x):
            return torch.as_tensor(x, device=self.device)
        self._pack = dict(
            m_pad=m_pad, e_dim=e_dim,
            mem_pts=put(pts), mem_cols=put(cols), mem_msk=put(msk),
            mem_cent=put(cent), mem_ex=put(ex), mem_ex_valid=put(ex_valid),
            mem_valid=put(valid), eval_pts=put(ev), eval_msk=put(ev_msk))
        return self._pack

    # ------------------------------------------------------------------ #
    # localise (reference object_memory.py:852-1169)
    # ------------------------------------------------------------------ #
    def localise(self, image_path, depth_image_path, testname: str = "",
                 subtest_name: str = "", save_point_clouds: bool = False,
                 save_root: str = "pcds", **kwargs):
        """Returns (pose7 [x,y,z,qx,qy,qz,qw], [assignment, None]). With
        `save_point_clouds`, the query's detected evaluation cloud and the
        memory's are written as ply under save_root/testname/subtest_name,
        before and after the best assignment's transform."""
        hh = self._localise_host(image_path, depth_image_path, **kwargs)
        if "result" in hh:
            return hh["result"]
        keys = ["active", "assn_valid", "pair_valid", "assn_det", "assn_mem",
                "best", "pose7", "rmse", "fitness", "full_rmse",
                "full_fitness"]
        if save_point_clouds:
            keys += ["eval_det_pts", "eval_det_msk", "transform"]
        with self.timer.stage("loc.device"):
            out = localise_frame(*hh["args"], hh["generator"],
                                 **hh["statics"])
            out = {key: out[key].cpu().numpy() for key in keys}
        with self.timer.stage("loc.finish"):
            result = self._finish_out(out, hh["zero"])
            if save_point_clouds and result[1][0]:
                self._save_debug_clouds(out, result[1][0], testname,
                                        subtest_name, save_root)
        return result

    def _localise_host(self, image_path, depth_image_path,
                       outlier_removal_config=None,
                       fpfh_global_dist_factor: float = 2.0,
                       fpfh_local_dist_factor: float = 0.4,
                       fpfh_voxel_size: float = 0.05,
                       consider_floor: bool = False,
                       depth_factor: float = 1.0,
                       max_detected_object_num: int = 7,
                       centroid_gate: float = 1.0):
        """Host stages of a query: load, detect, embed, stage the detections
        and upload. outlier_removal_config=None means NO outlier removal
        (unlike the reference's localise default); pass
        LOCALISE_OUTLIER_CONFIG for the reference behaviour."""
        consider_floor = False   # the reference hard-disables it (:886)
        timer = self.timer
        with timer.stage("loc.load"):
            rgb, depth = self._load_images(image_path, depth_image_path,
                                           depth_factor)
        with timer.stage("loc.detect"):
            det = (self.detector.find(rgb, consider_floor, depth=depth)
                   if getattr(self.detector, "wants_depth", False)
                   else self.detector.find(rgb, consider_floor))
        zero = (np.array([0., 0., 0., 0., 0., 0., 1.]), [[], []])
        if len(det) == 0 or len(self.memory) == 0:
            return {"result": zero}
        with timer.stage("loc.embed"):
            detected_embs = np.asarray(self.get_embeddings_func(
                detections=det, full_rgb_image=rgb, full_depth_image=depth,
                consider_floor=consider_floor))

        pack = self._pack_memory()
        dev = self.device
        m_pad = pack["m_pad"]
        top_n = max_detected_object_num
        k = min(top_n, 3)
        if pack.get("subsets_key") != (top_n, k):
            pack["subsets"] = torch.as_tensor(make_subsets(top_n, k=k),
                                              dtype=torch.int64, device=dev)
            pack["subsets_key"] = (top_n, k)
        a_pad = round_up_pow2(sum(max(1, L) for L in range(1, k + 1)),
                              minimum=4)
        cfg = outlier_removal_config

        # d_pad cap: only the top_n biggest detections reach registration,
        # so stage the top_n + margin largest masks by pixel count (a proxy
        # for the device's point count), in their original order
        det_masks = np.asarray(det.masks)
        if 0 <= DPAD_MARGIN and len(det_masks) > top_n + DPAD_MARGIN:
            areas = np.count_nonzero(det_masks.reshape(len(det_masks), -1),
                                     axis=1)
            keep = np.sort(np.argsort(-areas, kind="stable")
                           [:top_n + DPAD_MARGIN])
            det_masks = det_masks[keep]
            detected_embs = detected_embs[keep]
        n_det = len(det_masks)
        masks = self._pad_masks(det_masks, minimum=round_up_pow2(top_n))
        d_pad = len(masks)
        e_dim = detected_embs.shape[1]
        embs_pad = np.zeros((d_pad, e_dim), np.float32)
        embs_pad[:n_det] = detected_embs
        det_valid = np.zeros((d_pad,), bool)
        det_valid[:n_det] = True
        # the reference stages depth as per-frame-scaled u16 (error
        # <= max_depth / 65535 / 2, far below the 2 cm registration voxel);
        # kept so both packages localise the same depth values
        darr = np.nan_to_num(np.asarray(depth, np.float32),
                             nan=0.0, posinf=0.0, neginf=0.0)
        dmax = float(darr.max())
        scale = (65535.0 / dmax) if dmax > 0 else 1.0
        d16 = np.round(darr.astype(np.float64) * scale).astype(np.uint16)
        depth_q = d16.astype(np.float32) * np.float32(1.0 / scale)

        budget = 4 * top_n * 4   # reference pop budget: num_per_length*D*4
        statics = dict(
            top_n=top_n, budget=min(budget, (m_pad + 1) ** k),
            outlier_passes=2 if cfg else 0,
            nb_points=cfg["radius_nb_points"] if cfg else 0,
            min_det_points=16, a_pad=a_pad,
            reg_cap=REGISTRATION_CAPACITY, fpfh_cap=FPFH_CAPACITY,
            eval_cap=EVAL_CAPACITY, num_hyp=NUM_HYPOTHESES,
            icp_coarse_iters=ICP_COARSE_ITERS,
            icp_fine_iters=ICP_FINE_ITERS, icp_early_exit=ICP_EARLY_EXIT,
            reg_seeds=REG_SEEDS, fpfh_nn=FPFH_MAX_NN,
            ransac_pairs_max=RANSAC_PAIRS_MAX)
        args = (torch.as_tensor(depth_q, device=dev),
                torch.as_tensor(np.asarray(rgb, np.uint8), device=dev),
                torch.as_tensor(np.asarray(masks, bool), device=dev),
                torch.as_tensor(embs_pad, device=dev),
                torch.as_tensor(det_valid, device=dev),
                pack["mem_pts"], pack["mem_cols"], pack["mem_msk"],
                pack["mem_cent"], pack["mem_ex"], pack["mem_ex_valid"],
                pack["mem_valid"], pack["eval_pts"], pack["eval_msk"],
                pack["subsets"],
                float(self.camera_focal_lenth_x),
                float(self.camera_focal_lenth_y),
                cfg["radius"] if cfg else 0.05,
                float(fpfh_voxel_size), float(fpfh_global_dist_factor),
                float(fpfh_local_dist_factor), float(centroid_gate))
        return {"args": args, "statics": statics, "zero": zero,
                "generator": self._generator()}

    def _finish_out(self, out, zero):
        """The host decode of a query's fetched outputs."""
        assn_valid = out["assn_valid"]
        if int(out["active"].sum()) == 0 or not assn_valid.any():
            return zero

        def decode(i):
            pv = out["pair_valid"][i]
            return [[int(d), int(m)] for d, m in
                    zip(out["assn_det"][i][pv], out["assn_mem"][i][pv])]

        valid_idx = np.nonzero(assn_valid)[0]
        if self.log_enabled:
            self._log("Assignments being considered: "
                      f"{[decode(i) for i in valid_idx]}")
            for i in sorted(valid_idx, key=lambda i: out["full_fitness"][i],
                            reverse=True):
                self._log(f"Assn: {decode(i)} | chosen RMSE: "
                          f"{out['rmse'][i]:.4f} | full RMSE: "
                          f"{out['full_rmse'][i]:.4f} | chosen fitness: "
                          f"{out['fitness'][i]:.4f} | full fitness: "
                          f"{out['full_fitness'][i]:.4f}")
        best = int(out["best"])
        if not assn_valid[best]:
            return zero
        best_assn = decode(best)
        self._log(f"Best assn: {best_assn}")
        return np.asarray(out["pose7"], np.float64), [best_assn, None]

    def _save_debug_clouds(self, out, best_assn, testname, subtest_name,
                           save_root):
        """Debug ply dumps (reference object_memory.py:946-966,1139-1161)
        of the evaluation subsample of the detected cloud that the query
        returns, with the memory's evaluation cloud."""
        subsave = os.path.join(save_root, testname, str(subtest_name))
        os.makedirs(subsave, exist_ok=True)
        pack = self._pack_memory()
        det_pts = out["eval_det_pts"][out["eval_det_msk"]]
        mem_pts = pack["eval_pts"].cpu().numpy()[pack["eval_msk"].cpu().numpy()]
        write_ply(os.path.join(subsave, "_init_pcd.ply"),
                  np.concatenate([det_pts, mem_pts]))
        gT = out["transform"][int(out["best"])]
        moved_det = det_pts @ gT[:3, :3].T + gT[:3, 3]
        write_ply(os.path.join(subsave, f"_best_full_pcd{best_assn}.ply"),
                  np.concatenate([mem_pts, moved_det]))
