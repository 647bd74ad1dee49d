"""clip_loc, the text/appearance localisation pipeline (counterpart of
`instance_based_loc_tpu/memory/clip_loc.py`; reference `clip_loc/`):

    ObjectMemory -> ClipLocObjectMemory (per object: an embedding and a
    fitted ellipsoid) -> localize(img, K): detect -> embed crops -> cosine
    against the stored embeddings -> top-k candidates per detection ->
    RANSAC over samples of 3 correspondences -> P3P poses -> score each
    pose by projecting the memory clouds into the detection boxes -> the
    best pose, refined by Gauss-Newton on its inlier correspondences.

Every P3P problem of the RANSAC rounds solves in one call
(`ops.p3p.batched_p3p`) and every pose is scored in one batched call, on the
memory's device. The random draws are host numpy from
`np.random.default_rng(seed)`, in the JAX package's order, so both packages
draw the same samples. The stored embedding is the CLIP text embedding of
the object's joined names when a text encoder is given (the reference's
behaviour), else the mean exemplar crop embedding (weights-free runs). The
pkl format is the JAX package's (a list of dicts of numpy arrays), so each
package reads the other's file.

Entry points run on the card (`device="cuda"`) unless the caller asks for the
CPU; without a card they raise.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

from .. import resolve_device
from ..ops.ellipsoid import fit_ellipsoid
from ..ops.p3p import batched_p3p, project_points, refine_pnp
from ..ops.transforms import rotmat_to_quat_xyzw
from ..utils.logging import conditional_log


@dataclasses.dataclass
class ClipLocObjectInfo:
    """One object: id, text, embedding, cloud and ellipsoid (reference
    clip_loc_object_info.py)."""
    id: int
    text: str
    embedding: np.ndarray
    points: np.ndarray
    colors: np.ndarray
    ellipsoid_center: np.ndarray
    ellipsoid_axes: np.ndarray
    ellipsoid_lengths: np.ndarray

    @property
    def centroid(self) -> np.ndarray:
        return self.points.mean(0)


def _distinct_pixels(flat: torch.Tensor, n_pixels: int) -> torch.Tensor:
    """Per row of flat pixel indices (P, n), the number of distinct indices
    below `n_pixels` (the count of pixels a rasterised hit image holds)."""
    s = torch.sort(flat, dim=-1).values
    first = (s[:, :1] < n_pixels).sum(-1)
    new = (s[:, 1:] != s[:, :-1]) & (s[:, 1:] < n_pixels)
    return first + new.sum(-1)


class ClipLocObjectMemory:
    def __init__(self, objects: list[ClipLocObjectInfo],
                 log_enabled: bool = True, device="cuda"):
        self.memory = objects
        self.log_enabled = log_enabled
        self.device = resolve_device(device)
        self.ransac_samples = 0     # samples drawn by the last `localize`

    def _log(self, s):
        conditional_log(s, self.log_enabled)

    def __len__(self):
        return len(self.memory)

    @staticmethod
    def from_object_memory(object_memory, text_embed_fn=None,
                           log_enabled: bool = True,
                           device=None) -> "ClipLocObjectMemory":
        """Convert an ObjectMemory (reference clip_loc_object_memory.py:
        33-87); objects of fewer than 4 points are dropped. With a text
        encoder the embedding is the text embedding of the joined names,
        otherwise the mean exemplar embedding. `device` defaults to the
        memory's."""
        dev = object_memory.device if device is None else resolve_device(
            device)
        objects = []
        for obj in object_memory.memory:
            pts, cols = obj.pts, obj.cols
            if len(pts) < 4:
                continue
            center, axes, lengths = fit_ellipsoid(
                torch.as_tensor(pts, device=dev),
                torch.ones(len(pts), dtype=torch.bool, device=dev))
            text = " ".join(obj.names)
            emb = (np.asarray(text_embed_fn(text)) if text_embed_fn is not None
                   else np.asarray(obj.mean_emb))
            objects.append(ClipLocObjectInfo(
                id=obj.id, text=text, embedding=emb, points=pts, colors=cols,
                ellipsoid_center=center.cpu().numpy(),
                ellipsoid_axes=axes.cpu().numpy(),
                ellipsoid_lengths=lengths.cpu().numpy()))
        return ClipLocObjectMemory(objects, log_enabled, dev)

    def save(self, save_dir: str):
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "clip_loc_memory.pkl"), "wb") as f:
            pickle.dump([dataclasses.asdict(o) for o in self.memory], f)

    @staticmethod
    def load(save_dir: str, log_enabled: bool = True,
             device="cuda") -> "ClipLocObjectMemory":
        with open(os.path.join(save_dir, "clip_loc_memory.pkl"), "rb") as f:
            dicts = pickle.load(f)
        return ClipLocObjectMemory([ClipLocObjectInfo(**d) for d in dicts],
                                   log_enabled, device)

    def localize(self, rgb_image, intrinsic_matrix, detector, embed_fn,
                 k: int = 3, rounds: int = 100, seed: int = 0,
                 points_per_object: int = 256):
        """Reference localize (clip_loc_object_memory.py:134-216): a 7-vector
        pose [t, q_xyzw] (camera-to-world), or None."""
        img = np.asarray(rgb_image)
        det = detector.find(img, consider_floor=False)
        self._log(f"\tDetected {len(det)} objects in the current image")
        self.ransac_samples = 0
        if len(det) == 0 or len(self.memory) == 0:
            return None

        emb = np.asarray(embed_fn(detections=det, full_rgb_image=img,
                                  full_depth_image=np.zeros(img.shape[:2])))
        emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True),
                               1e-12)
        mem_emb = np.stack([o.embedding for o in self.memory])
        mem_emb = mem_emb / np.maximum(
            np.linalg.norm(mem_emb, axis=1, keepdims=True), 1e-12)
        sims = emb @ mem_emb.T                            # (D, M)
        k_eff = min(k, len(self.memory))
        top_k = np.argsort(-sims, axis=1)[:, :k_eff]      # (D, k)

        # candidate correspondences (detection, memory object), best first
        # (reference prosac_sampling_list, :160-168)
        pairs = [(d, int(top_k[d, i]))
                 for i in range(k_eff) for d in range(len(det))]
        centers_2d = np.stack([
            [(b[0] + b[2]) // 2, (b[1] + b[3]) // 2] for b in det.boxes_xyxy
        ]).astype(np.float32)

        rng = np.random.default_rng(seed)
        n_pairs = len(pairs)
        # P3P needs 3 correspondences with distinct detections
        if n_pairs < 3 or len(det) < 3:
            return None
        # similarity-weighted samples of 3 pairs with distinct detections
        pair_sims = np.array([max(sims[d, m], 1e-3) for d, m in pairs])
        pair_det = np.array([d for d, _ in pairs])
        probs = pair_sims / pair_sims.sum()
        samples = []
        attempts = 0
        while len(samples) < rounds and attempts < rounds * 20:
            attempts += 1
            cand = rng.choice(n_pairs, size=3, replace=False, p=probs)
            if len(set(pair_det[cand])) == 3:
                samples.append(cand)
        if not samples:
            return None
        self.ransac_samples = len(samples)
        samples = np.stack(samples)                        # (R, 3)
        det_idx = np.array([[pairs[i][0] for i in row] for row in samples])
        mem_idx = np.array([[pairs[i][1] for i in row] for row in samples])
        sample_sim = np.stack([pair_sims[row] for row in samples]).prod(1)
        # each object's centroid once (the JAX package takes the mean of its
        # cloud for every sampled correspondence: the same values)
        centroids = np.stack([o.centroid for o in self.memory]).astype(
            np.float32)
        world_pts = centroids[mem_idx]                     # (R, 3, 3)
        pixel_pts = centers_2d[det_idx]                    # (R, 3, 2)

        dev = self.device
        K = torch.as_tensor(np.asarray(intrinsic_matrix, np.float32),
                            device=dev)
        poses, valid = batched_p3p(torch.as_tensor(world_pts, device=dev),
                                   torch.as_tensor(pixel_pts, device=dev), K)
        poses = poses.reshape(-1, 4, 4)                    # (R * 4, 4, 4)
        valid = valid.reshape(-1).cpu().numpy()
        # one entry per pose (the JAX package repeats `rounds`, which is
        # the sample count whenever every round found a sample)
        sample_of_pose = np.repeat(np.arange(len(samples)), 4)

        # each memory object's cloud, subsampled to points_per_object
        sub_clouds = []
        for o in self.memory:
            pts = o.points
            if len(pts) > points_per_object:
                sel = rng.choice(len(pts), points_per_object, replace=False)
                pts = pts[sel]
            else:
                reps = int(np.ceil(points_per_object / max(len(pts), 1)))
                pts = np.tile(pts, (reps, 1))[:points_per_object]
            sub_clouds.append(pts)
        sub_clouds = torch.as_tensor(np.stack(sub_clouds).astype(np.float32),
                                     device=dev)           # (M, P, 3)

        # every pose scored against every detection's top-1 memory object:
        # the 3 sampled constraints hold exactly for every P3P root, so
        # only the other detections tell roots and mirrors apart. The score
        # counts DISTINCT pixels hit inside the detection's own box (the
        # reference rasterises), over the boxes' total area.
        boxes = torch.as_tensor(np.asarray(det.boxes_xyxy, np.float32),
                                device=dev)                # (D, 4)
        h_img, w_img = img.shape[:2]
        top1 = top_k[:, 0]
        per = sub_clouds.shape[1]
        pts = sub_clouds[torch.as_tensor(top1, device=dev)].reshape(-1, 3)
        owner = torch.arange(len(det), device=dev).repeat_interleave(per)
        px, in_front = project_points(pts, K, poses)       # (R*4, D*P, .)
        x, y = px[..., 0], px[..., 1]
        ob = boxes[owner]
        hit = ((x >= ob[:, 0]) & (x < ob[:, 2]) & (y >= ob[:, 1])
               & (y < ob[:, 3]) & in_front
               & (x >= 0) & (x < w_img) & (y >= 0) & (y < h_img))
        xi = torch.clamp(x.to(torch.int64), 0, w_img - 1)
        yi = torch.clamp(y.to(torch.int64), 0, h_img - 1)
        n_pix = h_img * w_img
        flat = torch.where(hit, yi * w_img + xi, n_pix)
        areas = (torch.clamp(boxes[:, 2] - boxes[:, 0], min=1.0)
                 * torch.clamp(boxes[:, 3] - boxes[:, 1], min=1.0))
        scores = (_distinct_pixels(flat, n_pix).float()
                  / areas.sum()).cpu().numpy()
        # weight geometric overlap by the sample's embedding similarity
        scores = scores * np.maximum(sample_sim[sample_of_pose], 1e-3)
        scores = np.where(valid, scores, -1.0)
        best = int(np.argmax(scores))
        if scores[best] < 0:
            return None
        best_pose = poses[best]

        # Gauss-Newton refinement over the inlier top-1 correspondences:
        # those whose memory centroid projects near the detection centre
        # under the winning pose (the reference returns the raw P3P pose)
        cents = centroids[top1]
        px_all, front_all = project_points(torch.as_tensor(cents, device=dev),
                                           K, best_pose)
        reproj = np.linalg.norm(px_all.cpu().numpy() - centers_2d, axis=1)
        inlier = front_all.cpu().numpy() & (reproj < 0.15 * max(h_img, w_img))
        if inlier.sum() >= 3:
            world, pixels = cents[inlier], centers_2d[inlier]
        else:
            s = sample_of_pose[best]
            world, pixels = world_pts[s], pixel_pts[s]
        refined = refine_pnp(best_pose, torch.as_tensor(world, device=dev),
                             torch.as_tensor(pixels, device=dev),
                             torch.ones(len(world), device=dev), K)
        t = refined[:3, 3].cpu().numpy()
        q = rotmat_to_quat_xyzw(refined[:3, :3]).cpu().numpy()
        return np.concatenate([t, q])
