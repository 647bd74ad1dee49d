"""Detection interface (copy of `instance_based_loc_tpu/memory/detection.py`,
which is numpy-only).

Detection is a pluggable object with one method:

    detector.find(rgb_image, consider_floor) -> Detections

so the memory core is decoupled from any model stack. Two weights-free
implementations live here: `ColorRegionDetector` (colour quantisation +
connected components, used by the synthetic fixture tests and the chip
smoke run) and `DepthRegionDetector` (depth discontinuities and normal
creases). The GroundingDINO -> SAM cascade exposes the same interface; its
port lives in `models/cascade.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Detections:
    """One frame's detections, batched (M = number of instances)."""
    crops: list[np.ndarray]        # M grounded RGB crops (ragged sizes)
    boxes_xyxy: np.ndarray         # (M, 4) pixel xyxy
    masks: np.ndarray              # (M, H, W) bool
    phrases: list[str]             # M phrase strings

    def __len__(self) -> int:
        return len(self.phrases)

    @staticmethod
    def empty(h: int = 1, w: int = 1) -> "Detections":
        return Detections([], np.zeros((0, 4), np.float32),
                          np.zeros((0, h, w), bool), [])


class ColorRegionDetector:
    """Weights-free instance detector for fixture scenes: quantise colors,
    split into connected components, emit one detection per large region.

    `floor_colors` marks colors whose regions get the phrase "floor" so the
    floor-routing path (`check_if_floor` -> ObjectMemory.floors) is exercised
    exactly as with the neural cascade.
    """

    def __init__(self, min_area: int = 120, quant: float = 32.0,
                 floor_colors: list[tuple] | None = None,
                 background_color: tuple = (0, 0, 0)):
        self.min_area = min_area
        self.quant = quant
        self.floor_colors = [np.asarray(c, np.float32) for c in (floor_colors or [])]
        self.background = np.asarray(background_color, np.float32)

    def find(self, rgb_image: np.ndarray, consider_floor: bool) -> Detections:
        from scipy import ndimage

        img = np.asarray(rgb_image)[..., :3].astype(np.float32)
        h, w = img.shape[:2]
        keys = np.floor(img / self.quant).astype(np.int32)
        flat = keys[..., 0] * 10000 + keys[..., 1] * 100 + keys[..., 2]

        crops, boxes, masks, phrases = [], [], [], []
        for key in np.unique(flat):
            region = flat == key
            if region.sum() < self.min_area:
                continue
            mean_color = img[region].mean(0)
            if np.linalg.norm(mean_color - self.background) < self.quant / 2:
                continue
            is_floor = any(np.linalg.norm(mean_color - fc * 255.0) < self.quant
                           for fc in self.floor_colors)
            if is_floor and not consider_floor:
                continue
            labeled, num = ndimage.label(region)
            for comp in range(1, num + 1):
                mask = labeled == comp
                if mask.sum() < self.min_area:
                    continue
                ys, xs = np.nonzero(mask)
                x1, x2 = xs.min(), xs.max() + 1
                y1, y2 = ys.min(), ys.max() + 1
                crops.append(np.ascontiguousarray(rgb_image[y1:y2, x1:x2]))
                boxes.append([x1, y1, x2, y2])
                masks.append(mask)
                phrases.append("floor" if is_floor
                               else f"object_{int(mean_color[0]) // 16}_{int(mean_color[1]) // 16}_{int(mean_color[2]) // 16}")

        if not crops:
            return Detections.empty(h, w)
        return Detections(crops, np.asarray(boxes, np.float32),
                          np.stack(masks), phrases)


class DepthRegionDetector:
    """Weights-free GEOMETRIC instance detector: backproject the depth map,
    estimate per-pixel surface normals from the local depth gradients, and
    segment on depth discontinuities OR normal creases (the classic
    geometric segmentation). Texture-independent — works on realistic
    renders where color quantisation shatters (e.g. the reference's
    committed 360_basic_test fixture).

    Large regions whose mean normal is near-vertical in the camera frame are
    tagged "floor" so the floor-routing path matches the cascade's.
    Declares `wants_depth`, so ObjectMemory passes the scaled depth map."""

    wants_depth = True

    def __init__(self, focal_length_x: float, focal_length_y: float | None = None,
                 min_area: int = 400, edge_rel: float = 0.04,
                 edge_abs: float = 0.06, normal_angle_deg: float = 25.0,
                 floor_normal_y: float = 0.85, floor_area_frac: float = 0.05):
        self.fx = float(focal_length_x)
        self.fy = float(focal_length_y or focal_length_x)
        self.min_area = min_area
        self.edge_rel = edge_rel
        self.edge_abs = edge_abs
        self.cos_crease = np.cos(np.deg2rad(normal_angle_deg))
        self.floor_normal_y = floor_normal_y
        self.floor_area_frac = floor_area_frac

    def _normals(self, depth):
        """Per-pixel camera-frame normals from backprojected points
        (centered-grid convention, matching ops/backprojection.py)."""
        h, w = depth.shape
        ys = np.linspace(-h / 2.0, h / 2.0, h, dtype=np.float32)
        xs = np.linspace(-w / 2.0, w / 2.0, w, dtype=np.float32)
        gx, gy = np.meshgrid(xs, ys)
        pts = np.stack([gx * depth / self.fx, gy * depth / self.fy, depth],
                       axis=-1)
        du = np.gradient(pts, axis=1)
        dv = np.gradient(pts, axis=0)
        n = np.cross(du, dv)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.maximum(norm, 1e-12)

    def find(self, rgb_image: np.ndarray, consider_floor: bool,
             depth: np.ndarray | None = None) -> Detections:
        from scipy import ndimage

        img = np.asarray(rgb_image)[..., :3]
        h, w = img.shape[:2]
        if depth is None:
            return Detections.empty(h, w)
        d = np.asarray(depth, np.float32)
        finite = np.isfinite(d) & (d > 1e-6)

        gy, gx = np.gradient(np.where(finite, d, 0.0))
        jump = np.hypot(gx, gy) > np.maximum(self.edge_abs, self.edge_rel * d)

        n = self._normals(np.where(finite, d, np.nan))
        # crease: normal turns sharply towards the right/down neighbor
        cos_r = np.abs(np.sum(n[:, :-1] * n[:, 1:], axis=-1))
        cos_d = np.abs(np.sum(n[:-1] * n[1:], axis=-1))
        crease = np.zeros((h, w), bool)
        crease[:, :-1] |= cos_r < self.cos_crease
        crease[:, 1:] |= cos_r < self.cos_crease
        crease[:-1] |= cos_d < self.cos_crease
        crease[1:] |= cos_d < self.cos_crease
        crease &= np.isfinite(n).all(-1)

        smooth = finite & ~jump & ~crease
        labeled, num = ndimage.label(smooth)
        crops, boxes, masks, phrases = [], [], [], []
        for comp in range(1, num + 1):
            mask = labeled == comp
            area = int(mask.sum())
            if area < self.min_area:
                continue
            mean_n = n[mask].mean(0)
            planarity = np.linalg.norm(mean_n)   # ~1 when normals agree
            mean_n /= max(planarity, 1e-12)
            ys_, xs_ = np.nonzero(mask)
            big_plane = (area > self.floor_area_frac * h * w
                         and planarity > 0.9)
            horizontal = abs(mean_n[1]) > self.floor_normal_y
            low_in_image = ys_.mean() > 0.5 * h
            # the reference's caption filter drops wall/ceiling words
            # (object_finder_phrases.py ignore list) — large planar regions
            # that aren't the floor are its geometric equivalent: registration
            # against a dominant plane slides freely along it
            if big_plane and (not horizontal or not low_in_image):
                continue                        # wall or ceiling
            is_floor = big_plane and horizontal and low_in_image
            if is_floor and not consider_floor:
                continue
            y1, y2 = ys_.min(), ys_.max() + 1
            x1, x2 = xs_.min(), xs_.max() + 1
            crops.append(np.ascontiguousarray(img[y1:y2, x1:x2]))
            boxes.append([x1, y1, x2, y2])
            masks.append(mask)
            phrases.append("floor" if is_floor else f"object_{comp}")

        if not crops:
            return Detections.empty(h, w)
        return Detections(crops, np.asarray(boxes, np.float32),
                          np.stack(masks), phrases)
