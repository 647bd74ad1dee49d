"""Procedural synthetic RGB-D scenes (copy of the numpy-only parts of
`instance_based_loc_tpu/data/synthetic.py`): axis-aligned coloured boxes and
spheres on a floor plane, ray-cast with the exact inverse of the centered-pixel
backprojection, so `backproject(render(scene)) == scene geometry` by
construction.

Depth is the camera-frame z coordinate; background pixels get depth 0
(invalid, dropped by the z != 0 filter downstream). The dataset writers of
the JAX package (PIL image files) and its ReID-textured scenes are not
copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Box:
    center: np.ndarray      # (3,) world
    size: np.ndarray        # (3,) full extents
    color: np.ndarray       # (3,) in [0, 1]
    name: str
    yaw: float = 0.0        # rotation about +y (radians); 0 = axis-aligned
    shape: str = "box"      # "box" | "sphere" (sphere uses size[0] as diameter)
    # optional procedural surface texture (the JAX package's ReID identity
    # latent dict); None renders the flat colour
    texture: dict | None = None

    def contains(self, pts: np.ndarray, tol: float = 1e-3) -> np.ndarray:
        """Membership test for world points (used by tests)."""
        local = (pts - self.center) @ _yaw_matrix(self.yaw)
        if self.shape == "sphere":
            return np.linalg.norm(local, axis=-1) <= self.size[0] / 2 + tol
        return np.all(np.abs(local) <= self.size / 2 + tol, axis=-1)


def _yaw_matrix(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


@dataclasses.dataclass
class SyntheticScene:
    boxes: list[Box]
    floor_y: float = 0.0
    floor_extent: float = 12.0     # floor spans [-e, e] x [-e, e] around origin
    floor_color: tuple = (0.45, 0.42, 0.4)


def default_scene(num_objects: int = 6, seed: int = 0) -> SyntheticScene:
    """A deterministic room: `num_objects` colored boxes in a ring on a floor."""
    rng = np.random.default_rng(seed)
    names = ["chair", "lamp", "plant", "sofa", "shelf", "toy",
             "vase", "bin", "stool", "crate", "barrel", "bench"]
    boxes = []
    for i in range(num_objects):
        angle = 2 * np.pi * i / num_objects
        radius = 2.0 + 0.5 * rng.uniform()
        size = rng.uniform(0.4, 0.9, size=3)
        shape = "sphere" if i % 3 == 2 else "box"  # geometric variety helps
        center = np.array([
            radius * np.cos(angle),
            size[1 if shape == "box" else 0] / 2.0,  # resting on the floor
            radius * np.sin(angle),
        ])
        color = np.array([0.2, 0.2, 0.2]) + 0.8 * rng.uniform(size=3)
        boxes.append(Box(center=center, size=size,
                         color=np.clip(color, 0, 1), name=names[i % len(names)],
                         yaw=float(rng.uniform(0, np.pi / 2)), shape=shape))
    return SyntheticScene(boxes=boxes)


def _texture_color(idp: dict, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Identity pattern color at object-local (u, v) — the same stripe /
    checker / ring math as cli.gen_synth_reid._render (phase 0: the world
    is static, nuisance variation comes from viewpoint/lighting at render
    time, not per-sample phase jitter)."""
    ca, sa = np.cos(idp["angle"]), np.sin(idp["angle"])
    t = (u * ca + v * sa) * idp["freq"]
    if idp["kind"] == 0:
        pat = 0.5 + 0.5 * np.sin(t)
    elif idp["kind"] == 1:
        t2 = (-u * sa + v * ca) * idp["freq"]
        pat = ((np.sin(t) > 0) ^ (np.sin(t2) > 0)).astype(np.float64)
    else:
        pat = 0.5 + 0.5 * np.sin(np.hypot(u, v) * idp["freq"] * 2.0)
    return (np.asarray(idp["base"])[None, :] * pat[:, None]
            + np.asarray(idp["second"])[None, :] * (1.0 - pat[:, None]))


def look_at_pose(eye: np.ndarray, target: np.ndarray, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """7-vec pose [t, q_xyzw] whose rotation maps camera axes
    (x right, y up, z forward) to world, looking from eye at target."""
    from scipy.spatial.transform import Rotation
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z = z / np.linalg.norm(z)
    up = np.asarray(up, np.float64)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    r = np.stack([x, y, z], axis=1)  # columns = camera axes in world
    q = Rotation.from_matrix(r).as_quat()
    return np.concatenate([eye, q]).astype(np.float32)


def ring_poses(n_views: int = 8, radius: float = 5.5, height: float = 1.2,
               target=(0.0, 0.5, 0.0)) -> list[np.ndarray]:
    poses = []
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        eye = np.array([radius * np.cos(a), height, radius * np.sin(a)])
        poses.append(look_at_pose(eye, np.asarray(target)))
    return poses


def render_scene(scene: SyntheticScene, pose7: np.ndarray,
                 height: int = 240, width: int = 320,
                 focal_length: float = 300.0, far: float = 40.0
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ray-cast depth + RGB + instance-id images from `pose7`.

    Returns (rgb uint8 (H,W,3), depth float32 (H,W), instance int32 (H,W))
    where instance = -1 background/none, -2 floor, i >= 0 box index.
    The ray through pixel (r, c) is the inverse of `ops.backprojection`:
    dir_cam = (h_c / fx, v_r / fy, 1) with the centered linspace grid.
    """
    from scipy.spatial.transform import Rotation

    fx = fy = float(focal_length)
    horizontal = np.linspace(-width / 2, width / 2, width, dtype=np.float64)
    vertical = np.linspace(height / 2, -height / 2, height, dtype=np.float64)
    hh, vv = np.meshgrid(horizontal, vertical)  # (H, W)
    dirs_cam = np.stack([hh / fx, vv / fy, np.ones_like(hh)], axis=-1)  # (H,W,3)

    t = pose7[:3].astype(np.float64)
    q = pose7[3:].astype(np.float64)
    r = Rotation.from_quat(q / np.linalg.norm(q)).as_matrix()
    dirs_world = dirs_cam @ r.T  # (H,W,3): world direction per unit camera z

    best_z = np.full((height, width), np.inf)
    inst = np.full((height, width), -1, np.int32)
    rgb = np.zeros((height, width, 3), np.float64)

    eps = 1e-12
    d = np.where(np.abs(dirs_world) < eps, eps, dirs_world)

    for i, box in enumerate(scene.boxes):
        ry = _yaw_matrix(box.yaw)
        o_local = (t - box.center) @ ry                     # ray origin, box frame
        d_local = dirs_world @ ry                            # (H, W, 3)
        if box.shape == "sphere":
            r2 = (box.size[0] / 2.0) ** 2
            aa = np.sum(d_local * d_local, axis=-1)
            bb = 2.0 * np.sum(d_local * o_local[None, None, :], axis=-1)
            cc = np.sum(o_local * o_local) - r2
            disc = bb * bb - 4 * aa * cc
            sqrt_disc = np.sqrt(np.maximum(disc, 0.0))
            z_near = (-bb - sqrt_disc) / np.maximum(2 * aa, eps)
            hit = (disc > 0) & (z_near > 1e-6) & (z_near < best_z) & (z_near < far)
        else:
            dl = np.where(np.abs(d_local) < eps, eps, d_local)
            half = box.size / 2.0
            t1 = (-half[None, None, :] - o_local[None, None, :]) / dl
            t2 = (half[None, None, :] - o_local[None, None, :]) / dl
            z_near = np.minimum(t1, t2).max(axis=-1)
            z_far = np.maximum(t1, t2).min(axis=-1)
            hit = (z_near <= z_far) & (z_near > 1e-6) & (z_near < best_z) & (z_near < far)
        best_z = np.where(hit, z_near, best_z)
        inst = np.where(hit, i, inst)
        if box.texture is None:
            rgb = np.where(hit[..., None], box.color[None, None, :], rgb)
        else:
            half = (box.size[0] / 2.0 if box.shape == "sphere"
                    else None)
            p_local = o_local[None, None, :] + z_near[..., None] * d_local
            if half is not None:
                u = p_local[..., 0] / half
                v = p_local[..., 1] / half
            else:
                u = p_local[..., 0] / (box.size[0] / 2.0)
                v = p_local[..., 1] / (box.size[1] / 2.0)
            tex = np.zeros_like(rgb)
            hm = hit
            tex[hm] = _texture_color(box.texture, u[hm], v[hm])
            rgb = np.where(hit[..., None], np.clip(tex, 0, 1), rgb)

    # floor plane y = floor_y, bounded extent
    z_floor = (scene.floor_y - t[1]) / d[..., 1]
    px = t[0] + z_floor * dirs_world[..., 0]
    pz = t[2] + z_floor * dirs_world[..., 2]
    e = scene.floor_extent
    hit_floor = ((z_floor > 1e-6) & (z_floor < best_z) & (z_floor < far)
                 & (np.abs(px) <= e) & (np.abs(pz) <= e))
    best_z = np.where(hit_floor, z_floor, best_z)
    inst = np.where(hit_floor, -2, inst)
    rgb = np.where(hit_floor[..., None], np.asarray(scene.floor_color)[None, None, :], rgb)

    depth = np.where(np.isfinite(best_z), best_z, 0.0).astype(np.float32)
    rgb_u8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    return rgb_u8, depth, inst
