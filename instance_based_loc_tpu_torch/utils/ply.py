"""Minimal binary-PLY point cloud I/O (copy of
`instance_based_loc_tpu/utils/ply.py`; replaces Open3D's
write_point_cloud / read_point_cloud for the memory and debug dumps)."""

from __future__ import annotations

import numpy as np


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    has_color = colors is not None and len(colors) == n
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += ["end_header"]

    if has_color:
        cols = np.clip(np.asarray(colors, np.float64).reshape(-1, 3), 0, 1)
        cols_u8 = (cols * 255).astype(np.uint8)
        dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                          ("red", "u1"), ("green", "u1"), ("blue", "u1")])
        rec = np.empty(n, dtype)
        rec["x"], rec["y"], rec["z"] = points.T
        rec["red"], rec["green"], rec["blue"] = cols_u8.T
    else:
        dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
        rec = np.empty(n, dtype)
        rec["x"], rec["y"], rec["z"] = points.T

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    with open(path, "rb") as f:
        props = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                _, typ, name = line.split()
                props.append((name, {"float": "<f4", "uchar": "u1"}[typ]))
            elif line == "end_header":
                break
        rec = np.fromfile(f, dtype=np.dtype(props), count=n)
    points = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(np.float32)
    colors = None
    if "red" in rec.dtype.names:
        colors = np.stack([rec["red"], rec["green"], rec["blue"]],
                          axis=-1).astype(np.float32) / 255.0
    return points, colors
