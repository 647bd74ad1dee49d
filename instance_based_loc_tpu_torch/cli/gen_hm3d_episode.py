"""HM3D-layout episode generator (counterpart of
`instance_based_loc_tpu/cli/gen_hm3d_episode.py`).

The reference renders Habitat-Sim episodes of HM3D scenes into `rgb/`,
`depth/` and `poses.npy`. This CLI writes a random-walk agent trajectory
(move forward or turn, like the shortest-path follower's actions) through
the procedural synthetic renderer in that exact layout: PNG colour frames,
float32 `.npy` depth (depth factor 1), `poses.npy` with the pose[-2] sign
flip the loader's hm3d convention undoes, and `episode_info.txt`. The same
arguments give the same draws and files as the JAX package's CLI; PNGs are
written by the port's own codec (`utils/png.py`), so no image library is
needed.

    python -m instance_based_loc_tpu_torch.cli.gen_hm3d_episode \\
        --out /tmp/hm3d_ep --timesteps 40
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.synthetic import default_scene, look_at_pose, render_scene
from ..utils.png import write_png


def generate_episode(out_dir: str, timesteps: int = 40, seed: int = 0,
                     height: int = 240, width: int = 320,
                     focal: float = 300.0):
    """Render a random-walk episode of `timesteps` frames into `out_dir`."""
    rng = np.random.default_rng(seed)
    scene = default_scene(num_objects=6, seed=seed)
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)

    poses = []
    pos = np.array([0.0, 1.2, 4.5])
    yaw = np.pi
    for t in range(timesteps):
        action = rng.choice(["forward", "left", "right"], p=[0.6, 0.2, 0.2])
        if action == "forward":
            step = 0.25 * np.array([np.sin(yaw), 0.0, np.cos(yaw)])
            nxt = pos + step
            if np.linalg.norm(nxt[[0, 2]]) < 5.5:     # stay in the room
                pos = nxt
        elif action == "left":
            yaw += np.deg2rad(15)
        else:
            yaw -= np.deg2rad(15)
        target = pos + np.array([np.sin(yaw), -0.05, np.cos(yaw)])
        pose = look_at_pose(pos, target)
        rgb, depth, _ = render_scene(scene, pose, height, width, focal)
        write_png(os.path.join(out_dir, "rgb", f"frame_{t:05d}.png"), rgb)
        np.save(os.path.join(out_dir, "depth", f"frame_{t:05d}.npy"),
                depth.astype(np.float32))
        stored = np.asarray(pose, np.float64).copy()
        stored[-2] *= -1   # inverse of the loader's hm3d sign fix
        poses.append(stored)
    np.save(os.path.join(out_dir, "poses.npy"), np.stack(poses))
    with open(os.path.join(out_dir, "episode_info.txt"), "w") as f:
        f.write(f"synthetic hm3d-layout episode\ntimesteps={timesteps}\n"
                f"focal={focal}\nheight={height}\nwidth={width}\nseed={seed}\n")
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--timesteps", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--focal", type=float, default=300.0)
    args = p.parse_args(argv)
    generate_episode(args.out, args.timesteps, args.seed, args.height,
                     args.width, args.focal)
    print(f"episode written to {args.out}")


if __name__ == "__main__":
    main()
