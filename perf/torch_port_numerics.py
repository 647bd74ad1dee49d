"""Numerics of the closed-form Kabsch solve in the JAX package and in the
PyTorch port, on the CPU.

1. svd3x3 on rank-deficient input: 2000 covariances of random 3-point sets
   (every 3-point RANSAC hypothesis has one); counts the U factors that are not
   orthonormal (max |U Uᵀ - I| > 1e-3) in each package.
2. Kabsch accuracy on ill-conditioned clouds: 200 slab-shaped clouds
   (1 x 0.05 x 0.02 m, 500 points, a random rotation, 1 mm noise); the largest
   rotation-entry deviation from a float64 LAPACK SVD Kabsch of the JAX
   package's fp32 Kabsch, of the port's Kabsch (float64) and of the port's
   solve run in fp32 (`kabsch_solve`), and the largest deviation between the
   two fp32 solves.
3. Localisation over seeds: the 160x220, 5-object scene of
   tests/test_memory_e2e.py; the held-out view localised with 40 different
   random streams by the JAX package, by the port, and by the port with its
   Kabsch solved in fp32 as the reference solves it. Prints successes within
   the reference's gate (0.6 m, 0.3 rad) and the median and largest
   translation error.

Run: JAX_PLATFORMS=cpu python perf/torch_port_numerics.py
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import contextlib  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.spatial.transform import Rotation  # noqa: E402

from instance_based_loc_tpu.ops import eigen3 as jeig, kabsch as jkab  # noqa: E402
from instance_based_loc_tpu_torch.ops import (  # noqa: E402
    eigen3 as teig, icp as ticp, kabsch as tkab, localise_kernels as tlk,
    ransac as transac)


def svd_orthogonality():
    rng = np.random.default_rng(1)
    p = rng.normal(size=(2000, 3, 3)).astype(np.float32)
    q = rng.normal(size=(2000, 3, 3)).astype(np.float32)
    pc = p - p.mean(1, keepdims=True)
    qc = q - q.mean(1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", qc, pc).astype(np.float32)
    ju = np.asarray(jeig.svd3x3(jnp.asarray(cov))[0])
    tu = teig.svd3x3(torch.as_tensor(cov))[0].numpy()
    for name, u in (("jax", ju), ("port", tu)):
        err = np.abs(u @ np.swapaxes(u, -1, -2) - np.eye(3)).max((-1, -2))
        print(f"svd3x3 {name}: {(err > 1e-3).sum()} / 2000 U not "
              f"orthonormal, max |U U^T - I| {err.max():.3g}", flush=True)


def _lapack_kabsch(p, q):
    p, q = p.astype(np.float64), q.astype(np.float64)
    cov = (q - q.mean(0)).T @ (p - p.mean(0))
    u, _, vh = np.linalg.svd(cov)
    d = np.linalg.det(u) * np.linalg.det(vh)
    return u @ np.diag([1.0, 1.0, d]) @ vh


def kabsch_accuracy():
    rng = np.random.default_rng(2)
    worst = {"jax fp32": 0.0, "port": 0.0, "port fp32": 0.0}
    between = 0.0
    for _ in range(200):
        p = (rng.uniform(-0.5, 0.5, size=(500, 3))
             * np.array([1.0, 0.05, 0.02])).astype(np.float32)
        quat = rng.normal(size=4)
        rot = Rotation.from_quat(quat / np.linalg.norm(quat)).as_matrix()
        q = (p @ rot.T + rng.normal(size=3)
             + 0.001 * rng.normal(size=p.shape)).astype(np.float32)
        ref = _lapack_kabsch(p, q)
        rj = np.asarray(jkab.kabsch_transform(jnp.asarray(p),
                                              jnp.asarray(q)))[:3, :3]
        rt = tkab.kabsch_transform(torch.as_tensor(p),
                                   torch.as_tensor(q)).numpy()[:3, :3]
        rt32 = tkab.kabsch_solve(torch.as_tensor(p),
                                 torch.as_tensor(q)).numpy()[:3, :3]
        for name, r in (("jax fp32", rj), ("port", rt), ("port fp32", rt32)):
            worst[name] = max(worst[name], float(np.abs(r - ref).max()))
        between = max(between, float(np.abs(rt32 - rj).max()))
    for name, err in worst.items():
        print(f"kabsch {name}: max |R - R_lapack64| {err:.3g} over 200 "
              f"slab clouds", flush=True)
    print(f"kabsch port fp32 vs jax fp32: max |R_port - R_jax| {between:.3g}",
          flush=True)


@contextlib.contextmanager
def fp32_kabsch():
    """The port's modules solve Kabsch in fp32 while inside."""
    mods = (ticp, transac, tlk)
    saved = [m.kabsch_transform for m in mods]
    for m in mods:
        m.kabsch_transform = tkab.kabsch_solve
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.kabsch_transform = f


def localisation_over_seeds(n_seeds=40):
    from instance_based_loc_tpu.data.synthetic import (
        default_scene, render_scene, ring_poses)
    from instance_based_loc_tpu.memory import (
        ObjectMemory as JaxMemory, ColorRegionDetector as JaxDetector)
    from instance_based_loc_tpu.models.embedders import (
        get_embedder as jax_embedder)
    from instance_based_loc_tpu.ops.transforms import quaternion_error
    from instance_based_loc_tpu_torch.memory import (
        ObjectMemory, ColorRegionDetector)
    from instance_based_loc_tpu_torch.models.embedders import get_embedder

    focal, h, w = 200.0, 160, 220
    scene = default_scene(num_objects=5, seed=3)
    poses = ring_poses(7, radius=4.5, height=1.3, target=(0, 0.4, 0))
    frames = [render_scene(scene, p, h, w, focal) for p in poses]
    builds = {
        "jax": lambda: JaxMemory(
            detector=JaxDetector(min_area=80,
                                 floor_colors=[scene.floor_color]),
            camera_focal_lenth_x=focal, camera_focal_lenth_y=focal,
            get_embeddings_func=jax_embedder("color"), log_enabled=False),
        "port": lambda: ObjectMemory(
            detector=ColorRegionDetector(min_area=80,
                                         floor_colors=[scene.floor_color]),
            camera_focal_lenth_x=focal, camera_focal_lenth_y=focal,
            get_embeddings_func=get_embedder("color"), log_enabled=False,
            device="cpu"),
    }
    builds["port fp32 kabsch"] = builds["port"]
    for name, make in builds.items():
        with (fp32_kabsch() if name == "port fp32 kabsch"
              else contextlib.nullcontext()):
            _localise_seeds(name, make, frames, poses, n_seeds,
                            quaternion_error)


def _localise_seeds(name, make, frames, poses, n_seeds, quaternion_error):
    memory = make()
    for i in range(6):
        rgb, depth, _ = frames[i]
        memory.process_image(rgb, depth, poses[i], consider_floor=True,
                             min_points=200, outlier_removal_config=None)
    memory.downsample_all_objects(voxel_size=0.02)
    memory.recluster_objects_with_dbscan(eps=0.1,
                                         min_points_per_cluster=40)
    rgb, depth, _ = frames[6]
    errs = []
    for seed in range(n_seeds):
        memory._frame_counter = seed     # the query's random stream
        est, _ = memory.localise(rgb, depth, outlier_removal_config=None)
        te = float(np.linalg.norm(est[:3] - poses[6][:3]))
        re_ = float(quaternion_error(jnp.asarray(poses[6][3:]),
                                     jnp.asarray(est[3:], jnp.float32)))
        errs.append((te, re_))
    ok = sum(te < 0.6 and re_ < 0.3 for te, re_ in errs)
    te = sorted(e[0] for e in errs)
    print(f"localise {name}: {ok} / {n_seeds} within the gate, trans "
          f"median {np.median(te):.3f} m, max {te[-1]:.3f} m", flush=True)


if __name__ == "__main__":
    svd_orthogonality()
    kabsch_accuracy()
    localisation_over_seeds()
