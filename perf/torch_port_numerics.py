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
3. Localisation over random streams (`e2e`): the 160x220, 5-object scene
   of tests/test_memory_e2e.py, 40 streams. The held-out view is localised
   by the JAX package and by the port with its Kabsch solves as shipped
   (float64 in RANSAC and the centroid init, fp32 in ICP), all in float64,
   and all in fp32 (the reference's arithmetic). Prints successes within
   the reference's gate (0.6 m, 0.3 rad) and the median and largest
   translation error.
4. The same over 48 streams (`cli`) on the 7-view 120x160 TUM dataset of
   tests/test_torch_cli.py, against three memories that its trial CLI
   builds: the port's, the JAX package's by its numpy path, and the JAX
   package's with its compiled helpers (see `cli_scene_over_seeds`).

Run: JAX_PLATFORMS=cpu python perf/torch_port_numerics.py [svd kabsch e2e cli]
(the parts named, all by default).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import contextlib  # noqa: E402
import pickle  # noqa: E402
import sys  # noqa: E402

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
def kabsch_in(precision: str):
    """The port's Kabsch solves while inside: "shipped" (float64 in RANSAC
    and the centroid init, fp32 in ICP), "float64" (ICP too) or "fp32"
    (all three, the reference's arithmetic)."""
    solve = {"float64": tkab.kabsch_transform, "fp32": tkab.kabsch_solve}
    saved = (ticp.kabsch_solve, transac.kabsch_transform,
             tlk.kabsch_transform)
    if precision == "float64":
        ticp.kabsch_solve = solve["float64"]
    elif precision == "fp32":
        transac.kabsch_transform = tlk.kabsch_transform = solve["fp32"]
    try:
        yield
    finally:
        (ticp.kabsch_solve, transac.kabsch_transform,
         tlk.kabsch_transform) = saved


def _packages(scene, focal):
    from instance_based_loc_tpu.memory import (
        ObjectMemory as JaxMemory, ColorRegionDetector as JaxDetector)
    from instance_based_loc_tpu.models.embedders import (
        get_embedder as jax_embedder)
    from instance_based_loc_tpu_torch.memory import (
        ObjectMemory, ColorRegionDetector)
    from instance_based_loc_tpu_torch.models.embedders import get_embedder
    return {
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


VARIANTS = (("jax", None), ("port", "shipped"), ("port", "float64"),
            ("port", "fp32"))


def localisation_over_seeds(n_seeds=40):
    """The 5-object 160x220 scene of tests/test_memory_e2e.py: views 0-5
    built, DBSCAN reclustering, view 6 localised."""
    from instance_based_loc_tpu.data.synthetic import (
        default_scene, render_scene, ring_poses)
    focal, h, w = 200.0, 160, 220
    scene = default_scene(num_objects=5, seed=3)
    poses = ring_poses(7, radius=4.5, height=1.3, target=(0, 0.4, 0))
    frames = [render_scene(scene, p, h, w, focal) for p in poses]
    makes = _packages(scene, focal)
    for package, precision in VARIANTS:
        memory = makes[package]()
        for i in range(6):
            rgb, depth, _ = frames[i]
            memory.process_image(rgb, depth, poses[i], consider_floor=True,
                                 min_points=200, outlier_removal_config=None)
        memory.downsample_all_objects(voxel_size=0.02)
        memory.recluster_objects_with_dbscan(eps=0.1,
                                             min_points_per_cluster=40)
        rgb, depth, _ = frames[6]
        with (kabsch_in(precision) if precision
              else contextlib.nullcontext()):
            _localise_seeds(f"e2e scene, {package} {precision or ''}",
                            memory, rgb, depth, poses[6], n_seeds, {})


@contextlib.contextmanager
def jax_compiled_helpers(on: bool):
    """The JAX package builds with its compiled helpers (voxel grid, DBSCAN,
    radius outliers) while inside if `on`, else by its numpy path, which
    the port follows."""
    from instance_based_loc_tpu.ops import native
    names = ("voxel_downsample_native", "dbscan_native",
             "radius_outlier_native")
    saved = [getattr(native, n) for n in names]
    if not on:
        for n in names:
            setattr(native, n, lambda *a, **k: None)
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(native, n, f)


def cli_scene_over_seeds(n_seeds=48):
    """The 7-view 120x160 TUM dataset of tests/test_torch_cli.py (the JAX
    writer's), built as the trial CLI builds it (clustering_and_IoU
    reclustering) three times: by the port, by the JAX package by its
    numpy path, and by the JAX package with its compiled helpers (its
    default). View 5 is localised against each memory. The port's memory
    and the JAX numpy path's differ only by fp32 rounding (printed), so
    what that changes in either package's count is the count's noise."""
    import tempfile
    from instance_based_loc_tpu.cli import localisation_trial as jlt
    from instance_based_loc_tpu.data.loader import RGBDDataset as JaxDataset
    from instance_based_loc_tpu.data.synthetic import (default_scene,
                                                       write_tum_dataset)
    from instance_based_loc_tpu_torch.cli import localisation_trial as lt
    from instance_based_loc_tpu_torch.data.loader import RGBDDataset
    scene = default_scene(num_objects=4, seed=5)
    flags = ["-e", "5", "--consider-floor", "--min-points", "150",
             "--focal-length", "150", "--sampling-period", "1",
             "--downsample-voxel-size", "0.02", "--dbscan-eps", "0.1",
             "--dbscan-min-points", "40", "--quiet"]
    with tempfile.TemporaryDirectory() as tmp:
        write_tum_dataset(tmp, scene=scene, n_views=7, height=120,
                          width=160, focal_length=150.0)
        flags = ["--convention", "tum", "--data-path", tmp, *flags]
        makes = _packages(scene, 150.0)
        ds = RGBDDataset(tmp, [5], convention="tum", focal_length_x=150.0,
                         focal_length_y=150.0, sampling_period=1,
                         build_map=False, device="cpu")
        port = makes["port"]()
        lt.build_memory(lt.apply_convention_defaults(lt.make_parser()
                        .parse_args(flags + ["--device", "cpu"])),
                        port, ds, None)
        paths = {"port memory": f"{tmp}/port.pkl"}
        port.save_to_pkl(paths["port memory"])
        jds = JaxDataset(tmp, [5], convention="tum", focal_length_x=150.0,
                         focal_length_y=150.0, sampling_period=1,
                         build_map=False)
        jargs = jlt.apply_convention_defaults(jlt.make_parser()
                                              .parse_args(flags))
        for name, on in (("JAX memory, numpy path", False),
                         ("JAX memory, compiled helpers", True)):
            memory = makes["jax"]()
            with jax_compiled_helpers(on):
                jlt.build_memory(jargs, memory, jds, None)
            paths[name] = f"{tmp}/{len(paths)}.pkl"
            memory.save_to_pkl(paths[name])
        clouds = {}
        for name, path in paths.items():
            with open(path, "rb") as f:
                clouds[name] = [o[1] for o in pickle.load(f)["memory"]]
        a, b = clouds["port memory"], clouds["JAX memory, numpy path"]
        gap = (max(float(np.abs(x - y).max()) for x, y in zip(a, b))
               if [len(x) for x in a] == [len(y) for y in b] else None)
        print(f"CLI scene: port memory vs the JAX numpy path's: "
              f"{[len(x) for x in a]} vs {[len(y) for y in b]} points, "
              f"max |diff| {gap}; compiled helpers: "
              f"{[len(x) for x in clouds['JAX memory, compiled helpers']]}",
              flush=True)
        rgb, depth, target = ds.get_image_data(5)
        rgb, depth = port.load_rgb_image_func(rgb), \
            port.load_depth_image_func(depth)
        kwargs = dict(depth_factor=5000.0, fpfh_global_dist_factor=2.0,
                      fpfh_local_dist_factor=0.4, fpfh_voxel_size=0.05)
        runs = [("port memory", package, precision)
                for package, precision in VARIANTS]
        runs += [(name, package, precision) for name in paths
                 if name != "port memory"
                 for package, precision in VARIANTS[:2]]
        for name, package, precision in runs:
            memory = makes[package]()
            memory.load(paths[name])
            with (kabsch_in(precision) if precision
                  else contextlib.nullcontext()):
                _localise_seeds(f"CLI scene, {name}, {package} "
                                f"{precision or ''}", memory, rgb, depth,
                                target, n_seeds, kwargs)


def _localise_seeds(name, memory, rgb, depth, target, n_seeds, kwargs):
    from instance_based_loc_tpu.ops.transforms import quaternion_error
    errs = []
    for seed in range(n_seeds):
        memory._frame_counter = seed     # the query's random stream
        est, _ = memory.localise(rgb, depth, outlier_removal_config=None,
                                 **kwargs)
        te = float(np.linalg.norm(est[:3] - np.asarray(target)[:3]))
        re_ = float(quaternion_error(jnp.asarray(target[3:], jnp.float32),
                                     jnp.asarray(est[3:], jnp.float32)))
        errs.append((te, re_))
    ok = sum(te < 0.6 and re_ < 0.3 for te, re_ in errs)
    te = sorted(e[0] for e in errs)
    print(f"localise {name}: {ok} / {n_seeds} within the gate, trans "
          f"median {np.median(te):.3f} m, max {te[-1]:.3f} m", flush=True)


PARTS = {"svd": svd_orthogonality, "kabsch": kabsch_accuracy,
         "e2e": localisation_over_seeds, "cli": cli_scene_over_seeds}

if __name__ == "__main__":
    for part in sys.argv[1:] or PARTS:
        PARTS[part]()
