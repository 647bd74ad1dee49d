"""The port's data path against the JAX package's (and PIL's), on inputs
made with numpy from a seed:

* PNG codec (`utils/png.py`) against PIL, the oracle here: PIL-written
  8-bit RGB, RGBA, grey, grey-alpha and 16-bit grey frames decode exactly;
  a frame whose rows use each of the five filter types decodes exactly;
  the port's files read back through PIL exactly; palette, interlaced and
  other bit depths raise.
* `RGBDDataset` in all five conventions against the JAX loader, on datasets
  that the JAX writers write or on pose files built as `test_data.py`
  builds them: paths, environment indices and depth arrays exact, poses
  within 1e-12; the synth and tum map clouds equal as point sets within
  1e-5 (each point matched one to one with its nearest counterpart).
* The frustum cull and the device voxel grid against JAX at 1e-6, rows in
  the same order.
* The dataset writers: the port's and JAX's give equal decoded frames and
  equal pose files; the two hm3d episode generators (`cli/gen_hm3d_episode`)
  give equal decoded frames and byte-identical `.npy` depth, `poses.npy`
  and `episode_info.txt`, and each loader reads its own package's episode
  alike (poses within 1e-12, depth and pixels exact).
* `format_results_report`: identical text; `pose_errors` within 1e-6.
* ply: round trips between the two packages in both directions.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image
from scipy.spatial import cKDTree

from instance_based_loc_tpu.data import loader as jloader
from instance_based_loc_tpu.data import synthetic as jsyn
from instance_based_loc_tpu.ops import frustum as jfrustum
from instance_based_loc_tpu.ops import native as jnative
from instance_based_loc_tpu.ops import voxel as jvoxel
from instance_based_loc_tpu.ops.pointcloud import PointCloud
from instance_based_loc_tpu.utils import metrics as jmetrics
from instance_based_loc_tpu.utils import ply as jply
from instance_based_loc_tpu_torch.data import loader as tloader
from instance_based_loc_tpu_torch.data import synthetic as tsyn
from instance_based_loc_tpu_torch.ops import frustum as tfrustum
from instance_based_loc_tpu_torch.ops import voxel as tvoxel
from instance_based_loc_tpu_torch.utils import metrics as tmetrics
from instance_based_loc_tpu_torch.utils import ply as tply
from instance_based_loc_tpu_torch.utils.png import read_png, write_png


# --------------------------------------------------------------------------- #
# PNG codec
# --------------------------------------------------------------------------- #
def _frame(rng, h=37, w=53):
    """A rendered frame (flat regions, edges) plus noise in one corner, so
    PIL's per-row filter choice varies."""
    scene = jsyn.default_scene(num_objects=4, seed=1)
    rgb, depth, _ = jsyn.render_scene(scene, jsyn.ring_poses(4)[1], h, w,
                                      60.0)
    rgb[:8, :8] = rng.integers(0, 256, size=(8, 8, 3))
    return rgb, depth


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "I;16"])
def test_png_reads_pil_files_exactly(tmp_path, mode):
    rng = np.random.default_rng(len(mode))
    rgb, depth = _frame(rng)
    if mode == "RGB":
        arr = rgb
    elif mode == "RGBA":
        arr = np.concatenate([rgb, rng.integers(0, 256, rgb.shape[:2] + (1,),
                                                dtype=np.uint8)], -1)
    elif mode == "L":
        arr = rgb[..., 0]
    elif mode == "LA":
        arr = rgb[..., :2]
    else:
        arr = np.clip(depth * 5000, 0, 65535).astype(np.uint16)
    path = str(tmp_path / "f.png")
    Image.fromarray(arr, None if mode != "LA" else "LA").save(path)
    ref = np.asarray(Image.open(path))
    out = read_png(path)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def _filter_row(row, prev, ftype, bpp):
    """The PNG encoder's filter of one row (uint8 arrays of one row)."""
    x = row.astype(np.int32)
    b = prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) // 2
    else:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 0xFF).astype(np.uint8)


def _png_file(path, pixels, colour, depth, ftypes, interlace=0):
    """Write a PNG whose row r is filtered with ftypes[r]."""
    h, w = pixels.shape[:2]
    if depth == 16:
        data = pixels.astype(">u2").view(np.uint8).reshape(h, -1)
    else:
        data = pixels.reshape(h, -1)
    bpp = max(1, data.shape[1] // w)
    rows, prev = [], np.zeros(data.shape[1], np.uint8)
    for r in range(h):
        rows.append(bytes([ftypes[r]])
                    + _filter_row(data[r], prev, ftypes[r], bpp).tobytes())
        prev = data[r]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                             0, 0, interlace))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb", "depth16"])
def test_png_reads_every_filter_type(tmp_path, kind):
    rng = np.random.default_rng(7)
    rgb, depth = _frame(rng)
    if kind == "rgb":
        pixels, colour, bits = rgb, 2, 8
    else:
        pixels, colour, bits = np.clip(depth * 5000, 0, 65535).astype(
            np.uint16), 0, 16
    ftypes = [r % 5 for r in range(len(pixels))]
    path = str(tmp_path / "f.png")
    _png_file(path, pixels, colour, bits, ftypes)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), pixels)
    np.testing.assert_array_equal(read_png(path), pixels)
    # and every row with one filter type: the row-wise path
    for ftype in range(5):
        _png_file(path, pixels, colour, bits, [ftype] * len(pixels))
        np.testing.assert_array_equal(read_png(path), pixels)


def test_png_writer_reads_back_through_pil(tmp_path):
    rng = np.random.default_rng(3)
    rgb, depth = _frame(rng)
    d16 = np.clip(depth * 5000, 0, 65535).astype(np.uint16)
    d16[0, :5] = [0, 1, 255, 256, 65535]
    for arr in (rgb, d16):
        path = str(tmp_path / "w.png")
        write_png(path, arr)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
        np.testing.assert_array_equal(read_png(path), arr)
    with pytest.raises(ValueError):
        write_png(path, rgb.astype(np.float32))


def test_png_rejects_what_it_cannot_read(tmp_path):
    rgb, _ = _frame(np.random.default_rng(4))
    path = str(tmp_path / "p.png")
    Image.fromarray(rgb).convert("P").save(path)        # palette
    with pytest.raises(ValueError, match="colour type 3"):
        read_png(path)
    _png_file(path, rgb, 2, 8, [0] * len(rgb), interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        read_png(path)
    Image.fromarray(rgb[..., 0] > 100).save(path)       # 1-bit grey
    with pytest.raises(ValueError, match="bit depth 1"):
        read_png(path)
    with open(path, "wb") as f:
        f.write(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(path)


# --------------------------------------------------------------------------- #
# writers
# --------------------------------------------------------------------------- #
def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for sub in ("rgb", "depth"):
        files = sorted(os.listdir(os.path.join(a, sub)))
        assert files == sorted(os.listdir(os.path.join(b, sub)))
        for f in files:
            pa, pb = os.path.join(a, sub, f), os.path.join(b, sub, f)
            if f.endswith(".npy"):
                np.testing.assert_array_equal(np.load(pa), np.load(pb))
            else:
                np.testing.assert_array_equal(np.asarray(Image.open(pa)),
                                              read_png(pb))
    for f in names:
        if f not in ("rgb", "depth"):
            with open(os.path.join(a, f)) as fa, \
                    open(os.path.join(b, f)) as fb:
                assert fa.read() == fb.read(), f


@pytest.mark.parametrize("layout", ["synth", "tum"])
def test_writers_match_jax(tmp_path, layout):
    writer = {"synth": "write_synth_dataset", "tum": "write_tum_dataset"}
    kw = dict(n_views=3, height=48, width=64, focal_length=60.0)
    getattr(jsyn, writer[layout])(str(tmp_path / "jax"),
                                  jsyn.default_scene(4, seed=2), **kw)
    getattr(tsyn, writer[layout])(str(tmp_path / "port"),
                                  tsyn.default_scene(4, seed=2), **kw)
    _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_textured_scene_and_sense_of_depthmap_match_jax():
    js, ts = jsyn.textured_scene(5, seed=3, id_seed=1), \
        tsyn.textured_scene(5, seed=3, id_seed=1)
    pose = jsyn.ring_poses(5)[0]
    for a, b in zip(jsyn.render_scene(js, pose, 40, 56, 50.0),
                    tsyn.render_scene(ts, pose, 40, 56, 50.0)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(9)
    pts = np.concatenate([rng.uniform(-1, 1, (200, 2)),
                          rng.uniform(1, 4, (200, 1))], 1)
    np.testing.assert_array_equal(
        tsyn.get_sense_of_depthmap_from_pointcloud(pts, 40, 56, 50.0, 50.0),
        jsyn.get_sense_of_depthmap_from_pointcloud(pts, 40, 56, 50.0, 50.0))


# --------------------------------------------------------------------------- #
# the loader, five conventions
# --------------------------------------------------------------------------- #
def _blank_frames(root, n):
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.default_rng(n)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(
            os.path.join(root, "rgb", f"frame_{i:04d}.png"))
        Image.fromarray(rng.integers(0, 9000, (8, 8)).astype(np.uint16)).save(
            os.path.join(root, "depth", f"frame_{i:04d}.png"))


def _make_dataset(root, convention):
    """A dataset of `convention` (written by the JAX writers where the JAX
    package has one) and the loader arguments it takes."""
    rng = np.random.default_rng(11)
    if convention in ("synth", "tum"):
        writer = (jsyn.write_synth_dataset if convention == "synth"
                  else jsyn.write_tum_dataset)
        writer(root, jsyn.default_scene(4, seed=5), n_views=5, height=72,
               width=96, focal_length=90.0)
        # a radius that this coarse depth's pixel spacing (~5 cm) fills
        return dict(evaluation_indices=[3], focal_length_x=90.0,
                    focal_length_y=90.0, sampling_period=1,
                    map_outlier_config={"radius": 0.2,
                                        "radius_nb_points": 12})
    if convention == "hm3d":
        from instance_based_loc_tpu.cli.gen_hm3d_episode import (
            generate_episode)
        generate_episode(root, timesteps=5, seed=1, height=24, width=32,
                         focal=30.0)
        return dict(evaluation_indices=[4], focal_length_x=30.0,
                    focal_length_y=30.0, build_map=False)
    _blank_frames(root, 4)
    if convention == "real":
        rows = ["timestamp tx ty tz qx qy qz qw extra"]
        for i in range(4):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            pose = np.concatenate([rng.uniform(-2, 2, 3), q])
            rows.append(f"{i}.0 " + " ".join(f"{v:.9f}" for v in pose)
                        + " 99")
        with open(os.path.join(root, "poses_odom.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
        return dict(evaluation_indices=[1, 2], focal_length_x=100.0,
                    focal_length_y=100.0, build_map=False)
    os.makedirs(os.path.join(root, "pose"))
    for i in range(4):
        t, e = rng.uniform(-3, 3, 3), rng.uniform(-40, 40, 3)
        with open(os.path.join(root, "pose", f"frame_{i:04d}.txt"), "w") as f:
            f.write(repr([{"x": float(t[0]), "y": float(t[1]),
                           "z": float(t[2])},
                          {"x": float(e[0]), "y": float(e[1]),
                           "z": float(e[2])}]))
    return dict(evaluation_indices=[0], focal_length_x=100.0,
                focal_length_y=100.0, rot_correction=5.0,
                start_file_index=1)


@pytest.mark.parametrize("convention", ["synth", "tum", "real", "8room",
                                        "hm3d"])
def test_loader_matches_jax(tmp_path, monkeypatch, convention):
    root = str(tmp_path / convention)
    kw = _make_dataset(root, convention)
    # the JAX package's own device kernel for the map's outliers, not its
    # compiled host helper
    monkeypatch.setattr(jnative, "radius_outlier_native",
                        lambda *a, **k: None)
    jds = jloader.RGBDDataset(root, convention=convention, **kw)
    tds = tloader.RGBDDataset(root, convention=convention, device="cpu",
                              **kw)
    assert len(tds) == len(jds) and tds.depth_factor == jds.depth_factor
    assert tds.environment_indices == jds.environment_indices
    for i in range(len(jds)):
        jr, jd, jp = jds.get_image_data(i)
        tr, td, tp = tds.get_image_data(i)
        assert (tr, td) == (jr, jd)
        np.testing.assert_allclose(tp, jp, atol=1e-12, rtol=0)
        np.testing.assert_array_equal(tds.load_depth_scaled(i),
                                      jds.load_depth_scaled(i))
        np.testing.assert_array_equal(tloader.load_rgb(tr),
                                      jloader.load_rgb(jr))
    if jds.map_pointcloud is None:
        assert tds.map_pointcloud is None
        return
    jp, jc = jds.map_pointcloud.to_numpy()
    tp, tc = (x.numpy() for x in tds.get_pointcloud())
    assert len(jp) > 100 and tp.shape == jp.shape
    # equal as point sets: each port point's nearest JAX point within
    # 1e-5 (a sort would reorder rows whose keys differ by 1 ulp)
    dist, match = cKDTree(jp).query(tp)
    assert dist.max() <= 1e-5
    assert len(np.unique(match)) == len(jp)          # one to one
    np.testing.assert_allclose(tc, jc[match], atol=1e-5)
    # the visible part from an eval pose, camera frame, capacity kept
    pose = jds.get_image_data(kw["evaluation_indices"][0])[2]
    jv = jds.get_visible_pointcloud(pose, 60.0, 0.1, 6.0)
    vp, _, vm = tds.get_visible_pointcloud(pose, 60.0, 0.1, 6.0)
    jvp, jvm = np.asarray(jv.points)[match], np.asarray(jv.mask)[match]
    assert vm.sum() > 0
    np.testing.assert_array_equal(vm.numpy(), jvm)
    np.testing.assert_allclose(vp.numpy(), jvp, atol=1e-5)
    # the .npz cache round trip
    cache = str(tmp_path / "map.npz")
    tloader.RGBDDataset(root, convention=convention, device="cpu",
                        map_pointcloud_cache_path=cache, **kw)
    again = tloader.RGBDDataset(root, convention=convention, device="cpu",
                                map_pointcloud_cache_path=cache, **kw)
    np.testing.assert_array_equal(again.get_pointcloud()[0].numpy(), tp)


# --------------------------------------------------------------------------- #
# frustum and device voxel grid
# --------------------------------------------------------------------------- #
def test_frustum_matches_jax():
    rng = np.random.default_rng(21)
    pts = rng.uniform(-4, 4, (3000, 3)).astype(np.float32)
    mask = rng.uniform(size=3000) < 0.9
    pose = jsyn.ring_poses(6)[2]
    jcam, jvis = jfrustum.visible_mask(jnp.asarray(pts), jnp.asarray(mask),
                                       jnp.asarray(pose), 70.0, 0.2, 5.0)
    tcam, tvis = tfrustum.visible_mask(torch.as_tensor(pts),
                                       torch.as_tensor(mask),
                                       torch.as_tensor(pose), 70.0, 0.2, 5.0)
    np.testing.assert_allclose(tcam.numpy(), np.asarray(jcam), atol=1e-6)
    np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
    assert 0 < tvis.sum() < mask.sum()
    cloud = jfrustum.get_visible_pointcloud(
        PointCloud(jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(mask)),
        pose, 70.0, 0.2, 5.0)
    p, c, m = tfrustum.get_visible_pointcloud(
        torch.as_tensor(pts), torch.as_tensor(pts), torch.as_tensor(mask),
        pose, 70.0, 0.2, 5.0)
    np.testing.assert_allclose(p.numpy(), np.asarray(cloud.points), atol=1e-6)
    np.testing.assert_array_equal(m.numpy(), np.asarray(cloud.mask))


@pytest.mark.parametrize("voxel", [0.1, 0.025])
def test_device_voxel_grid_matches_jax(voxel):
    rng = np.random.default_rng(int(voxel * 1000))
    pts = np.concatenate([rng.uniform(-1, 1, (1500, 3)),
                          rng.uniform(-3, -2.9, (500, 3))]).astype(np.float32)
    cols = rng.uniform(size=(2000, 3)).astype(np.float32)
    mask = rng.uniform(size=2000) < 0.8
    out = jvoxel.voxel_downsample(PointCloud(jnp.asarray(pts),
                                             jnp.asarray(cols),
                                             jnp.asarray(mask)), voxel)
    tp, tc, tm = tvoxel.voxel_downsample(torch.as_tensor(pts),
                                         torch.as_tensor(cols),
                                         torch.as_tensor(mask), voxel)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(out.mask))
    np.testing.assert_allclose(tp.numpy(), np.asarray(out.points), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(out.colors), atol=1e-6)
    np.testing.assert_array_equal(
        tvoxel.voxel_coords(torch.as_tensor(pts), voxel,
                            torch.as_tensor(mask)).numpy(),
        np.asarray(jvoxel.voxel_coords(jnp.asarray(pts), voxel,
                                       jnp.asarray(mask))))
    jpp, jpm = jvoxel.voxel_downsample_points(jnp.asarray(pts),
                                              jnp.asarray(mask), voxel)
    tpp, tpm = tvoxel.voxel_downsample_points(torch.as_tensor(pts),
                                              torch.as_tensor(mask), voxel)
    np.testing.assert_array_equal(tpm.numpy(), np.asarray(jpm))
    np.testing.assert_allclose(tpp.numpy(), np.asarray(jpp), atol=1e-6)


# --------------------------------------------------------------------------- #
# metrics and ply
# --------------------------------------------------------------------------- #
def test_results_report_and_pose_errors_match_jax():
    rng = np.random.default_rng(5)
    truth = [np.concatenate([rng.normal(size=3), q / np.linalg.norm(q)])
             for q in rng.normal(size=(6, 4))]
    est = [t + np.concatenate([rng.normal(scale=0.4, size=3),
                               rng.normal(scale=0.2, size=4)])
           for t in truth]
    errs_j = [jmetrics.pose_errors(t, e) for t, e in zip(truth, est)]
    errs_t = [tmetrics.pose_errors(t, e) for t, e in zip(truth, est)]
    np.testing.assert_allclose(errs_t, errs_j, atol=1e-6)
    assert ([tmetrics.is_success(*e) for e in errs_j]
            == [jmetrics.is_success(*e) for e in errs_j])
    te, re_ = zip(*errs_j)
    assns = [[[[0, 1], [2, 3]], None]] * 3 + [[[], []]] * 3
    for args in ((te, re_), (te, re_, assns), ([], [])):
        assert (tmetrics.format_results_report(*args)
                == jmetrics.format_results_report(*args))


def test_ply_round_trips_between_packages(tmp_path):
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    cols = rng.uniform(size=(100, 3)).astype(np.float32)
    for colors in (cols, None):
        for write, read in ((tply.write_ply, jply.read_ply),
                            (jply.write_ply, tply.read_ply),
                            (tply.write_ply, tply.read_ply)):
            path = str(tmp_path / "c.ply")
            write(path, pts, colors)
            p, c = read(path)
            np.testing.assert_array_equal(p, pts)
            if colors is None:
                assert c is None
            else:
                np.testing.assert_allclose(c, cols, atol=1 / 255)


def test_hm3d_episode_generators_match(tmp_path):
    """The port's gen_hm3d_episode against the JAX CLI: equal decoded
    frames, equal `.npy` depth bytes, `poses.npy` and `episode_info.txt`;
    then the port's loader reads the port's episode as the JAX loader
    reads the JAX one (paths aside, exactly)."""
    from instance_based_loc_tpu.cli.gen_hm3d_episode import (
        generate_episode as jgen)
    from instance_based_loc_tpu_torch.cli.gen_hm3d_episode import (
        generate_episode as tgen, main)

    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jgen(jroot, timesteps=6, seed=2, height=30, width=40, focal=40.0)
    main(["--out", troot, "--timesteps", "6", "--seed", "2", "--height",
          "30", "--width", "40", "--focal", "40.0"])
    for sub in ("rgb", "depth"):
        assert (sorted(os.listdir(os.path.join(troot, sub)))
                == sorted(os.listdir(os.path.join(jroot, sub))))
    for name in sorted(os.listdir(os.path.join(jroot, "rgb"))):
        np.testing.assert_array_equal(
            read_png(os.path.join(troot, "rgb", name)),
            np.asarray(Image.open(os.path.join(jroot, "rgb", name))))
    for rel in ([os.path.join("depth", n)
                 for n in os.listdir(os.path.join(jroot, "depth"))]
                + ["poses.npy", "episode_info.txt"]):
        with open(os.path.join(jroot, rel), "rb") as a, \
                open(os.path.join(troot, rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert tgen(str(tmp_path / "again"), timesteps=2) == str(
        tmp_path / "again")

    kw = dict(evaluation_indices=[5], focal_length_x=40.0,
              focal_length_y=40.0, build_map=False)
    jds = jloader.RGBDDataset(jroot, convention="hm3d", **kw)
    tds = tloader.RGBDDataset(troot, convention="hm3d", device="cpu", **kw)
    assert len(tds) == len(jds) == 6
    assert tds.environment_indices == jds.environment_indices
    for i in range(len(jds)):
        np.testing.assert_allclose(tds.get_image_data(i)[2],
                                   jds.get_image_data(i)[2], atol=1e-12,
                                   rtol=0)
        np.testing.assert_array_equal(tds.load_depth_scaled(i),
                                      jds.load_depth_scaled(i))
        np.testing.assert_array_equal(
            tloader.load_rgb(tds.get_image_data(i)[0]),
            jloader.load_rgb(jds.get_image_data(i)[0]))
