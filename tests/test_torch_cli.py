"""The port's trial CLIs end to end on the CPU (`--device cpu`).

* `localisation_trial.main` on the 7-view 120x160 TUM dataset of
  `test_memory_e2e.py::test_localisation_trial_cli`, written by the JAX
  writer (so PIL's PNG files go through the port's reader), with that
  test's flags: the held-out view within the reference's success gate
  (0.6 m, 0.3 rad); the results file, the memory pkl and the debug ply
  dumps written.
* That run's memory equals the one the JAX CLI builds by its numpy path
  (compiled helpers off), row by row within 1e-5.
* The memory pkl crosses packages both ways with the clouds unchanged, and
  `ObjectMemory.save` writes ply files that read back exactly.
* `synth_localisation_trial --quick` localises its eval view within the
  gate.
* `--serve-batch 4` (throughput serving through `localise_many`) writes the
  same results file as serial serving on the dataset of
  `test_memory_e2e.py::test_localisation_trial_cli_serving_mode`, and
  `--embeddings dator` runs with a tiny npz checkpoint.
* The flags the port treats differently from the JAX CLI fail loudly.
* `clip_loc_trial.main` on the 7-view 120x160 TUM dataset of
  `test_clip_loc.py::test_clip_loc_trial_cli`, with that test's flags and
  query detector: the held-out view within the JAX test's 1.5 m gate; the
  report and the clip_loc pkl written, and the pkl read by the JAX package.
* `localisation_trial --detector cascade --ram-checkpoint ...
  --ram-tag-list ...` passes both files on to the RAM tagger.
"""

import copy
import os

import numpy as np
import pytest

from instance_based_loc_tpu.data.synthetic import (default_scene,
                                                   write_tum_dataset)
from instance_based_loc_tpu.memory import ObjectMemory as JaxObjectMemory
from instance_based_loc_tpu.models.embedders import (
    get_embedder as jax_get_embedder)
from instance_based_loc_tpu_torch.cli import (localisation_trial,
                                              synth_localisation_trial)
from instance_based_loc_tpu_torch.memory import (ColorRegionDetector,
                                                 ObjectMemory)
from instance_based_loc_tpu_torch.models.embedders import get_embedder
from instance_based_loc_tpu_torch.utils.ply import read_ply

TRANS_OK, ROT_OK = 0.6, 0.3


def _args(data, tmp_path, *extra):
    return localisation_trial.apply_convention_defaults(
        localisation_trial.make_parser().parse_args([
            "--convention", "tum", "--data-path", data,
            "--embeddings", "color", "--detector", "color",
            "-e", "5", "--consider-floor", "--min-points", "150",
            "--no-outlier-removal", "--focal-length", "150",
            "--sampling-period", "1",
            "--downsample-voxel-size", "0.02", "--dbscan-eps", "0.1",
            "--dbscan-min-points", "40",
            "--fpfh-global-dist-factor", "2.0",
            "--fpfh-local-dist-factor", "0.4",
            "--out-dir", str(tmp_path / "out"),
            "--testname", "cli_smoke", "--quiet", "--device", "cpu",
            *extra]))


@pytest.fixture(scope="module")
def tum_run(tmp_path_factory):
    """One CLI run on the JAX writer's TUM dataset; returns its errors and
    paths."""
    tmp_path = tmp_path_factory.mktemp("cli")
    scene = default_scene(num_objects=4, seed=5)
    data = str(tmp_path / "tum")
    write_tum_dataset(data, scene=scene, n_views=7, height=120, width=160,
                      focal_length=150.0)
    pkl = str(tmp_path / "mem.pkl")
    args = _args(data, tmp_path, "--memory-save-path", pkl,
                 "--save-point-clouds")
    detector = ColorRegionDetector(min_area=80,
                                   floor_colors=[scene.floor_color])
    cwd = os.getcwd()
    os.chdir(tmp_path)                 # the debug dumps go under ./pcds
    try:
        trans_errors, rot_errors = localisation_trial.main(args,
                                                           detector=detector)
    finally:
        os.chdir(cwd)
    return trans_errors, rot_errors, tmp_path, pkl, scene


def test_localisation_trial_cli_on_jax_written_tum_data(tum_run):
    trans_errors, rot_errors, tmp_path, pkl, _ = tum_run
    assert trans_errors[0] < TRANS_OK and rot_errors[0] < ROT_OK, (
        trans_errors, rot_errors)
    report = (tmp_path / "out" / "cli_smoke_results.txt").read_text()
    assert "Total Success Rate: 100.0" in report
    assert os.path.exists(pkl)
    dumps = tmp_path / "pcds" / "cli_smoke" / "5"
    names = sorted(os.listdir(dumps))
    assert names[0].startswith("_best_full_pcd") and names[1] == "_init_pcd.ply"
    for name in names:
        pts, _ = read_ply(str(dumps / name))
        assert len(pts) > 100 and np.isfinite(pts).all()


def _port_memory(scene):
    return ObjectMemory(
        detector=ColorRegionDetector(min_area=80,
                                     floor_colors=[scene.floor_color]),
        camera_focal_lenth_x=150.0, camera_focal_lenth_y=150.0,
        get_embeddings_func=get_embedder("color"), log_enabled=False,
        device="cpu")


def test_cli_builds_the_jax_numpy_path_memory(tum_run, monkeypatch):
    """The port's CLI builds the memory that the JAX CLI builds by its numpy
    path (compiled helpers off): same objects, same rows in the same order
    within 1e-5. The floor is left out: each frame draws a random subset
    of its points, and the two packages' streams differ."""
    from instance_based_loc_tpu.cli import localisation_trial as jlt
    from instance_based_loc_tpu.data.loader import RGBDDataset as JaxDataset
    from instance_based_loc_tpu.memory import (
        ColorRegionDetector as JaxDetector)
    from instance_based_loc_tpu.ops import native
    for name in ("voxel_downsample_native", "dbscan_native",
                 "radius_outlier_native"):
        monkeypatch.setattr(native, name, lambda *a, **k: None)
    _, _, tmp_path, pkl, scene = tum_run
    data = str(tmp_path / "tum")
    jax_mem = JaxObjectMemory(
        detector=JaxDetector(min_area=80, floor_colors=[scene.floor_color]),
        camera_focal_lenth_x=150.0, camera_focal_lenth_y=150.0,
        get_embeddings_func=jax_get_embedder("color"), log_enabled=False)
    args = jlt.apply_convention_defaults(jlt.make_parser().parse_args([
        "--convention", "tum", "--data-path", data, "-e", "5",
        "--consider-floor", "--min-points", "150", "--no-outlier-removal",
        "--focal-length", "150", "--sampling-period", "1",
        "--downsample-voxel-size", "0.02", "--dbscan-eps", "0.1",
        "--dbscan-min-points", "40", "--quiet"]))
    jlt.build_memory(args, jax_mem, JaxDataset(
        data, [5], convention="tum", focal_length_x=150.0,
        focal_length_y=150.0, sampling_period=1, build_map=False), None)
    port = _port_memory(scene)
    port.load(pkl)
    assert [o.names for o in port.memory] == [o.names for o in jax_mem.memory]
    for a, b in zip(port.memory, jax_mem.memory):
        np.testing.assert_allclose(a.pts, b.pts, rtol=0, atol=1e-5)
        np.testing.assert_allclose(a.cols, b.cols, rtol=0, atol=1e-5)


def test_memory_pkl_crosses_packages_and_saves_ply(tum_run):
    _, _, tmp_path, pkl, scene = tum_run
    port = _port_memory(scene)
    port.load(pkl)
    assert len(port.memory) >= len(scene.boxes)

    # the port's pkl into the JAX package, and the JAX package's pkl back
    jax_mem = JaxObjectMemory(detector=None, camera_focal_lenth_x=150.0,
                              camera_focal_lenth_y=150.0,
                              get_embeddings_func=jax_get_embedder("color"),
                              log_enabled=False)
    jax_mem.load(pkl)
    jax_pkl = str(tmp_path / "jax_mem.pkl")
    jax_mem.save_to_pkl(jax_pkl)
    back = _port_memory(scene)
    back.load(jax_pkl)
    for mem in (jax_mem, back):
        assert [o.names for o in mem.memory] == [o.names for o in port.memory]
        for a, b in zip(mem.memory, port.memory):
            np.testing.assert_array_equal(a.pts, b.pts)
            np.testing.assert_array_equal(a.cols, b.cols)
            np.testing.assert_array_equal(a.mean_emb, b.mean_emb)
    np.testing.assert_array_equal(back.floors.pts, port.floors.pts)

    # ply dumps of the memory, as the JAX package writes them
    saved = tmp_path / "saved"
    port.save(str(saved))
    jax_saved = tmp_path / "jax_saved"
    copy.deepcopy(jax_mem).save(str(jax_saved))
    assert sorted(os.listdir(saved)) == sorted(os.listdir(jax_saved))
    for obj in port.memory:
        pts, cols = read_ply(str(saved / "objects" / str(obj.id)
                                 / "pointcloud.ply"))
        np.testing.assert_array_equal(pts, obj.pts)
        assert os.path.exists(saved / "objects" / str(obj.id) / "info.pkl")
    pts, _ = read_ply(str(saved / "combined_pointcloud_with_floor.ply"))
    assert len(pts) == sum(o.num_points() for o in port.memory) \
        + port.floors.num_points()


def test_synth_localisation_trial_quick(tmp_path):
    trans_errors, rot_errors = synth_localisation_trial.main([
        "--quick", "--device", "cpu", "--out-dir", str(tmp_path / "out"),
        "--data-path", str(tmp_path / "data")])
    assert len(trans_errors) == 1
    assert trans_errors[0] < TRANS_OK and rot_errors[0] < ROT_OK, (
        trans_errors, rot_errors)
    assert (tmp_path / "out" / "synth_trial_results.txt").exists()


@pytest.mark.parametrize("flags,error,match", [
    (["--serve-data-axis", "2"], ValueError, "one card"),
    (["--serve-batch", "2", "--save-point-clouds"], SystemExit,
     "latency-mode"),
])
def test_flags_the_port_does_not_run_fail_loudly(tmp_path, flags, error,
                                                 match):
    args = _args(str(tmp_path / "absent"), tmp_path, *flags)
    with pytest.raises(error, match=match):
        localisation_trial.main(args)


def _serving_dataset(tmp_path):
    scene = default_scene(num_objects=4, seed=5)
    data = str(tmp_path / "tum")
    # the JAX serving test's dataset: 12 views, 4 of them held out
    write_tum_dataset(data, scene=scene, n_views=12, height=120, width=160,
                      focal_length=150.0)
    return scene, data


def test_serve_batch_writes_the_serial_results(tmp_path):
    """`--serve-batch 4` serves the 4 eval views as one chunk; each view
    draws the seed serial serving gives it, so the results files are
    identical (the CPU computes the batched rows bit for bit)."""
    scene, data = _serving_dataset(tmp_path)
    reports = []
    for flags in ([], ["--serve-batch", "4"]):
        out = tmp_path / f"out{len(reports)}"
        args = _args(data, tmp_path, "-e", "3", "5", "7", "9",
                     "--out-dir", str(out), *flags)
        detector = ColorRegionDetector(min_area=80,
                                       floor_colors=[scene.floor_color])
        trans_errors, rot_errors = localisation_trial.main(args,
                                                           detector=detector)
        reports.append((out / "cli_smoke_results.txt").read_text())
    assert reports[1] == reports[0]
    ok = sum(t < TRANS_OK and r < ROT_OK
             for t, r in zip(trans_errors, rot_errors))
    assert ok >= 3, (trans_errors, rot_errors)   # the JAX test's gate


def test_dator_embeddings_run_with_a_tiny_npz(tmp_path, monkeypatch):
    """`--embeddings dator --embedder-checkpoint <npz>` builds the memory
    and localises through the port's FourDNet (a narrow random one: the
    gate is a finite pose, not success)."""
    import dataclasses

    import torch

    from instance_based_loc_tpu_torch.models.dator import embedder, fourdnet
    from instance_based_loc_tpu_torch.models.dator.train import (
        save_params_npz)
    from instance_based_loc_tpu_torch.models.dator.transreid_vit import (
        TransReIDConfig)
    tiny = fourdnet.FourDNetConfig(
        backbone=TransReIDConfig(img_height=32, img_width=16, patch_size=8,
                                 stride_size=8, hidden_size=32, num_layers=2,
                                 num_heads=4, local_feature=True,
                                 dtype=torch.float32),
        reduced_dim=16, num_classes=9, dtype=torch.float32)
    model = fourdnet.FourDNet(tiny)
    fourdnet.init_params(model, torch.Generator().manual_seed(0))
    npz = str(tmp_path / "dator.npz")
    save_params_npz(model, npz)
    built = []
    original = embedder.build_dator_embedder

    def narrow(checkpoint_path=None, **kw):
        built.append(original(checkpoint_path,
                              model_cfg=dataclasses.replace(tiny,
                                                            num_classes=3),
                              height=32, width=16, **kw))
        return built[-1]
    monkeypatch.setattr(embedder, "build_dator_embedder", narrow)
    scene, data = _serving_dataset(tmp_path)
    args = _args(data, tmp_path, "--embeddings", "dator",
                 "--embedder-checkpoint", npz, "-e", "3", "7",
                 "--serve-batch", "2")
    detector = ColorRegionDetector(min_area=80,
                                   floor_colors=[scene.floor_color])
    trans_errors, rot_errors = localisation_trial.main(args,
                                                       detector=detector)
    assert built and built[0].model.cfg.num_classes == 9   # from the npz
    assert built[0].batches > 0
    assert len(trans_errors) == 2
    assert np.all(np.isfinite(trans_errors + rot_errors))


def test_default_device_needs_a_card(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(str(tmp_path / "absent"), tmp_path, "--device", "cuda")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        localisation_trial.main(args)
    parser = localisation_trial.make_parser()
    assert parser.parse_args(["--data-path", "x"]).device == "cuda"


def test_default_out_dir_keeps_clear_of_the_jax_reports():
    """Run from the repository root with no `--out-dir`, the port's reports
    go under out/torch/, never over the JAX package's files in out/."""
    from instance_based_loc_tpu.cli import localisation_trial as jlt
    args = localisation_trial.make_parser().parse_args(["--data-path", "x"])
    jax_args = jlt.make_parser().parse_args(["--data-path", "x"])
    assert os.path.normpath(args.out_dir) == os.path.join("out", "torch")
    assert os.path.normpath(jax_args.out_dir) == "out"


def test_clip_loc_trial_cli(tmp_path):
    from instance_based_loc_tpu.memory.clip_loc import (
        ClipLocObjectMemory as JaxClipLocObjectMemory)
    from instance_based_loc_tpu_torch.cli import clip_loc_trial
    scene = default_scene(num_objects=5, seed=3)
    data = str(tmp_path / "tum")
    write_tum_dataset(data, scene=scene, n_views=7, height=120, width=160,
                      focal_length=150.0)
    args = localisation_trial.apply_convention_defaults(
        clip_loc_trial.make_clip_loc_parser().parse_args([
            "--convention", "tum", "--data-path", data,
            "--embeddings", "color", "--detector", "depth",
            "-e", "5", "--consider-floor", "--min-points", "150",
            "--no-outlier-removal", "--focal-length", "150",
            "--sampling-period", "1",
            "--downsample-voxel-size", "0.02", "--dbscan-eps", "0.1",
            "--dbscan-min-points", "40",
            "--clip-loc-save-path", str(tmp_path / "clipmem"),
            "--out-dir", str(tmp_path / "out"),
            "--testname", "cli_smoke", "--quiet", "--device", "cpu"]))
    query_detector = ColorRegionDetector(min_area=80,
                                         floor_colors=[scene.floor_color])
    trans_errors, rot_errors = clip_loc_trial.main(
        args, query_detector=query_detector)
    assert len(trans_errors) == 1 and trans_errors[0] < 1.5, trans_errors
    assert (tmp_path / "out" / "cli_smoke_results.txt").exists()
    loaded = JaxClipLocObjectMemory.load(str(tmp_path / "clipmem"),
                                         log_enabled=False)
    assert len(loaded) >= len(scene.boxes)
    assert clip_loc_trial.make_clip_loc_parser().parse_args(
        ["--data-path", "x"]).device == "cuda"


def test_ram_tag_list_reaches_the_tagger(tmp_path, monkeypatch):
    from instance_based_loc_tpu_torch.models import ram, sam
    seen = {}

    def tagger_builder(checkpoint_path=None, **kwargs):
        seen.update(kwargs, checkpoint_path=checkpoint_path)
        tagger = lambda rgb: ["chair"]             # noqa: E731
        tagger.tag_batch = lambda frames: [["chair"] for _ in frames]
        return tagger

    monkeypatch.setattr(ram, "build_ram_tagger", tagger_builder)
    monkeypatch.setattr(sam, "build_sam_segmenter",
                        lambda *a, **k: (lambda img, boxes: None))
    args = _args(str(tmp_path / "absent"), tmp_path, "--detector", "cascade",
                 "--ram-checkpoint", "ram.pth",
                 "--ram-tag-list", "ram_tag_list.txt")
    cascade = localisation_trial.build_detector(args)
    assert seen["checkpoint_path"] == "ram.pth"
    assert seen["tag_list_path"] == "ram_tag_list.txt"
    assert seen["device"] == "cpu" and not seen["random_init"]
    assert cascade.tagger(np.zeros((8, 8, 3), np.uint8)) == ["chair"]
