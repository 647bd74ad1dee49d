"""The port's ReID data path and DATOR CLIs against the JAX package on the
CPU: the dataset scan, the P x K sampler, the batch loader, the config
loader, the synthetic ReID writers (`gen_synth_reid`, `gen_reid_dataset
--synthetic` through `ObjectDatasetMemory`), and `dator_train` /
`dator_test` end to end at a small size (hidden 64, 2 blocks, 32x16
crops, fp32 by IBL_DATOR_F32).

Tolerances: the sampler's batches, the loader's quantised bytes and
normalised arrays, and the written files are identical (the port runs
PIL's resize in numpy and the same numpy generator draws); the embeddings
of an npz the port's trainer wrote, through the port's and the JAX
package's embedders, agree within 1e-4 (fp32, sums in another order).
"""

import dataclasses
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from instance_based_loc_tpu import config as jconfig
from instance_based_loc_tpu.cli import gen_reid_dataset as jgen_reid
from instance_based_loc_tpu.cli import gen_synth_reid as jgen_synth
from instance_based_loc_tpu.memory.detection import (
    Detections as JaxDetections)
from instance_based_loc_tpu.models.dator import data as jdata
from instance_based_loc_tpu.models.dator import fourdnet as jfd
from instance_based_loc_tpu.models.dator import train as jtrain
from instance_based_loc_tpu.models.dator import transreid_vit as jvit
from instance_based_loc_tpu.models.dator.embedder import (
    build_dator_embedder as jax_build_embedder)
from instance_based_loc_tpu_torch import config as tconfig
from instance_based_loc_tpu_torch.cli import dator_test, dator_train
from instance_based_loc_tpu_torch.cli import gen_reid_dataset as tgen_reid
from instance_based_loc_tpu_torch.cli import gen_synth_reid as tgen_synth
from instance_based_loc_tpu_torch.memory.detection import Detections
from instance_based_loc_tpu_torch.models.dator import data as tdata
from instance_based_loc_tpu_torch.models.dator import fourdnet as tfd
from instance_based_loc_tpu_torch.models.dator import transreid_vit as tvit
from instance_based_loc_tpu_torch.models.dator.embedder import (
    build_dator_embedder)
from instance_based_loc_tpu_torch.utils.png import read_png, write_png

TINY = ["data.height=32", "data.width=16", "data.batch_size=8",
        "data.num_instances=2", "model.backbone.img_height=32",
        "model.backbone.img_width=16", "model.backbone.patch_size=8",
        "model.backbone.stride_size=8", "model.backbone.hidden_size=64",
        "model.backbone.num_layers=3", "model.backbone.num_heads=4",
        "model.reduced_dim=16"]


def _same_tree(a: str, b: str):
    """Every file under a equals its counterpart under b (images by
    pixels, arrays by value), and the trees hold the same files."""
    files_a = sorted(os.path.relpath(os.path.join(d, f), a)
                     for d, _, fs in os.walk(a) for f in fs)
    files_b = sorted(os.path.relpath(os.path.join(d, f), b)
                     for d, _, fs in os.walk(b) for f in fs)
    assert files_a == files_b
    for rel in files_a:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(read_png(pa), read_png(pb), rel)
        else:
            np.testing.assert_array_equal(np.load(pa), np.load(pb), rel)
    return files_a


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """gen_synth_reid's tree from both packages; one instance also gets a
    sample with a 16-bit PNG depth map."""
    root = tmp_path_factory.mktemp("synth")
    n = tgen_synth.generate(str(root / "port"), ids=5, train_per_id=5,
                            val_per_id=2, test_per_id=1, h=48, w=24, seed=3)
    jgen_synth.generate(str(root / "jax"), ids=5, train_per_id=5,
                        val_per_id=2, test_per_id=1, h=48, w=24, seed=3)
    assert n == 5 * 8
    extra = root / "port" / "train" / "id_0002"
    rng = np.random.default_rng(0)
    write_png(str(extra / "z_rgb.png"),
              rng.integers(0, 256, (30, 20, 3)).astype(np.uint8))
    write_png(str(extra / "z_depth.png"),
              rng.integers(0, 65536, (30, 20)).astype(np.uint16))
    return root


def test_gen_synth_reid_matches_jax(synth):
    port, ref = str(synth / "port"), str(synth / "jax")
    for split in ("val", "test"):
        _same_tree(f"{port}/{split}", f"{ref}/{split}")
    for scan in (tdata.scan_instance_dirs, jdata.scan_instance_dirs):
        train = scan(f"{port}/train")
        assert len(train) == 26 and len({s.pid for s in train}) == 5
        assert len(scan(f"{port}/val")) == 10
    ours = tdata.scan_instance_dirs(f"{port}/train")
    theirs = jdata.scan_instance_dirs(f"{port}/train")
    assert [(s.rgb_path, s.depth_path, s.pid) for s in ours] \
        == [(s.rgb_path, s.depth_path, s.pid) for s in theirs]


@pytest.mark.parametrize("batch,k,seed", [(8, 2, 0), (12, 4, 3), (6, 3, 1)])
def test_pk_sampler_matches_jax(batch, k, seed):
    """Identities with 1 to 9 samples: fewer than K are padded by
    resampling, so some batches hold one image twice."""
    counts = [1, 9, 3, 4, 2, 7, 5, 1, 6]
    rows = [(f"r{i}_{j}", f"d{i}_{j}", i) for i, c in enumerate(counts)
            for j in range(c)]
    ours = tdata.PKSampler([tdata.ReIDSample(*r) for r in rows], batch, k,
                           seed=seed)
    theirs = jdata.PKSampler([jdata.ReIDSample(*r) for r in rows], batch, k,
                             seed=seed)
    for epoch in range(4):
        assert ours.epoch_batches(epoch) == theirs.epoch_batches(epoch)
    assert any(len(set(b)) < len(b) for e in range(4)
               for b in ours.epoch_batches(e))


@pytest.mark.parametrize("quantize", [True, False])
def test_load_batch_matches_jax(synth, quantize):
    port = str(synth / "port" / "train")
    samples = tdata.scan_instance_dirs(port)
    jsamples = jdata.scan_instance_dirs(port)
    idxs = list(range(len(samples)))
    assert any(s.depth_path.endswith(".png") for s in samples)
    ours = tdata.PKSampler(samples, 8, 2).load_batch(idxs, 32, 16,
                                                     quantize=quantize)
    theirs = jdata.PKSampler(jsamples, 8, 2).load_batch(idxs, 32, 16,
                                                        quantize=quantize)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if quantize:
        for a, b in zip(tdata.PKSampler(samples, 8, 2).load_all(32, 16),
                        theirs):
            np.testing.assert_array_equal(a, b)


def test_gen_reid_dataset_synthetic_matches_jax(tmp_path, monkeypatch):
    """The port's ObjectDatasetMemory dump equals the JAX package's (its
    numpy path: compiled helpers off), and both scanners read it."""
    from instance_based_loc_tpu.ops import native
    for name in ("voxel_downsample_native", "dbscan_native",
                 "radius_outlier_native"):
        monkeypatch.setattr(native, name, lambda *a, **k: None)
    args = ["--synthetic", "--n-views", "4", "--num-objects", "4"]
    tgen_reid.main(["--out", str(tmp_path / "port"), "--device", "cpu",
                    *args])
    jgen_reid.main(["--out", str(tmp_path / "jax"), *args])
    files = _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(files) >= 8
    for scan in (tdata.scan_instance_dirs, jdata.scan_instance_dirs):
        samples = scan(str(tmp_path / "port"))
        assert len(samples) == len(files) // 2
        assert len({s.pid for s in samples}) >= 3


def test_load_config_overrides(tmp_path, monkeypatch):
    """The JAX config test's cases, a dotted override of a nested model
    field, and the plain-scalar reader against yaml.safe_load."""
    import yaml
    yml = tmp_path / "cfg.yml"
    yml.write_text("train:\n  base_lr: 0.123\ndata:\n  batch_size: 16\n")
    overrides = ["train.epochs=7", "eval.re_ranking=true",
                 "model.backbone.hidden_size=64", "train.weight_decay=1e-3"]
    cfg = tconfig.load_config(str(yml), overrides=overrides)
    ref = jconfig.load_config(str(yml), overrides=overrides)
    assert cfg.train.base_lr == 0.123 and cfg.data.batch_size == 16
    assert cfg.train.epochs == 7 and cfg.eval.re_ranking is True
    assert cfg.model.backbone.hidden_size == 64
    assert dataclasses.asdict(cfg.train) == dataclasses.asdict(ref.train)
    assert dataclasses.asdict(cfg.data) == dataclasses.asdict(ref.data)
    assert dataclasses.asdict(cfg.eval) == dataclasses.asdict(ref.eval)
    with pytest.raises(KeyError):
        tconfig.load_config(overrides=["train.nonexistent=1"])
    for raw in ["true", "False", "yes", "off", "1", "-3", "0x1F", "017",
                "0b101", "1:30", "1.5", "1e-4", "1.0e-4", "-2.5E+3", ".5",
                "abc", "./data/reid", "null", "~", ".inf", "-.inf",
                "'quoted'", "1_000", "+7", "auto"]:
        want = yaml.safe_load(raw)
        got = tconfig.parse_scalar(raw)
        assert got == want and type(got) is type(want), raw
    # without yaml (the card's machine) a YAML file raises, naming the
    # dotted overrides
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="dotted overrides"):
        tconfig.load_config(str(yml))
    assert tconfig.load_config(overrides=["train.epochs=3"]).train.epochs == 3


def test_device_dataset_setting():
    """`data.device_dataset=false` switches the device dataset off. (The
    JAX CLI takes bool() of the stored text "False", which is True.)"""
    for value, want in [("auto", True), ("True", True), ("False", False),
                        (True, True), (False, False)]:
        cfg = tconfig.load_config(overrides=[f"data.device_dataset={value}"])
        assert tconfig.device_dataset_on(cfg.data.device_dataset, 10.0,
                                         512) is want, value
    assert tconfig.device_dataset_on("auto", 600.0, 512) is False
    with pytest.raises(ValueError, match="device_dataset"):
        tconfig.device_dataset_on("maybe", 1.0, 512)


def _epoch_losses(text: str) -> list[float]:
    return [float(x) for x in re.findall(r"^epoch \d+: loss=([0-9.]+)",
                                         text, re.M)]


def _tiny_cfgs():
    geo = dict(img_height=32, img_width=16, patch_size=8, stride_size=8,
               hidden_size=64, num_layers=3, num_heads=4, local_feature=True)
    return (jfd.FourDNetConfig(backbone=jvit.TransReIDConfig(
                dtype=jnp.float32, **geo), reduced_dim=16, dtype=jnp.float32),
            tfd.FourDNetConfig(backbone=tvit.TransReIDConfig(
                dtype=torch.float32, **geo), reduced_dim=16,
                dtype=torch.float32))


def test_dator_train_and_test_cli(synth, tmp_path, capsys, monkeypatch):
    """Two epochs of the port's trainer on the CPU: the loss falls, every
    eval ablation reports finite rank-1 and mAP, host-loaded batches give
    the device-resident dataset's loss, --resume continues from
    step_2.pt, dator_test reads the checkpoint and draws the heatmap, the
    JAX package's `load_params_npz` takes the params npz strictly, and the
    npz gives the same embeddings through the port's and the JAX
    package's embedders."""
    monkeypatch.setenv("IBL_DATOR_F32", "1")
    data = synth / "port"
    out = tmp_path / "run"
    opts = [f"data.root={data}/train", f"data.val_root={data}/val",
            f"output_dir={out}", "train.warmup_epochs=0",
            "train.base_lr=0.02", "train.optimizer=adam", "eval.period=1",
            "eval.checkpoint_period=1", "train.gate_epoch=0", *TINY]
    state = dator_train.main(["--device", "cpu", *opts, "train.epochs=2"])
    text = capsys.readouterr().out
    losses = _epoch_losses(text)
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert losses[1] < losses[0], text
    evals = re.findall(r"eval\[(\w+)/(\w+)\]: rank1=([0-9.]+) .* "
                       r"mAP=([0-9.]+)", text)
    assert len(evals) == 2 * 2 * 3                 # epochs x splits x 3
    assert all(np.isfinite(float(r)) and np.isfinite(float(m))
               for *_, r, m in evals)
    for f in ("step_2.pt", "params_latest.npz", "best_params.npz"):
        assert (out / f).exists(), f
    spe = state.step // 2

    # batches loaded per step on the host instead of gathered from the
    # device-resident dataset: the same quantised bytes, the same loss
    host = [o for o in opts if not o.startswith(("output_dir=",
                                                 "eval.period="))]
    dator_train.main(["--device", "cpu", *host, "train.epochs=1",
                      "eval.period=5", f"output_dir={tmp_path / 'host'}",
                      "data.device_dataset=false"])
    text = capsys.readouterr().out
    assert "device-resident" not in text
    assert _epoch_losses(text) == losses[:1]

    resumed = dator_train.main(["--device", "cpu", *opts, "train.epochs=3",
                                "--resume", "2"])
    text = capsys.readouterr().out
    assert "resumed from" in text and len(_epoch_losses(text)) == 1
    assert re.search(r"^epoch 2: ", text, re.M)
    assert resumed.step == 3 * spe

    heat = tmp_path / "heat.png"
    dator_test.main(["--device", "cpu", "--checkpoint", str(out),
                     "--heatmap", str(heat), *opts])
    text = capsys.readouterr().out
    assert re.search(r"Rank-1: [0-9.]+ .* mAP: [0-9.]+", text)
    n = len(tdata.scan_instance_dirs(f"{data}/train"))
    assert read_png(str(heat)).shape == (4 * n, 4 * n, 3)

    npz = str(out / "params_latest.npz")
    jcfg, tcfg = _tiny_cfgs()
    # every entry of the JAX trainer's tree is in the port's npz: the JAX
    # loader takes it strictly (template shapes from eval_shape, no init)
    n_cls = len({s.pid for s in tdata.scan_instance_dirs(f"{data}/train")})
    x = jnp.zeros((2, 32, 16, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jfd.FourDNet(dataclasses.replace(
        jcfg, num_classes=n_cls)).init({"params": key, "dropout": key}, x, x,
                                      training=True))
    template = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes)
    loaded = jtrain.load_params_npz(template, npz, strict=True)
    port_state = resumed.model.state_dict()        # wrote the npz last
    np.testing.assert_allclose(
        np.asarray(loaded["params"]["classifier"]["kernel"]),
        port_state["classifier.kernel"].numpy(), rtol=1e-3, atol=1e-4)
    kw = dict(height=32, width=16, max_crops=4, feature="embedding")
    tembed = build_dator_embedder(npz, model_cfg=tcfg, device="cpu", **kw)
    jembed = jax_build_embedder(npz, model_cfg=jcfg, **kw)
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (40, 30, 3)).astype(np.uint8)
    depth = rng.uniform(0.5, 3.0, (40, 30)).astype(np.float32)
    boxes = np.array([[2, 1, 24, 38], [5, 3, 28, 30], [0, 0, 30, 40]],
                     np.float32)
    crops = [rgb[int(b[1]):int(b[3]), int(b[0]):int(b[2])] for b in boxes]
    masks = np.ones((3, 40, 30), bool)
    ours = tembed(Detections(crops, boxes, masks, ["a"] * 3),
                  full_rgb_image=rgb, full_depth_image=depth)
    ref = jembed(JaxDetections(crops=crops, boxes_xyxy=boxes, masks=masks,
                               phrases=["a"] * 3),
                 full_rgb_image=rgb, full_depth_image=depth)
    assert np.abs(ours).max() > 1e-3
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-4)


def test_dator_train_raises_without_a_card_or_with_a_mesh(tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dator_train.main([f"data.root={tmp_path}"])
    with pytest.raises(ValueError, match="n_model_shards"):
        dator_train.main(["--device", "cpu", f"data.root={tmp_path}",
                          "n_model_shards=2"])


def test_dator_train_warm_start_and_kill_gate(synth, tmp_path, capsys,
                                              monkeypatch):
    """--init-npz with --resume-epoch and --init-npz-filter: the matching
    entries come from the npz (fp16-rounded), the schedule is shifted by
    the skipped epochs' steps; a flat id_loss at train.gate_epoch saves
    step_EPOCH.pt and exits with code 3."""
    monkeypatch.setenv("IBL_DATOR_F32", "1")
    data = synth / "port"
    opts = [f"data.root={data}/train", "train.warmup_epochs=0",
            "train.base_lr=0.02", "train.optimizer=adam", "eval.period=5",
            "train.gate_epoch=0", *TINY]
    first = dator_train.main(["--device", "cpu", *opts, "train.epochs=1",
                              f"output_dir={tmp_path / 'a'}"])
    spe = first.step
    npz = str(tmp_path / "a" / "params_latest.npz")
    capsys.readouterr()
    warm = dator_train.main(["--device", "cpu", *opts, "train.epochs=2",
                             f"output_dir={tmp_path / 'b'}", "--init-npz",
                             npz, "--resume-epoch", "1", "--init-npz-filter",
                             "towers,aux_"])
    text = capsys.readouterr().out
    assert f"schedule offset {spe} steps" in text
    assert "kept the model's values" in text
    assert warm.step == spe and warm.cfg.schedule_offset_steps == spe
    assert len(_epoch_losses(text)) == 1 and re.search(r"^epoch 1: ", text,
                                                       re.M)
    frozen = "['params']['towers']['block0']['attn']['qkv']['kernel']"
    np.testing.assert_array_equal(
        warm.model.state_dict()["towers.block0.attn.qkv.kernel"].numpy(),
        np.load(npz)[frozen].astype(np.float32))

    with pytest.raises(SystemExit) as exc:
        dator_train.main(["--device", "cpu", *opts,      # later keys win
                          "train.epochs=3", "train.gate_epoch=1",
                          "train.gate_id_loss=0.0",
                          f"output_dir={tmp_path / 'c'}"])
    assert exc.value.code == 3
    assert "KILL-GATE" in capsys.readouterr().out
    assert (tmp_path / "c" / "step_1.pt").exists()
