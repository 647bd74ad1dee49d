"""The port's clip_loc path against the JAX package's, on the CPU: P3P, the
ellipsoid fit, ClipLocObjectMemory, the CLIP text tower and its BPE, the
class detector and the LoRA revolver.

Tolerances:

* `durand_kerner_quartic` on the same complex64 coefficients: roots within
  1e-4 (measured 2e-6).
* `p3p_grunert` on the problems of `tests/test_clip_loc.py`, with the same
  bearings, on the problems whose float64 quartic has no two roots within
  0.05 (86 of 100): the same valid roots, and each root's pose within
  2 * spread + 1e-5 * (1 + kappa) of the JAX package's jitted program.
  `spread` is that program's distance from the JAX package's own eager
  one, kappa the root's relative condition number in the quartic: fp32 P3P
  is ill-conditioned (kappa 10 to 1e5, and cancellation in the quartic's
  coefficients moves the JAX package's own two programs apart by up to
  0.02). The JAX side runs with an SVD Kabsch, because its shipped fp32
  closed-form Kabsch is wrong on the rank-2 covariance of 3 points (a
  reference fault; ROADMAP queue 3); against the shipped code the port
  recovers the true pose in at least as many problems.
* `pixel_bearings`, `project_points` (pixels relative), `refine_pnp` and
  `fit_ellipsoid`: 1e-5.
* `ClipLocObjectMemory`, on the scene of
  `tests/test_clip_loc.py::test_clip_loc_end_to_end` and one JAX memory:
  the same conversion (texts, embeddings and clouds exact, ellipsoids
  1e-5), the same `rng.choice` draws in the same order, and a pose within
  1e-3 of the JAX package's (translation, and the quaternion up to sign);
  both pkl files read in the other package.
* CLIP text: both packages' encoders on one HF CLIPTextModel: 1e-5; the
  port against `transformers` itself: 1e-4 (pooled output, and with the
  file's projection `text_embeds`). `SimpleTokenizer` ids identical.
* `ClipBPETokenizer`: ids identical to the JAX tokenizer on
  `tests/test_clip_bpe.py`'s vocabulary and sentences, and on Unicode
  letters and numbers (superscripts, Arabic-Indic digits, fractions, Roman
  numerals, accents, CJK); `pre_tokenize` equals the `regex` pattern's
  `findall`.
* `ClassVocabularyDetector`: `tests/test_class_detector.py`'s filters, the
  same detections as the JAX class; with a tiny HF GroundingDINO, the same
  boxes within 1e-4 of the frame.
* `LoraRevolver`: base and adapted CLS embeddings within 1e-5 of the JAX
  revolver's on the same npz trunk; the adapter npz crosses packages.
"""

import dataclasses
import json
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from instance_based_loc_tpu.ops import p3p as jp3p
from instance_based_loc_tpu.ops import ellipsoid as jell
from instance_based_loc_tpu.ops.pointcloud import PointCloud
from instance_based_loc_tpu.memory import ObjectMemory as JaxObjectMemory
from instance_based_loc_tpu.memory import (
    ColorRegionDetector as JaxColorRegionDetector)
from instance_based_loc_tpu.memory import clip_loc as jclip
from instance_based_loc_tpu.models import bpe as jbpe
from instance_based_loc_tpu.models import clip_text as jtext
from instance_based_loc_tpu.models import class_detector as jcls
from instance_based_loc_tpu.models import lora as jlora
from instance_based_loc_tpu.models import vit as jvit
from instance_based_loc_tpu.models.embedders import (
    get_embedder as jax_get_embedder)
from instance_based_loc_tpu.data.synthetic import (default_scene,
                                                   render_scene, ring_poses)
from instance_based_loc_tpu_torch.ops import p3p as tp3p
from instance_based_loc_tpu_torch.ops import ellipsoid as tell
from instance_based_loc_tpu_torch.memory import (ColorRegionDetector,
                                                 ObjectMemory)
from instance_based_loc_tpu_torch.memory import clip_loc as tclip
from instance_based_loc_tpu_torch.models import bpe as tbpe
from instance_based_loc_tpu_torch.models import clip_text as ttext
from instance_based_loc_tpu_torch.models import class_detector as tcls
from instance_based_loc_tpu_torch.models import lora as tlora
from instance_based_loc_tpu_torch.models import vit as tvit
from instance_based_loc_tpu_torch.models.embedders import get_embedder
from instance_based_loc_tpu_torch.ops.transforms import quaternion_error

transformers = pytest.importorskip("transformers")

K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)


def _problems(n, seed=0):
    """`tests/test_clip_loc.py::random_problem`, n times: (true poses,
    world points (n, 3, 3), pixels (n, 3, 2))."""
    rng = np.random.default_rng(seed)
    poses, world, pixels = [], [], []
    for _ in range(n):
        r = Rotation.from_euler("xyz", rng.uniform(-0.5, 0.5, 3)).as_matrix()
        t = rng.uniform(-2, 2, 3)
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = r, t
        cam = rng.uniform(-1, 1, (3, 3))
        cam[:, 2] = rng.uniform(2, 5, 3)
        px = cam @ K.T
        poses.append(pose)
        world.append(cam @ r.T + t)
        pixels.append(px[:, :2] / px[:, 2:3])
    return (np.array(poses), np.array(world, np.float32),
            np.array(pixels, np.float32))


def test_durand_kerner_quartic_matches_jax():
    rng = np.random.default_rng(0)
    coeffs = (rng.normal(size=(40, 5))
              + 1j * rng.normal(size=(40, 5))).astype(np.complex64)
    want = np.asarray(jax.jit(jax.vmap(jp3p.durand_kerner_quartic))(
        jnp.asarray(coeffs)))
    got = tp3p.durand_kerner_quartic(torch.from_numpy(coeffs)).numpy()
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _quartic64(world, bearings):
    """The P3P quartic's coefficients in float64 (for condition numbers)."""
    p1, p2, p3 = world.astype(np.float64)
    f1, f2, f3 = bearings.astype(np.float64)
    a2, b2 = ((p2 - p3) ** 2).sum(), ((p1 - p3) ** 2).sum()
    c2 = ((p1 - p2) ** 2).sum()
    ca, cb, cg = f2 @ f3, f1 @ f3, f1 @ f2
    A, B = a2 / b2, c2 / b2
    N = [A - B - 1, -2 * (A - B) * cb, A - B + 1]
    D = [-2 * ca, 2 * cg]
    M = [-B, 2 * B * cb, 1 - B]
    mul, add = tp3p._polymul, tp3p._polyadd
    return np.array(add(mul(N, N), add([-2 * cg * x for x in mul(N, D)],
                                       mul(M, mul(D, D)))))


def _svd_kabsch(p, q, weights=None):
    u_p, u_q = p.mean(0), q.mean(0)
    uu, _, vh = jnp.linalg.svd((q - u_q).T @ (p - u_p))
    d = jnp.linalg.det(uu) * jnp.linalg.det(vh)
    r = uu @ jnp.diag(jnp.ones(3).at[2].set(d)) @ vh
    return jnp.eye(4).at[:3, :3].set(r).at[:3, 3].set(u_q - r @ u_p)


def test_p3p_grunert_matches_jax(monkeypatch):
    true, world, pixels = _problems(100)
    bearings = np.asarray(jax.vmap(lambda px: jp3p.pixel_bearings(
        px, jnp.asarray(K)))(jnp.asarray(pixels)))
    args = (jnp.asarray(world), jnp.asarray(bearings))
    shipped, shipped_valid = map(np.asarray, jax.jit(jax.vmap(
        jp3p.p3p_grunert))(*args))
    monkeypatch.setattr(jp3p, "kabsch_transform", _svd_kabsch)
    want, want_valid = map(np.asarray, jax.jit(jax.vmap(
        jp3p.p3p_grunert))(*args))
    eager, eager_valid = map(np.asarray, jax.vmap(jp3p.p3p_grunert)(*args))
    got, valid = tp3p.p3p_grunert(torch.from_numpy(world),
                                  torch.from_numpy(bearings.copy()))
    got, valid = got.numpy(), valid.numpy()
    eye = np.broadcast_to(np.eye(4), got.shape)
    np.testing.assert_array_equal(got[~valid], eye[~valid])
    rot = got[..., :3, :3]
    assert np.abs(np.einsum("...ji,...jk->...ik", rot, rot)
                  - np.eye(3)).max() < 1e-5

    # which roots are valid is a threshold on fp32 values, and clustered
    # roots may converge in another order: problems whose float64 quartic
    # has roots within 0.05 of each other are not compared
    clustered = np.zeros(len(world), bool)
    for s in range(len(world)):
        roots = np.roots(_quartic64(world[s], bearings[s]))
        gaps = np.abs(roots[:, None] - roots[None]) + np.eye(4)
        clustered[s] = gaps.min() < 0.05 * max(1.0, np.abs(roots).max())
    assert clustered.sum() <= len(world) // 5    # 14 of 100 here
    np.testing.assert_array_equal(valid[~clustered], want_valid[~clustered])
    assert valid.sum() > 150
    for s, r in zip(*np.nonzero(valid & want_valid & eager_valid
                                & ~clustered[:, None])):
        c = _quartic64(world[s], bearings[s])
        # the root: v = s3 / s1, from the port's camera-frame points
        cam = (world[s].astype(np.float64) - got[s, r, :3, 3]) @ got[s, r, :3, :3]
        v = np.linalg.norm(cam[2]) / np.linalg.norm(cam[0])
        dq = np.polyval(np.polyder(c), v)
        kappa = (np.sum(np.abs(c) * v ** np.arange(4, -1, -1))
                 / max(abs(v * dq), 1e-30))
        # the JAX package's own jitted and eager programs differ by
        # `spread` (up to 0.02 here, from fp32 cancellation in the quartic's
        # coefficients): the port may differ by twice that, plus fp32
        # rounding amplified by the root's condition number
        spread = np.abs(want[s, r] - eager[s, r]).max()
        err = np.abs(got[s, r] - want[s, r]).max()
        assert err <= 2 * spread + 1e-5 * (1 + kappa), (s, r, err, spread,
                                                         kappa)

    def recovered(poses, ok):
        e = np.abs(poses - true[:, None]).max((-1, -2))
        return int((np.where(ok, e, np.inf).min(1) < 5e-2).sum())
    assert recovered(got, valid) >= recovered(shipped, shipped_valid)


def test_pixel_bearings_and_projection_match_jax():
    true, world, pixels = _problems(4, seed=1)
    np.testing.assert_allclose(
        tp3p.pixel_bearings(torch.from_numpy(pixels[0]),
                            torch.from_numpy(K)).numpy(),
        np.asarray(jp3p.pixel_bearings(jnp.asarray(pixels[0]),
                                       jnp.asarray(K))), atol=1e-5)
    pts = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    poses = true.astype(np.float32)
    got_px, got_front = tp3p.project_points(
        torch.from_numpy(pts), torch.from_numpy(K), torch.from_numpy(poses))
    for i, pose in enumerate(poses):          # batched over poses
        px, front = jp3p.project_points(jnp.asarray(pts), jnp.asarray(K),
                                        jnp.asarray(pose))
        np.testing.assert_allclose(got_px[i].numpy(), np.asarray(px),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got_front[i].numpy(), np.asarray(front))


def test_refine_pnp_matches_jax():
    rng = np.random.default_rng(2)
    r = Rotation.from_euler("xyz", rng.uniform(-0.5, 0.5, 3)).as_matrix()
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = r, rng.uniform(-2, 2, 3)
    cam = rng.uniform(-1, 1, (6, 3))
    cam[:, 2] = rng.uniform(2, 5, 6)
    world = (cam @ r.T + pose[:3, 3]).astype(np.float32)
    px = cam @ K.T
    px = (px[:, :2] / px[:, 2:3] + rng.normal(0, 0.5, (6, 2))).astype(
        np.float32)
    noisy = pose.copy()
    noisy[:3, 3] += rng.normal(0, 0.1, 3)
    noisy[:3, :3] = noisy[:3, :3] @ Rotation.from_euler(
        "xyz", rng.normal(0, 0.05, 3)).as_matrix()
    noisy = noisy.astype(np.float32)
    weights = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    want = np.asarray(jp3p.refine_pnp(*map(jnp.asarray, (
        noisy, world, px, weights, K))))
    got = tp3p.refine_pnp(*map(torch.from_numpy, (
        noisy, world, px, weights, K))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - pose).max() < np.abs(noisy - pose).max()


def test_fit_ellipsoid_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(300, 3)).astype(np.float32) * np.array(
        [2, 1, 0.5], np.float32)
    pc = PointCloud.from_numpy(pts, capacity=512)     # padded, masked rows
    want = [np.asarray(x) for x in jell.fit_ellipsoid(pc.points, pc.mask)]
    got = [x.numpy() for x in tell.fit_ellipsoid(
        torch.as_tensor(np.asarray(pc.points)),
        torch.as_tensor(np.asarray(pc.mask)))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)
    np.testing.assert_array_equal(
        tell.sample_ellipsoid_surface(*want, 12, 6),
        jell.sample_ellipsoid_surface(*want, 12, 6))


FOCAL, H, W = 200.0, 160, 220


@pytest.fixture(scope="module")
def clip_scene(tmp_path_factory):
    """`test_clip_loc_end_to_end`'s scene and JAX memory, and the same
    memory in the port (through the memory pkl)."""
    tmp = tmp_path_factory.mktemp("clip_loc")
    scene = default_scene(num_objects=5, seed=3)
    poses = ring_poses(7, radius=4.5, height=1.3, target=(0, 0.4, 0))
    frames = [render_scene(scene, p, H, W, FOCAL) for p in poses]
    jdet = JaxColorRegionDetector(min_area=80,
                                  floor_colors=[scene.floor_color])
    jmem = JaxObjectMemory(detector=jdet, camera_focal_lenth_x=FOCAL,
                           camera_focal_lenth_y=FOCAL,
                           get_embeddings_func=jax_get_embedder("color"),
                           log_enabled=False)
    for i in range(6):
        rgb, depth, _ = frames[i]
        jmem.process_image(rgb, depth, poses[i], consider_floor=True,
                           min_points=200, outlier_removal_config=None)
    jmem.downsample_all_objects(voxel_size=0.02)
    jmem.recluster_objects_with_dbscan(eps=0.1, min_points_per_cluster=40)
    pkl = str(tmp / "memory.pkl")
    jmem.save_to_pkl(pkl)
    tmem = ObjectMemory(detector=None, camera_focal_lenth_x=FOCAL,
                        camera_focal_lenth_y=FOCAL,
                        get_embeddings_func=get_embedder("color"),
                        log_enabled=False, device="cpu")
    tmem.load(pkl)
    return scene, poses, frames, jmem, tmem, tmp


class _RecordingRng:
    """np.random.default_rng's generator, logging every `choice` draw."""

    def __init__(self, make, seed, log):
        self._rng, self._log = make(seed), log

    def choice(self, *args, **kwargs):
        out = self._rng.choice(*args, **kwargs)
        self._log.append(np.array(out))
        return out


def test_clip_loc_memory_matches_jax(clip_scene, monkeypatch):
    scene, poses, frames, jmem, tmem, tmp = clip_scene
    jc = jclip.ClipLocObjectMemory.from_object_memory(jmem, log_enabled=False)
    tc = tclip.ClipLocObjectMemory.from_object_memory(tmem, log_enabled=False)
    assert tc.device == torch.device("cpu") and len(tc) == len(jc) >= 4
    for a, b in zip(tc.memory, jc.memory):
        assert (a.id, a.text) == (b.id, b.text)
        for name in ("embedding", "points", "colors"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        for name in ("ellipsoid_center", "ellipsoid_axes",
                     "ellipsoid_lengths"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=1e-5)

    # the same draws, the same pose
    k_cv = np.array([[FOCAL, 0, W / 2], [0, -FOCAL, H / 2], [0, 0, 1]],
                    np.float32)
    rgb = frames[6][0]
    make = np.random.default_rng
    logs = []
    for package, mem, det, emb in (
            ("jax", jc, JaxColorRegionDetector(
                min_area=80, floor_colors=[scene.floor_color]),
             jax_get_embedder("color")),
            ("port", tc, ColorRegionDetector(
                min_area=80, floor_colors=[scene.floor_color]),
             get_embedder("color"))):
        log = []
        monkeypatch.setattr(np.random, "default_rng",
                            lambda seed=None, log=log: _RecordingRng(
                                make, seed, log))
        logs.append((mem.localize(rgb, k_cv, det, emb, k=3, rounds=200),
                     log))
    monkeypatch.setattr(np.random, "default_rng", make)
    (want, jlog), (got, tlog) = logs
    assert len(tlog) == len(jlog) > 200 and tc.ransac_samples == 200
    for a, b in zip(tlog, jlog):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[:3], want[:3], atol=1e-3)
    assert min(np.abs(got[3:] - want[3:]).max(),
               np.abs(got[3:] + want[3:]).max()) < 1e-3
    true = poses[6]
    rot_err = float(quaternion_error(torch.as_tensor(true[3:], dtype=torch.float32),
                                     torch.as_tensor(got[3:], dtype=torch.float32)))
    assert np.linalg.norm(got[:3] - true[:3]) < 1.0 and rot_err < 0.4

    # each package reads the other's pkl
    jc.save(str(tmp / "jax_clip"))
    tc2 = tclip.ClipLocObjectMemory.load(str(tmp / "jax_clip"),
                                         log_enabled=False, device="cpu")
    tc2.save(str(tmp / "port_clip"))
    jc2 = jclip.ClipLocObjectMemory.load(str(tmp / "port_clip"),
                                         log_enabled=False)
    for mem in (tc2, jc2):
        for a, b in zip(mem.memory, jc.memory):
            for name, value in dataclasses.asdict(b).items():
                np.testing.assert_array_equal(getattr(a, name), value)


def test_localize_needs_three_detections(clip_scene):
    _, _, frames, _, tmem, _ = clip_scene
    tc = tclip.ClipLocObjectMemory.from_object_memory(tmem, log_enabled=False)

    class Two:
        def find(self, rgb, consider_floor):
            det = ColorRegionDetector(min_area=80).find(rgb, consider_floor)
            return type(det)(det.crops[:2], det.boxes_xyxy[:2],
                             det.masks[:2], det.phrases[:2])

    k_cv = np.eye(3, dtype=np.float32)
    assert tc.localize(frames[6][0], k_cv, Two(), get_embedder("color")) \
        is None
    assert tc.ransac_samples == 0


TINY_TXT = dict(vocab_size=100, max_length=16, hidden_size=32, num_layers=2,
                num_heads=4, mlp_dim=64, projection_dim=32)


def _hf_text(with_projection=False):
    cfg = transformers.CLIPTextConfig(
        vocab_size=100, max_position_embeddings=16, hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        hidden_act="quick_gelu", attention_dropout=0.0, eos_token_id=99,
        bos_token_id=98, projection_dim=32)
    torch.manual_seed(4)
    model = (transformers.CLIPTextModelWithProjection(cfg) if with_projection
             else transformers.CLIPTextModel(cfg))
    return model.eval()


def _ids():
    ids = np.zeros((2, 16), np.int64)
    ids[0, :4] = [98, 5, 7, 99]
    ids[1, :6] = [98, 11, 12, 13, 14, 99]
    return ids


def test_clip_text_matches_jax_and_transformers(tmp_path):
    hf = _hf_text()
    sd = hf.state_dict()
    ids = _ids()
    jcfg = jtext.ClipTextConfig(**TINY_TXT)
    want = np.asarray(jtext.ClipTextEncoder(jcfg).apply(
        jtext.port_hf_clip_text_params({k: v.numpy() for k, v in sd.items()},
                                       jcfg),
        jnp.asarray(ids.astype(np.int32))))
    tcfg = ttext.ClipTextConfig(**TINY_TXT)
    model = ttext.ClipTextEncoder(tcfg)
    model.load_state_dict(ttext.port_hf_clip_text_params(sd, tcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
        ref = hf(torch.from_numpy(ids)).pooler_output.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-4)   # identity projection

    # the file's projection (CLIPTextModelWithProjection)
    hfp = _hf_text(with_projection=True)
    model.load_state_dict(ttext.port_hf_clip_text_params(hfp.state_dict(),
                                                         tcfg))
    with torch.no_grad():
        np.testing.assert_allclose(
            model(torch.from_numpy(ids)).numpy(),
            hfp(torch.from_numpy(ids)).text_embeds.numpy(), atol=1e-4)

    # the embedders, through the same checkpoint and hash tokenizer
    path = str(tmp_path / "clip_text.bin")
    torch.save(sd, path)
    jembed = jtext.build_clip_text_embedder(path, cfg=jcfg)
    tembed = ttext.build_clip_text_embedder(path, cfg=tcfg, device="cpu")
    for text in ("wooden chair", "chair table lamp"):
        np.testing.assert_allclose(tembed(text), jembed(text), atol=1e-5)
    rand = ttext.build_clip_text_embedder(cfg=tcfg, device="cpu")
    np.testing.assert_array_equal(rand("red cup"), rand("red cup"))
    assert np.abs(rand("red cup") - rand("blue sofa")).max() > 1e-6


def test_simple_tokenizer_ids_match_jax():
    texts = ["red chair", "a Wooden TABLE by the door", "", "x " * 100]
    for vocab, length in ((49408, 77), (1000, 12)):
        np.testing.assert_array_equal(
            ttext.SimpleTokenizer(vocab, length)(texts),
            jtext.SimpleTokenizer(vocab, length)(texts))


MERGES = [
    "c h", "a i", "ai r</w>", "ch air</w>", "t a", "b l", "bl e</w>",
    "ta ble</w>", "l a", "m p</w>", "la mp</w>", "s o", "f a</w>", "so fa</w>",
    "w o", "o d", "wo od", "wood en</w>", "e n</w>", "p o", "po t",
    "pot ted</w>", "t e", "te d</w>",
]
SENTENCES = [   # tests/test_clip_bpe.py's, then Unicode letters and numbers
    "a wooden chair.", "Chair, table & lamp!", "sofa   potted-plant",
    "the café 123", "",
    "x² + y³ = z¹", "٣ chairs and ٤٥ tables", "½ cup, ¾ lamp",
    "Ⅻ o'clock", "naïve façade", "北京 大学 chair", "IT'S THEY'RE we'll",
    "<|startoftext|>hello<|endoftext|>", "snake_case-words ①②",
]


@pytest.fixture(scope="module")
def bpe_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip_vocab")
    alphabet = list(tbpe.bytes_to_unicode().values())
    vocab = alphabet + [a + "</w>" for a in alphabet]
    vocab += ["".join(m.split()) for m in MERGES]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (d / "vocab.json").write_text(json.dumps({t: i for i, t in
                                              enumerate(vocab)}))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(MERGES)
                                  + "\n")
    return str(d / "vocab.json"), str(d / "merges.txt")


def test_bpe_matches_jax(bpe_files):
    assert tbpe.bytes_to_unicode() == jbpe.bytes_to_unicode()
    ours = tbpe.ClipBPETokenizer(*bpe_files)
    ref = jbpe.ClipBPETokenizer(*bpe_files)
    for s in SENTENCES:
        assert ours.tokenize(s) == ref.tokenize(s), s
        assert ours.encode(s) == ref.encode(s), s
        assert ours.encode(s, pad=False) == ref.encode(s, pad=False), s
        for text in (s, jbpe._basic_clean(s)):
            assert tbpe.pre_tokenize(text) == jbpe.re.findall(jbpe.PAT,
                                                              text), text


def test_bpe_text_embedder_matches_jax(bpe_files):
    jcfg = jtext.ClipTextConfig(**dict(TINY_TXT, vocab_size=600))
    tcfg = ttext.ClipTextConfig(**dict(TINY_TXT, vocab_size=600))
    vocab, merges = bpe_files
    jembed = jtext.build_clip_text_embedder(cfg=jcfg, vocab_path=vocab,
                                            merges_path=merges)
    tembed = ttext.build_clip_text_embedder(cfg=tcfg, vocab_path=vocab,
                                            merges_path=merges, device="cpu")
    # random weights differ; the ids reaching the model must not
    seen = []
    model = tembed.model
    hook = model.token_embedding.register_forward_hook(
        lambda m, args, out: seen.append(args[0].numpy()))
    tembed("a wooden chair")
    hook.remove()
    bpe = jbpe.ClipBPETokenizer(vocab, merges, context_length=16)
    np.testing.assert_array_equal(seen[0][0], bpe.encode("a wooden chair"))
    assert jembed("a wooden chair").shape == (32,)


def _fake_grounder(img, keyword):
    if keyword == "chair":
        return (np.array([[0.5, 0.5, 0.4, 0.4], [0.5, 0.5, 0.05, 0.02],
                          [0.3, 0.3, 0.5, 0.5]], np.float32),
                np.array([0.9, 0.95, 0.05], np.float32))
    if keyword == "cup":
        return (np.array([[0.25, 0.25, 0.2, 0.3]], np.float32),
                np.array([0.2], np.float32))
    return None, None


def _same_detections(a, b, atol=0.0):
    assert a.phrases == b.phrases
    np.testing.assert_allclose(a.boxes_xyxy, b.boxes_xyxy, atol=atol)
    if atol == 0.0:
        np.testing.assert_array_equal(a.masks, b.masks)
        for x, y in zip(a.crops, b.crops):
            np.testing.assert_array_equal(x, y)


def test_class_detector_filters_match_jax():
    assert tcls.COCO_CLASSES == jcls.COCO_CLASSES
    assert len(tcls.COCO_CLASSES) == 80
    img = (np.random.default_rng(5).random((100, 200, 3)) * 255).astype(
        np.uint8)
    classes = ["chair", "cup", "dog"]
    got = tcls.ClassVocabularyDetector(_fake_grounder, classes).find(img)
    want = jcls.ClassVocabularyDetector(_fake_grounder, classes).find(img)
    assert got.phrases == ["chair", "cup"]        # conf and area filters
    _same_detections(got, want)
    empty = tcls.ClassVocabularyDetector(lambda i, k: (None, None),
                                         ["chair"])
    assert len(empty.find(np.zeros((50, 50, 3), np.uint8))) == 0


def test_class_detector_on_a_tiny_grounding_dino(tmp_path):
    from instance_based_loc_tpu.models import gdino as jgdino
    from test_torch_gdino import (jax_config, tiny_hf_config, torch_config,
                                  write_vocab)
    torch.manual_seed(6)
    path = str(tmp_path / "gdino_tiny.bin")
    torch.save(transformers.GroundingDinoForObjectDetection(
        tiny_hf_config()).state_dict(), path)
    vocab = write_vocab(tmp_path / "vocab.txt")
    classes = ["chair", "table"]
    det = tcls.build_class_detector(path, vocab, classes=classes,
                                    cfg=torch_config(),
                                    compute_dtype="float32", device="cpu",
                                    conf_threshold=0.0,
                                    min_area_fraction=0.0)
    jg = jgdino.build_gdino_grounder(path, vocab_path=vocab,
                                     cfg=jax_config(), box_threshold=0.0,
                                     compute_dtype="float32")
    jdet = jcls.ClassVocabularyDetector(jg, classes=classes,
                                        conf_threshold=0.0,
                                        min_area_fraction=0.0)
    img = (np.random.default_rng(6).random((48, 64, 3)) * 255).astype(
        np.uint8)
    got, want = det.find(img), jdet.find(img)
    assert len(got) > 0
    _same_detections(got, want, atol=1e-4 * 64)


LORA_TINY = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
                 num_heads=4, mlp_dim=64)


def test_lora_revolver_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    jcfg = dataclasses.replace(jvit.VARIANTS["vit"], **LORA_TINY,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tvit.VARIANTS["vit"], **LORA_TINY,
                               dtype=torch.float32)
    batch = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    params = jvit.ViT(jcfg).init(jax.random.PRNGKey(0), jnp.asarray(batch))
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(
            np.float32), params)
    trunk = str(tmp_path / "trunk.npz")
    np.savez(trunk, params=np.frombuffer(pickle.dumps(tree), np.uint8))
    monkeypatch.setitem(jvit.VARIANTS, "tiny", jcfg)
    jrev = jlora.LoraRevolver(variant="tiny", checkpoint_path=trunk)
    trev = tlora.LoraRevolver(variant="vit", checkpoint_path=trunk,
                              device="cpu", cfg=tcfg)
    base = trev.encode_image(batch)
    np.testing.assert_allclose(base, jrev.encode_image(batch), atol=1e-5)

    adapter = {"block0": (rng.normal(size=(32, 4)).astype(np.float32) * 0.1,
                          rng.normal(size=(4, 96)).astype(np.float32) * 0.1),
               "block1": (rng.normal(size=(32, 4)).astype(np.float32) * 0.1,
                          rng.normal(size=(4, 96)).astype(np.float32) * 0.1)}
    for rev in (jrev, trev):
        rev.register_adapter("a", adapter)
        rev.switch_to_ckpt("a")
    adapted = trev.encode_image(batch)
    np.testing.assert_allclose(adapted, jrev.encode_image(batch), atol=1e-5)
    assert np.abs(adapted - base).max() > 1e-3
    trev.switch_to_ckpt(None)
    np.testing.assert_array_equal(trev.encode_image(batch), base)

    # the adapter npz crosses packages both ways
    jrev.save_lora_ckpt("a", str(tmp_path / "jax_adapter.npz"))
    trev.load_lora_ckpt_from_file(str(tmp_path / "jax_adapter.npz"), "b")
    trev.save_lora_ckpt("b", str(tmp_path / "port_adapter.npz"))
    jrev.load_lora_ckpt_from_file(str(tmp_path / "port_adapter.npz"), "c")
    for lib in (trev.ckpt_library["b"], jrev.ckpt_library["c"]):
        for block, (down, up) in adapter.items():
            np.testing.assert_array_equal(lib[block][0], down)
            np.testing.assert_array_equal(lib[block][1], up)
    trev.switch_to_ckpt("b")
    np.testing.assert_array_equal(trev.encode_image(batch), adapted)
