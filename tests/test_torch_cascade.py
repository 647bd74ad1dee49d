"""The port's perception cascade against the JAX package's, on the CPU.

* dedup, caption filtering, floor keywords and explicit captions on the
  weights-free fakes of `tests/test_cascade.py`: both packages'
  `CascadeDetector.find` keep the same phrases and boxes (exact);
* the box helpers: equal to the JAX package's (exact);
* the slice as a whole: one tiny official-layout SAM `.pth`, one tiny HF
  GroundingDINO `.bin` and a WordPiece vocab, loaded by both packages, with
  no RAM checkpoint (the tagger falls back to "object"). On a synthetic
  frame both `find`s keep the same phrases and boxes (atol 1e-4 of the
  frame width, in pixels: the grounders' normalised boxes to 1e-4) and
  masks agreeing on >= 99% of pixels. Then both build an object memory
  from two views with `consider_floor=True` and localise a third: the
  floor clouds match (atol 1e-4) and both poses are finite with a unit
  quaternion. Poses are not compared: RANSAC draws differ between the two
  packages, and random weights carry no identity;
* RAM: a missing checkpoint and the card by default without one raise;
  without a checkpoint the tagger returns no tags (the port's RAM itself is
  held against the JAX package in tests/test_torch_ram.py).
"""

import numpy as np
import pytest
import torch

from instance_based_loc_tpu.models import cascade as jcascade
from instance_based_loc_tpu.models import gdino as jgdino
from instance_based_loc_tpu.models import sam as jsam
from instance_based_loc_tpu.memory import ObjectMemory as JaxObjectMemory
from instance_based_loc_tpu.models.embedders import (
    get_embedder as jax_get_embedder)
from instance_based_loc_tpu_torch.models import cascade as tcascade
from instance_based_loc_tpu_torch.models import sam as tsam
from instance_based_loc_tpu_torch.models.ram import build_ram_tagger
from instance_based_loc_tpu_torch.memory import ObjectMemory
from instance_based_loc_tpu_torch.models.embedders import get_embedder
from instance_based_loc_tpu_torch.data.synthetic import (
    default_scene, render_scene, ring_poses)
from test_torch_gdino import (jax_config, tiny_hf_config, torch_config,
                              write_vocab)

transformers = pytest.importorskip("transformers")


def make_fake_cascade(cls, boxes_by_word, tags):
    def tagger(img):
        return tags

    def grounder(img, word):
        boxes = boxes_by_word.get(word)
        if boxes is None:
            return None, None
        return np.asarray(boxes, np.float32), np.ones(len(boxes))

    def segmenter(img, boxes_xyxy):
        h, w = img.shape[:2]
        masks = np.zeros((len(boxes_xyxy), h, w), bool)
        for i, b in enumerate(boxes_xyxy.astype(int)):
            masks[i, b[1]:b[3], b[0]:b[2]] = True
        return masks

    return cls(tagger, grounder, segmenter)


BIG, DUP, SMALL, FAR = ([0.5, 0.5, 0.4, 0.4], [0.5, 0.5, 0.41, 0.39],
                        [0.5, 0.5, 0.1, 0.1], [0.15, 0.15, 0.2, 0.2])


@pytest.mark.parametrize("boxes,tags,shape,floor,caption", [
    # a near-duplicate under a second keyword dropped, a much smaller box
    # at the same place kept
    ({"chair": [BIG], "seat": [DUP, FAR], "cup": [SMALL]},
     ["chair", "seat", "cup"], (100, 120, 3), False, None),
    # wall / ceiling / person filtered out, floor keywords added
    ({"chair": [[0.5, 0.5, 0.3, 0.3]], "floor": [[0.5, 0.8, 0.9, 0.2]]},
     ["chair", "wall", "ceiling", "person"], (60, 80, 3), True, None),
    ({"chair": [[0.5, 0.5, 0.3, 0.3]], "floor": [[0.5, 0.8, 0.9, 0.2]]},
     ["chair", "wall", "ceiling", "person"], (60, 80, 3), False, None),
    # an explicit caption bypasses the tagger
    ({"lamp": [[0.3, 0.3, 0.2, 0.2]]}, ["chair"], (50, 50, 3), False,
     ["lamp"]),
])
def test_cascade_rules_match_jax(boxes, tags, shape, floor, caption):
    img = np.zeros(shape, np.uint8)
    dets = [make_fake_cascade(cls, boxes, tags).find(img, floor, caption)
            for cls in (jcascade.CascadeDetector, tcascade.CascadeDetector)]
    jd, td = dets
    assert td.phrases == jd.phrases and len(td) > 0
    np.testing.assert_array_equal(td.boxes_xyxy, jd.boxes_xyxy)
    np.testing.assert_array_equal(td.masks, jd.masks)
    # find_batch gives find's results frame by frame
    tb = make_fake_cascade(tcascade.CascadeDetector, boxes, tags).find_batch(
        [img, img], floor, None if caption is None else [caption, caption])
    assert all(d.phrases == td.phrases for d in tb)


def test_box_helpers_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a, b = rng.uniform(0.05, 1.0, size=(2, 4))
        assert tcascade.box_min_area_overlap(a, b) == \
            jcascade.box_min_area_overlap(a, b)
        assert tcascade.box_area_ratio(a, b) == jcascade.box_area_ratio(a, b)
    boxes = rng.uniform(0.1, 0.9, size=(5, 4))
    np.testing.assert_array_equal(tcascade.cxcywh_to_xyxy(boxes, 200, 100),
                                  jcascade.cxcywh_to_xyxy(boxes, 200, 100))


def test_ram_with_a_checkpoint_raises(tmp_path, monkeypatch):
    """RAM is ported (tests/test_torch_ram.py holds it against the JAX
    package). What raises now: a checkpoint that is not there, and the
    random-init tagger on its default device, the card, where there is
    none. Without either the tagger returns no tags."""
    with pytest.raises(FileNotFoundError):
        build_ram_tagger(str(tmp_path / "ram_swin_large_14m.pth"),
                         device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        build_ram_tagger(random_init=True)
    assert build_ram_tagger()(np.zeros((4, 4, 3), np.uint8)) == []


SAM_TINY = dict(img_size=64, patch_size=16, encoder_dim=32, encoder_depth=3,
                encoder_heads=2, window_size=2, global_blocks=(1,),
                prompt_dim=16, decoder_depth=2, decoder_heads=2,
                decoder_mlp_dim=32, iou_head_hidden=16)
FOCAL, H, W = 80.0, 96, 128


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    """Both packages' cascades over the same tiny checkpoints."""
    root = tmp_path_factory.mktemp("cascade")
    torch.manual_seed(3)
    sam = tsam.Sam(tsam.SamConfig(**SAM_TINY))
    with torch.no_grad():     # O(0.1) weights, so masks carry structure
        for name, p in sam.state_dict().items():
            p.zero_() if name.endswith("bias") else p.normal_(0.0, 0.3)
    sam_path = str(root / "sam_tiny.pth")
    torch.save(sam.state_dict(), sam_path)
    gdino_path = str(root / "gdino_tiny.bin")
    torch.save(transformers.GroundingDinoForObjectDetection(
        tiny_hf_config()).state_dict(), gdino_path)
    vocab = write_vocab(root / "vocab.txt", ("object", "floor", "ground"))

    tdet = tcascade.build_cascade_detector(
        gdino_checkpoint=gdino_path, sam_checkpoint=sam_path,
        gdino_vocab=vocab, sam_cfg=tsam.SamConfig(**SAM_TINY),
        gdino_cfg=torch_config(), compute_dtype="float32", device="cpu")
    # the JAX package's build_cascade_detector sizes SAM from the file by
    # its ViT-B/L/H rules; assemble the same stages with the tiny configs
    jg = jgdino.build_gdino_grounder(gdino_path, vocab_path=vocab,
                                     cfg=jax_config(), compute_dtype="float32")
    jseg = jsam.build_sam_segmenter(sam_path, cfg=jsam.SamConfig(**SAM_TINY),
                                    compute_dtype="float32")

    def tagger(img):
        return ["object"]

    def grounder(img, keyword):
        return jg(img, keyword)

    grounder.detect_all = jg.detect_all
    grounder.multi_phrase = True
    jdet = jcascade.CascadeDetector(tagger, grounder, jseg)

    scene = default_scene(num_objects=4, seed=5)
    poses = ring_poses(4, radius=4.5, height=1.3, target=(0, 0.4, 0))
    frames = [render_scene(scene, p, H, W, FOCAL) for p in poses]
    return jdet, tdet, frames, poses


def test_cascade_find_matches_jax(detectors):
    jdet, tdet, frames, _ = detectors
    rgb = frames[0][0]
    jd, td = jdet.find(rgb, True), tdet.find(rgb, True)
    assert len(td) > 0 and td.phrases == jd.phrases
    assert "floor" in td.phrases or "ground" in td.phrases
    np.testing.assert_allclose(td.boxes_xyxy, jd.boxes_xyxy, atol=1e-4 * W,
                               rtol=0)
    assert td.masks.shape == jd.masks.shape == (len(td), H, W)
    assert (td.masks == jd.masks).mean() >= 0.99


def test_memory_and_localise_through_both_cascades(detectors):
    jdet, tdet, frames, poses = detectors
    memories = []
    for cls, det, embed, kw in (
            (JaxObjectMemory, jdet, jax_get_embedder("color"), {}),
            (ObjectMemory, tdet, get_embedder("color"), {"device": "cpu"})):
        mem = cls(detector=det, camera_focal_lenth_x=FOCAL,
                  camera_focal_lenth_y=FOCAL, get_embeddings_func=embed,
                  log_enabled=False, **kw)
        for i in (0, 2):
            rgb, depth, _ = frames[i]
            mem.process_image(rgb, depth, poses[i], consider_floor=True,
                              min_points=50, outlier_removal_config=None)
        rgb, depth, _ = frames[1]
        pose, _ = mem.localise(rgb, depth, outlier_removal_config=None)
        pose = np.asarray(pose, np.float64)
        assert pose.shape == (7,) and np.all(np.isfinite(pose))
        assert abs(np.linalg.norm(pose[3:]) - 1.0) < 1e-3
        memories.append(mem)
    jmem, tmem = memories
    assert len(tmem.memory) == len(jmem.memory)
    assert tmem.floors is not None and jmem.floors is not None
    # the same points, held in another order
    tf, jf = (np.asarray(m.floors.points()) for m in (tmem, jmem))
    assert tf.shape == jf.shape
    tf, jf = (p[np.lexsort(np.round(p, 3).T)] for p in (tf, jf))
    np.testing.assert_allclose(tf, jf, atol=1e-4, rtol=0)
