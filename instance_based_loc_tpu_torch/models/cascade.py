"""The perception cascade: tagging -> caption filtering -> grounded box
detection (cross-keyword dedup) -> box-prompted segmentation -> grounded
crops (counterpart of `instance_based_loc_tpu/models/cascade.py`).

Three pluggable stages:

    tagger(rgb) -> list[str]                         (RAM)
    grounder(rgb, keyword) -> (boxes_cxcywh_norm, scores)   (GroundingDINO)
    segmenter(rgb, boxes_xyxy) -> (M, H, W) bool     (SAM)

The dedup rule is the reference's (object_finder.py:158-207): a box is a
duplicate iff its min-area-normalised overlap with an accepted box exceeds
`intersection_threshold` AND the min/max area ratio exceeds
`size_threshold`.
"""

from __future__ import annotations

import numpy as np

from ..memory.detection import Detections
from ..memory.phrases import filter_caption

DEFAULTS = dict(
    intersection_threshold=0.7,  # object_finder.py setup: box-merge overlap
    size_threshold=0.75,         # area ratio
)


def box_min_area_overlap(rect1, rect2) -> float:
    """Overlap normalised by the SMALLER box's area (the reference's
    'get_box_iou', object_finder.py:158-170), boxes as (cx, cy, w, h)."""
    a1 = rect1[2] * rect1[3]
    a2 = rect2[2] * rect2[3]
    tl = (max(rect1[0], rect2[0]), max(rect1[1], rect2[1]))
    br = (min(rect1[0] + rect1[2], rect2[0] + rect2[2]),
          min(rect1[1] + rect1[3], rect2[1] + rect2[3]))
    if br[0] <= tl[0] or br[1] <= tl[1]:
        return 0.0
    overlap = abs((br[0] - tl[0]) * (br[1] - tl[1]))
    return overlap / min(a1, a2)


def box_area_ratio(rect1, rect2) -> float:
    a1 = rect1[2] * rect1[3]
    a2 = rect2[2] * rect2[3]
    return min(a1, a2) / max(a1, a2)


def cxcywh_to_xyxy(boxes: np.ndarray, width: int, height: int) -> np.ndarray:
    """Normalised cxcywh -> pixel xyxy."""
    cx, cy, w, h = boxes.T
    return np.stack([(cx - w / 2) * width, (cy - h / 2) * height,
                     (cx + w / 2) * width, (cy + h / 2) * height], axis=1)


class CascadeDetector:
    """RAM -> GroundingDINO -> SAM orchestration with pluggable stages."""

    def __init__(self, tagger, grounder, segmenter,
                 intersection_threshold: float = DEFAULTS["intersection_threshold"],
                 size_threshold: float = DEFAULTS["size_threshold"],
                 log_enabled: bool = False):
        self.tagger = tagger
        self.grounder = grounder
        self.segmenter = segmenter
        self.intersection_threshold = intersection_threshold
        self.size_threshold = size_threshold
        self.log_enabled = log_enabled

    def _keywords(self, caption, consider_floor: bool) -> list[str]:
        keywords = filter_caption(caption)
        if consider_floor:
            keywords += ["floor", "ground"]
        if self.log_enabled:
            print(f"Filtered caption post tagging: {keywords}")
        return keywords

    def _ground(self, img: np.ndarray, keywords: list[str]):
        """Per-keyword grounding with cross-keyword dedup, keyword order
        kept -> (kept cxcywh boxes, kept phrases)."""
        if getattr(self.grounder, "multi_phrase", False):
            per_keyword = self.grounder.detect_all(img,
                                                   [str(w) for w in keywords])
        else:
            per_keyword = [self.grounder(img, str(w)) for w in keywords]
        kept_boxes: list[np.ndarray] = []
        kept_phrases: list[str] = []
        for word, (boxes, _scores) in zip(keywords, per_keyword):
            if boxes is None or len(boxes) == 0:
                continue
            for box in np.asarray(boxes):
                unique = True
                for prev in kept_boxes:
                    if (box_min_area_overlap(box, prev) > self.intersection_threshold
                            and box_area_ratio(box, prev) > self.size_threshold):
                        unique = False
                        break
                if unique:
                    kept_boxes.append(box)
                    kept_phrases.append(word)
        return kept_boxes, kept_phrases

    @staticmethod
    def _pixel_boxes(kept_boxes, w: int, h: int) -> np.ndarray:
        boxes_xyxy = cxcywh_to_xyxy(np.stack(kept_boxes), w, h)
        boxes_xyxy[:, 0::2] = np.clip(boxes_xyxy[:, 0::2], 0, w)
        boxes_xyxy[:, 1::2] = np.clip(boxes_xyxy[:, 1::2], 0, h)
        return boxes_xyxy

    @staticmethod
    def _detections(img, boxes_xyxy, masks, phrases) -> Detections:
        crops = [img[int(b[1]):max(int(b[3]), int(b[1]) + 1),
                     int(b[0]):max(int(b[2]), int(b[0]) + 1)]
                 for b in boxes_xyxy]
        return Detections(crops, boxes_xyxy.astype(np.float32),
                          np.asarray(masks).astype(bool), phrases)

    def find(self, rgb_image: np.ndarray, consider_floor: bool,
             caption: list[str] | None = None) -> Detections:
        img = np.asarray(rgb_image)
        h, w = img.shape[:2]
        if caption is None or len(caption) == 0:
            caption = list(self.tagger(img))
        keywords = self._keywords(caption, consider_floor)
        kept_boxes, kept_phrases = self._ground(img, keywords)
        if not kept_boxes:
            return Detections.empty(h, w)
        boxes_xyxy = self._pixel_boxes(kept_boxes, w, h)
        masks = self.segmenter(img, boxes_xyxy)
        return self._detections(img, boxes_xyxy, masks, kept_phrases)

    def find_batch(self, frames, consider_floor: bool,
                   captions=None) -> list[Detections]:
        """`find` over a chunk of frames, per-frame results unchanged: the
        tagger takes the chunk in one call (`tag_batch`), grounding stays
        per frame, and the segmenter takes every frame with boxes in one
        call (`segment_batch`)."""
        frames = [np.asarray(f) for f in frames]
        caps = (list(captions) if captions is not None
                else [None] * len(frames))
        need = [i for i, c in enumerate(caps) if c is None or len(c) == 0]
        if need:
            if hasattr(self.tagger, "tag_batch"):
                tagged = self.tagger.tag_batch([frames[i] for i in need])
            else:
                tagged = [self.tagger(frames[i]) for i in need]
            for i, tags in zip(need, tagged):
                caps[i] = list(tags)

        results: list[Detections | None] = [None] * len(frames)
        pend: list[tuple[int, np.ndarray, list[str]]] = []
        for i, (img, cap) in enumerate(zip(frames, caps)):
            h, w = img.shape[:2]
            keywords = self._keywords(cap, consider_floor)
            kept_boxes, kept_phrases = self._ground(img, keywords)
            if not kept_boxes:
                results[i] = Detections.empty(h, w)
            else:
                pend.append((i, self._pixel_boxes(kept_boxes, w, h),
                             kept_phrases))
        if pend:
            if hasattr(self.segmenter, "segment_batch"):
                masks_list = self.segmenter.segment_batch(
                    [frames[i] for i, _, _ in pend], [b for _, b, _ in pend])
            else:
                masks_list = [self.segmenter(frames[i], b)
                              for i, b, _ in pend]
            for (i, boxes_xyxy, phrases), masks in zip(pend, masks_list):
                results[i] = self._detections(frames[i], boxes_xyxy, masks,
                                              phrases)
        return results


def build_cascade_detector(ram_checkpoint: str | None = None,
                           gdino_checkpoint: str | None = None,
                           sam_checkpoint: str | None = None,
                           gdino_vocab: str | None = None,
                           ram_tag_list: str | None = None,
                           random_init: bool = False, sam_cfg=None,
                           gdino_cfg=None, ram_cfg=None, compute_dtype=None,
                           device="cuda", **kwargs) -> CascadeDetector:
    """RAM tagger (models/ram.py) -> GroundingDINO grounder
    (models/gdino.py) -> SAM segmenter (models/sam.py).

    Checkpoints load where given. `random_init=True` builds GroundingDINO
    (and SAM, without `sam_checkpoint`, and RAM, without `ram_checkpoint`)
    from random weights of `gdino_cfg`, `sam_cfg` and `ram_cfg` (the
    packages' defaults when None: GroundingDINO's Swin-B / BERT-base / 900
    queries, SAM ViT-B, RAM's Swin-L/384 with one tag per line of
    `ram_tag_list`). `ram_tag_list` is the tag vocabulary file
    (`ram_tag_list.txt`). Without a GroundingDINO model the grounder
    proposes one near-full-image box per keyword; without a RAM model the
    tagger returns no tags. A frame without tags is grounded with the
    caption ["object"]. `kwargs` go to `CascadeDetector`."""
    from .gdino import build_gdino_grounder
    from .ram import build_ram_tagger
    from .sam import build_sam_segmenter

    segmenter = build_sam_segmenter(sam_checkpoint, cfg=sam_cfg,
                                    compute_dtype=compute_dtype, device=device)
    ram_tagger = build_ram_tagger(
        ram_checkpoint, tag_list_path=ram_tag_list, cfg=ram_cfg,
        image_size=384 if ram_cfg is None else ram_cfg.backbone.img_size,
        compute_dtype=compute_dtype,
        random_init=random_init and ram_checkpoint is None, device=device)
    if gdino_checkpoint or random_init:
        grounder = build_gdino_grounder(
            gdino_checkpoint, vocab_path=gdino_vocab, cfg=gdino_cfg,
            compute_dtype=compute_dtype, random_init=gdino_checkpoint is None,
            device=device)
    else:
        def grounder(img, keyword):
            return (np.array([[0.5, 0.5, 0.9, 0.9]], np.float32),
                    np.array([1.0]))

    def tagger(img):
        tags = ram_tagger(img)
        return tags if tags else ["object"]

    tagger.tag_batch = lambda frames: [
        tags if tags else ["object"] for tags in ram_tagger.tag_batch(frames)]
    tagger.ram = ram_tagger
    return CascadeDetector(tagger, grounder, segmenter, **kwargs)
