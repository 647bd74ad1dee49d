"""Class-vocabulary detector, clip_loc's query-side detection stage
(counterpart of `instance_based_loc_tpu/models/class_detector.py`; the
reference runs ultralytics YOLOv8x over the 80 COCO classes with conf > 0.1
and box area > 1% of the image, `clip_loc/yolo_utils.py:27-57`).

The GroundingDINO grounder (`models/gdino.py`) is prompted with each class
name, an open-vocabulary superset of YOLO's closed COCO head, and the
reference's confidence and area filters apply on top. Any callable
`grounder(rgb, keyword) -> (boxes_cxcywh_norm, scores)` plugs in.
"""

from __future__ import annotations

import numpy as np

from ..memory.detection import Detections

# The 80 COCO class names (data, reproduced from the reference's
# yolo_utils.py:9-22 — they define the detector's closed vocabulary).
COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "TV",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]


class ClassVocabularyDetector:
    """find(rgb, consider_floor) -> Detections over a fixed class list with
    the reference's conf > 0.1 and area > 1% filters."""

    def __init__(self, grounder, classes=None, conf_threshold: float = 0.1,
                 min_area_fraction: float = 0.01):
        self.grounder = grounder
        self.classes = list(classes or COCO_CLASSES)
        self.conf_threshold = conf_threshold
        self.min_area_fraction = min_area_fraction

    def find(self, rgb_image: np.ndarray, consider_floor: bool = False
             ) -> Detections:
        img = np.asarray(rgb_image)
        h, w = img.shape[:2]
        image_area = float(h * w)
        boxes_list, phrases = [], []
        for cls in self.classes:
            boxes, scores = self.grounder(img, cls)
            if boxes is None or len(boxes) == 0:
                continue
            for box, score in zip(np.asarray(boxes), np.asarray(scores)):
                cx, cy, bw, bh = box
                x1 = (cx - bw / 2) * w
                y1 = (cy - bh / 2) * h
                x2 = (cx + bw / 2) * w
                y2 = (cy + bh / 2) * h
                x1, x2 = np.clip([x1, x2], 0, w)
                y1, y2 = np.clip([y1, y2], 0, h)
                area = (x2 - x1) * (y2 - y1)
                # reference filters: conf > 0.1 AND area > 1% of the image
                if score > self.conf_threshold \
                        and area > self.min_area_fraction * image_area:
                    boxes_list.append([x1, y1, x2, y2])
                    phrases.append(cls)
        if not boxes_list:
            return Detections.empty(h, w)
        boxes_xyxy = np.asarray(boxes_list, np.float32)
        masks = np.zeros((len(boxes_xyxy), h, w), bool)
        crops = []
        for i, b in enumerate(boxes_xyxy):
            y1, y2 = int(b[1]), max(int(b[3]), int(b[1]) + 1)
            x1, x2 = int(b[0]), max(int(b[2]), int(b[0]) + 1)
            masks[i, y1:y2, x1:x2] = True
            crops.append(img[y1:y2, x1:x2])
        return Detections(crops, boxes_xyxy, masks, phrases)


def build_class_detector(gdino_checkpoint: str | None = None,
                         gdino_vocab: str | None = None,
                         classes=None, random_init: bool = False, cfg=None,
                         compute_dtype=None, device="cuda",
                         **kwargs) -> ClassVocabularyDetector:
    """The runnable clip_loc detector: GroundingDINO over the COCO classes,
    from an HF checkpoint or (`random_init=True`) random weights of `cfg`
    (GroundingDINO's deployment width by default); `kwargs` go to
    `ClassVocabularyDetector`. The JAX package's checkpoint-less grounder
    yields no boxes; the port's grounder needs one of the two."""
    from .gdino import build_gdino_grounder
    grounder = build_gdino_grounder(gdino_checkpoint, vocab_path=gdino_vocab,
                                    box_threshold=0.0, cfg=cfg,
                                    compute_dtype=compute_dtype,
                                    random_init=random_init, device=device)
    return ClassVocabularyDetector(grounder, classes=classes, **kwargs)
