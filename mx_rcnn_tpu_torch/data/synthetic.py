"""Synthetic dataset (counterpart of ``mx_rcnn_tpu/data/synthetic.py``): every
driver runs with no data on disk.

Images are noise with solid-colour rectangles at the gt boxes (class ↔
colour), drawn from numpy seeds exactly as the JAX package draws them, so
the two packages see the same pixels and boxes.  Detections are scored by
the VOC scorer (AP at IoU 0.5, area under the PR curve).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.eval.voc_eval import voc_eval


class SyntheticDataset(IMDB):
    def __init__(self, num_images: int = 64, num_classes: int = 21,
                 height: int = 600, width: int = 800, max_objects: int = 6,
                 seed: int = 0):
        super().__init__("synthetic", f"n{num_images}", "data", "data")
        self.classes = ["__background__"] + [f"class{i}" for i in
                                             range(1, num_classes)]
        self.num_images = num_images
        self._h, self._w = height, width
        self._max_objects = max_objects
        self._seed = seed
        self._roidb: Optional[list] = None

    def _colors(self):
        rng = np.random.RandomState(1234)
        return rng.randint(40, 255, size=(self.num_classes, 3))

    def gt_roidb(self) -> list:
        if self._roidb is not None:
            return self._roidb
        rng = np.random.RandomState(self._seed)
        colors = self._colors()
        roidb = []
        for i in range(self.num_images):
            n = rng.randint(1, self._max_objects + 1)
            boxes = np.zeros((n, 4), np.float32)
            classes = np.zeros((n,), np.int32)
            img = (rng.randn(self._h, self._w, 3) * 20 + 127).clip(0, 255)
            for j in range(n):
                bw = rng.randint(max(self._w // 5, 8), max(self._w // 2, 16))
                bh = rng.randint(max(self._h // 5, 8), max(self._h // 2, 16))
                x1 = rng.randint(0, self._w - bw)
                y1 = rng.randint(0, self._h - bh)
                cls = rng.randint(1, self.num_classes)
                boxes[j] = (x1, y1, x1 + bw - 1, y1 + bh - 1)
                classes[j] = cls
                img[y1:y1 + bh, x1:x1 + bw] = colors[cls]
            overlaps = np.zeros((n, self.num_classes), np.float32)
            overlaps[np.arange(n), classes] = 1.0
            roidb.append({
                "image": f"synthetic://{i}",
                "image_array": img.astype(np.uint8),
                "height": self._h, "width": self._w,
                "boxes": boxes, "gt_classes": classes,
                "gt_overlaps": overlaps,
                "max_classes": classes.copy(),
                "max_overlaps": np.ones((n,), np.float32),
                "flipped": False,
            })
        self._roidb = roidb
        return roidb

    def evaluate_detections(self, detections) -> dict:
        """Greedy-match AP at IoU 0.5 per class through the VOC scorer;
        returns {class: AP, 'mAP': mean}."""
        recs = {}
        for i, rec in enumerate(self.gt_roidb()):
            recs[i] = [{"name": self.classes[c], "difficult": 0,
                        "bbox": list(map(float, b))}
                       for b, c in zip(rec["boxes"], rec["gt_classes"])]
        aps = {}
        for k, cls in enumerate(self.classes):
            if k == 0:
                continue
            aps[cls] = voc_eval(detections[k], recs, cls, ovthresh=0.5,
                                use_07_metric=False)
        aps["mAP"] = float(np.mean(list(aps.values())))
        return aps
