"""Dataset base class (counterpart of ``mx_rcnn_tpu/data/imdb.py``;
reference ``rcnn/dataset/imdb.py``).

The roidb contract is the reference's: a list of per-image dicts

    {image, height, width,
     boxes: (G, 4) float32 [x1, y1, x2, y2],
     gt_classes: (G,) int32 (0 = background, never present in gt),
     gt_overlaps, max_classes, max_overlaps, flipped: bool}

plus ``append_flipped_images`` (x-mirror the boxes, mark flipped — the
pixels are mirrored when the batch is prepped), ``filter_roidb`` and the
pickle cache (``root_path/cache/{name}_{tag}.pkl``, the JAX package's file
names and plain numpy/dict contents, so either package reads the other's
cache).  A record may carry ``proposals`` (P, 4) float32 in its original
frame (``utils/load_data.py:load_proposals``, or
``eval/tester.py:generate_proposals``): :meth:`IMDB.sanitize_proposals`
clips them into the image once, and a flipped copy mirrors them.
"""

from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np

from mx_rcnn_tpu_torch.logger import logger


class IMDB:
    def __init__(self, name: str, image_set: str, root_path: str,
                 dataset_path: str):
        self.name = name + "_" + image_set
        self.image_set = image_set
        self.root_path = root_path
        self.data_path = dataset_path
        self.classes: List[str] = []
        self.num_images = 0

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @property
    def cache_path(self) -> str:
        p = os.path.join(self.root_path, "cache")
        os.makedirs(p, exist_ok=True)
        return p

    def gt_roidb(self) -> list:
        raise NotImplementedError

    def evaluate_detections(self, detections) -> dict:
        raise NotImplementedError

    def load_cached(self, tag: str, make):
        """``make()``'s result, pickled once under :attr:`cache_path`
        and read back from there afterwards."""
        cache_file = os.path.join(self.cache_path, f"{self.name}_{tag}.pkl")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as f:
                data = pickle.load(f)
            logger.info("%s %s loaded from %s", self.name, tag, cache_file)
            return data
        data = make()
        with open(cache_file, "wb") as f:
            pickle.dump(data, f, pickle.HIGHEST_PROTOCOL)
        logger.info("%s wrote %s cache to %s", self.name, tag, cache_file)
        return data

    @staticmethod
    def sanitize_proposals(boxes, width: int, height: int) -> np.ndarray:
        """External proposals clipped into the image, with each degenerate
        row (x2 < x1 or y2 < y1) repaired to zero extent: done once where
        they are attached, so a record and its flipped copy hold the same
        geometry.  → (P, 4) float32."""
        boxes = np.asarray(boxes, dtype=np.float32)
        if len(boxes) == 0:
            return boxes.reshape(0, 4)
        boxes = boxes.copy()
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, width - 1)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, height - 1)
        boxes[:, 2] = np.maximum(boxes[:, 0], boxes[:, 2])
        boxes[:, 3] = np.maximum(boxes[:, 1], boxes[:, 3])
        return boxes

    def append_flipped_images(self, roidb: list) -> list:
        """Double the roidb with x-flipped records: boxes mirrored on the
        image width (``x → w − x − 1``), ``flipped`` set.  A record with
        ``proposals`` gets them sanitized in place and mirrored in its
        copy (attach, then flip)."""

        def mirror(boxes, w):
            boxes = boxes.copy()
            x1 = boxes[:, 0].copy()
            x2 = boxes[:, 2].copy()
            boxes[:, 0] = w - x2 - 1
            boxes[:, 2] = w - x1 - 1
            return boxes

        flipped = []
        for rec in roidb:
            boxes = mirror(rec["boxes"], rec["width"])
            if not (boxes[:, 2] >= boxes[:, 0]).all():
                raise ValueError(f"degenerate gt boxes in {rec['image']}")
            new = dict(rec, boxes=boxes, flipped=True)
            if "proposals" in rec:
                props = self.sanitize_proposals(rec["proposals"],
                                                rec["width"], rec["height"])
                rec["proposals"] = props
                new["proposals"] = (mirror(props, rec["width"]) if len(props)
                                    else props)
            flipped.append(new)
        logger.info("%s appended %d flipped images", self.name, len(flipped))
        return list(roidb) + flipped

    @staticmethod
    def filter_roidb(roidb: list, min_gt: int = 1) -> list:
        """Drop images with no usable gt (the reference's train_end2end
        filter)."""
        keep = [r for r in roidb if len(r["boxes"]) >= min_gt]
        logger.info("filtered roidb: %d -> %d images", len(roidb), len(keep))
        return keep
