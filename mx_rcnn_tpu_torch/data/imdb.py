"""Dataset base class (counterpart of ``mx_rcnn_tpu/data/imdb.py``;
reference ``rcnn/dataset/imdb.py``).

The roidb contract is the reference's: a list of per-image dicts

    {image, height, width,
     boxes: (G, 4) float32 [x1, y1, x2, y2],
     gt_classes: (G,) int32 (0 = background, never present in gt),
     gt_overlaps, max_classes, max_overlaps, flipped: bool}

plus ``append_flipped_images`` (x-mirror the boxes, mark flipped — the
pixels are mirrored when the batch is prepped) and ``filter_roidb``.  The
pickle cache, external proposals and the VOC/COCO readers are not
ported.
"""

from __future__ import annotations

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

    def gt_roidb(self) -> list:
        raise NotImplementedError

    def append_flipped_images(self, roidb: list) -> list:
        """Double the roidb with x-flipped records: boxes mirrored on the
        image width (``x → w − x − 1``), ``flipped`` set."""

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
            flipped.append(dict(rec, boxes=boxes, flipped=True))
        logger.info("%s appended %d flipped images", self.name, len(flipped))
        return list(roidb) + flipped

    @staticmethod
    def filter_roidb(roidb: list, min_gt: int = 1) -> list:
        """Drop images with no usable gt (the reference's train_end2end
        filter)."""
        keep = [r for r in roidb if len(r["boxes"]) >= min_gt]
        logger.info("filtered roidb: %d -> %d images", len(roidb), len(keep))
        return keep
