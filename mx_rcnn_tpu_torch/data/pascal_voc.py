"""PASCAL VOC dataset (counterpart of ``mx_rcnn_tpu/data/pascal_voc.py``;
reference ``rcnn/dataset/pascal_voc.py``).

The VOCdevkit layout (``VOC<year>/{JPEGImages,Annotations,ImageSets/
Main}``), XML annotations read with the standard library's ElementTree
(difficult objects left out of the training roidb), the pickle-cached
``gt_roidb``, the official per-class result files and ``voc_eval`` scoring.
Image sizes come from the file headers (``data/image.py:image_size``).
Selective-search proposals are not ported.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from mx_rcnn_tpu_torch.data.image import image_size
from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.eval.voc_eval import voc_eval
from mx_rcnn_tpu_torch.logger import logger

VOC_CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def parse_voc_rec(filename: str) -> List[Dict]:
    """One VOC XML annotation → object dicts {name, difficult, bbox}, the
    bbox 0-indexed (VOC's pixels are 1-indexed)."""
    tree = ET.parse(filename)
    objects = []
    for obj in tree.findall("object"):
        bbox = obj.find("bndbox")
        objects.append({
            "name": obj.find("name").text,
            "difficult": int(obj.find("difficult").text)
            if obj.find("difficult") is not None else 0,
            "bbox": [int(float(bbox.find("xmin").text)) - 1,
                     int(float(bbox.find("ymin").text)) - 1,
                     int(float(bbox.find("xmax").text)) - 1,
                     int(float(bbox.find("ymax").text)) - 1],
        })
    return objects


class PascalVOC(IMDB):
    """``image_set`` is ``<year>_<set>`` or a ``+``-join of several
    (``2007_trainval+2012_trainval``)."""

    def __init__(self, image_set: str, root_path: str, dataset_path: str):
        super().__init__("voc", image_set, root_path, dataset_path)
        self.classes = list(VOC_CLASSES)
        self._sets = image_set.split("+")
        self._index: List[tuple] = []  # (year, image_id)
        for s in self._sets:
            year, split = s.split("_")
            for idx in self._load_image_set_index(year, split):
                self._index.append((year, idx))
        self.num_images = len(self._index)
        logger.info("%s: %d images", self.name, self.num_images)

    def _devkit(self, year: str) -> str:
        return os.path.join(self.data_path, f"VOC{year}")

    def _load_image_set_index(self, year: str, split: str) -> List[str]:
        path = os.path.join(self._devkit(year), "ImageSets", "Main",
                            split + ".txt")
        with open(path) as f:
            return [line.strip().split()[0] for line in f if line.strip()]

    def image_path(self, i: int) -> str:
        year, idx = self._index[i]
        return os.path.join(self._devkit(year), "JPEGImages", idx + ".jpg")

    def annotation_path(self, i: int) -> str:
        year, idx = self._index[i]
        return os.path.join(self._devkit(year), "Annotations", idx + ".xml")

    def gt_roidb(self) -> list:
        return self.load_cached("gt_roidb", self._build_gt_roidb)

    def _build_gt_roidb(self) -> list:
        name_to_cls = {n: i for i, n in enumerate(self.classes)}
        roidb = []
        for i in range(self.num_images):
            objs = [o for o in parse_voc_rec(self.annotation_path(i))
                    if not o["difficult"]]
            g = len(objs)
            boxes = np.zeros((g, 4), np.float32)
            gt_classes = np.zeros((g,), np.int32)
            overlaps = np.zeros((g, self.num_classes), np.float32)
            for j, o in enumerate(objs):
                boxes[j] = o["bbox"]
                cls = name_to_cls[o["name"]]
                gt_classes[j] = cls
                overlaps[j, cls] = 1.0
            h, w = image_size(self.image_path(i))
            roidb.append({
                "image": self.image_path(i),
                "height": h, "width": w,
                "boxes": boxes, "gt_classes": gt_classes,
                "gt_overlaps": overlaps,
                "max_classes": overlaps.argmax(axis=1),
                "max_overlaps": overlaps.max(axis=1) if g else np.zeros((0,)),
                "flipped": False,
            })
        return roidb

    def write_results(self, detections, out_dir: str) -> None:
        """The official per-class result files ``comp4_det_<set>_<cls>.txt``,
        rows ``id score x1 y1 x2 y2`` in 1-indexed pixels."""
        os.makedirs(out_dir, exist_ok=True)
        for k, cls in enumerate(self.classes):
            if cls == "__background__":
                continue
            path = os.path.join(out_dir,
                                f"comp4_det_{self.image_set}_{cls}.txt")
            with open(path, "w") as f:
                for i, dets in enumerate(detections[k]):
                    if dets is None or len(dets) == 0:
                        continue
                    _, idx = self._index[i]
                    for d in dets:
                        f.write(f"{idx} {d[4]:.3f} {d[0] + 1:.1f} "
                                f"{d[1] + 1:.1f} {d[2] + 1:.1f} {d[3] + 1:.1f}\n")
        logger.info("wrote VOC result files to %s", out_dir)

    def evaluate_detections(self, detections, use_07_metric: bool = True,
                            out_dir: Optional[str] = None) -> dict:
        """``detections``: per class (index 0 unused) per image (N, 5)
        [x1,y1,x2,y2,score] arrays, the ``all_boxes`` layout of
        ``pred_eval``.  Returns {class: AP, 'mAP': mean}; every image's
        objects count, difficult ones as the devkit rules say."""
        if out_dir:
            self.write_results(detections, out_dir)
        recs = {i: parse_voc_rec(self.annotation_path(i))
                for i in range(self.num_images)}
        aps = {}
        for k, cls in enumerate(self.classes):
            if cls == "__background__":
                continue
            aps[cls] = voc_eval(detections[k], recs, cls, ovthresh=0.5,
                                use_07_metric=use_07_metric)
            logger.info("AP for %s = %.4f", cls, aps[cls])
        aps["mAP"] = float(np.mean([v for v in aps.values()]))
        logger.info("Mean AP = %.4f", aps["mAP"])
        return aps
