"""COCO dataset (counterpart of ``mx_rcnn_tpu/data/coco_dataset.py``;
reference ``rcnn/dataset/coco.py``), without pycocotools.

``{dataset_path}/annotations/instances_{image_set}.json`` is indexed
directly with the standard library's ``json``: the sparse category ids map
to contiguous classes 1..K in id order, the images are taken in id order,
and ``gt_roidb`` keeps the reference's sanitisation (crowd boxes left out,
xywh → x1y1x2y2 clipped into the image with the legacy −1, empty boxes
dropped), pickle-cached under the JAX package's file name.  Detections go
out as COCO results records (xywh with the legacy +1, raw scores) and are
scored by ``eval/coco_eval.py``; with masks (``evaluate_sds``) the RLEs
go out as segm records and box and segm are both scored.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.eval.mask_rle import area
from mx_rcnn_tpu_torch.logger import logger


class COCODataset(IMDB):
    """``image_set``: train2017 / val2017 / minival2014-style names; images
    under ``{dataset_path}/{image_set}``, annotations under
    ``{dataset_path}/annotations/instances_{image_set}.json``."""

    def __init__(self, image_set: str, root_path: str, dataset_path: str):
        super().__init__("coco", image_set, root_path, dataset_path)
        self.ann_file = os.path.join(dataset_path, "annotations",
                                     f"instances_{image_set}.json")
        with open(self.ann_file) as f:
            ann = json.load(f)

        # COCO's category ids are sparse: contiguous classes 1..K in id order
        cats = sorted(ann["categories"], key=lambda c: c["id"])
        self.classes = ["__background__"] + [c["name"] for c in cats]
        self._cat_to_cls = {c["id"]: i + 1 for i, c in enumerate(cats)}
        self._cls_to_cat = {i + 1: c["id"] for i, c in enumerate(cats)}

        self._images: List[Dict] = sorted(ann["images"], key=lambda r: r["id"])
        self.num_images = len(self._images)

        self._anns_by_image: Dict[int, list] = {im["id"]: []
                                                for im in self._images}
        for a in ann["annotations"]:
            if a["image_id"] in self._anns_by_image:
                self._anns_by_image[a["image_id"]].append(a)
        logger.info("%s: %d images, %d classes", self.name, self.num_images,
                    self.num_classes)

    def image_path(self, i: int) -> str:
        return os.path.join(self.data_path, self.image_set,
                            self._images[i]["file_name"])

    @property
    def image_ids(self) -> List[int]:
        return [im["id"] for im in self._images]

    def gt_roidb(self) -> list:
        return self.load_cached("gt_roidb", self._build_gt_roidb)

    def _build_gt_roidb(self) -> list:
        roidb = []
        for i, im in enumerate(self._images):
            h, w = im["height"], im["width"]
            objs = []
            for a in self._anns_by_image[im["id"]]:
                if a.get("iscrowd", 0):
                    continue  # crowd boxes are not training targets
                x, y, bw, bh = a["bbox"]
                # xywh → x1y1x2y2, clipped into the image
                x1 = max(0.0, x)
                y1 = max(0.0, y)
                x2 = min(w - 1.0, x1 + max(0.0, bw - 1.0))
                y2 = min(h - 1.0, y1 + max(0.0, bh - 1.0))
                if a.get("area", 0) > 0 and x2 >= x1 and y2 >= y1:
                    objs.append((x1, y1, x2, y2,
                                 self._cat_to_cls[a["category_id"]],
                                 a.get("segmentation")))
            g = len(objs)
            boxes = np.zeros((g, 4), np.float32)
            gt_classes = np.zeros((g,), np.int32)
            overlaps = np.zeros((g, self.num_classes), np.float32)
            segs = []
            for j, (x1, y1, x2, y2, cls, seg) in enumerate(objs):
                boxes[j] = (x1, y1, x2, y2)
                gt_classes[j] = cls
                overlaps[j, cls] = 1.0
                segs.append(seg)
            roidb.append({
                "image": self.image_path(i), "height": h, "width": w,
                "boxes": boxes, "gt_classes": gt_classes,
                "gt_overlaps": overlaps,
                "max_classes": overlaps.argmax(axis=1),
                "max_overlaps": overlaps.max(axis=1) if g else np.zeros((0,)),
                "segmentation": segs,
                "flipped": False,
            })
        return roidb

    # -- evaluation ----------------------------------------------------------
    def detections_to_coco(self, detections) -> list:
        """The ``all_boxes`` layout (per class, per roidb position, (N, 5)
        [x1, y1, x2, y2, score]) → COCO results records, xywh with the
        legacy +1, scores kept raw."""
        results = []
        for k in range(1, self.num_classes):
            cat_id = self._cls_to_cat[k]
            per_img = detections[k]
            for i, dets in enumerate(per_img):
                if dets is None or len(dets) == 0:
                    continue
                img_id = self._images[i]["id"]
                for x1, y1, x2, y2, sc in np.asarray(dets, np.float64):
                    results.append({
                        "image_id": int(img_id), "category_id": int(cat_id),
                        "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                        "score": float(sc),
                    })
        return results

    def evaluate_detections(self, detections, iou_type: str = "bbox") -> dict:
        """:meth:`detections_to_coco` scored by ``COCOEval`` → the 12
        COCO stats (AP, AP50, AP75, APs, APm, APl, AR1, AR10, AR100, ARs,
        ARm, ARl)."""
        from mx_rcnn_tpu_torch.eval.coco_eval import COCOEval

        results = self.detections_to_coco(detections)
        ev = COCOEval(self.ann_file, results, iou_type=iou_type)
        stats = ev.evaluate()
        logger.info("COCO %s AP: %.4f (AP50 %.4f AP75 %.4f)", iou_type,
                    stats["AP"], stats["AP50"], stats["AP75"])
        return stats

    def segmentations_to_coco(self, detections, masks) -> list:
        """``all_boxes`` and ``all_masks`` (full-image RLE dicts row for row
        with ``all_boxes``) → COCO segm results records: the RLE, its area
        and the detection's score; a row without a mask is left out."""
        results = []
        for k in range(1, self.num_classes):
            cat_id = self._cls_to_cat[k]
            for i, dets in enumerate(detections[k]):
                if dets is None or len(dets) == 0:
                    continue
                img_id = self._images[i]["id"]
                row_masks = masks[k][i] or []
                for di, d in enumerate(np.asarray(dets, np.float64)):
                    if di >= len(row_masks) or row_masks[di] is None:
                        continue
                    rle = row_masks[di]
                    results.append({
                        "image_id": int(img_id), "category_id": int(cat_id),
                        "segmentation": rle, "area": float(area(rle)),
                        "score": float(d[4]),
                    })
        return results

    def evaluate_sds(self, detections, masks) -> dict:
        """Box and mask scoring of a Mask R-CNN run → ``{"bbox": the 12
        stats, "segm": the 12 stats}``."""
        from mx_rcnn_tpu_torch.eval.coco_eval import COCOEval

        out = {"bbox": self.evaluate_detections(detections)}
        ev = COCOEval(self.ann_file, self.segmentations_to_coco(detections,
                                                                masks),
                      iou_type="segm")
        out["segm"] = ev.evaluate()
        logger.info("COCO segm AP: %.4f (AP50 %.4f AP75 %.4f)",
                    out["segm"]["AP"], out["segm"]["AP50"],
                    out["segm"]["AP75"])
        return out
