"""PASCAL VOC AP (counterpart of ``mx_rcnn_tpu/eval/voc_eval.py``; reference
``rcnn/dataset/pascal_voc_eval.py``).

Numpy: the VOC07 11-point interpolated AP and the area under the monotone
PR curve, difficult objects excluded, greedy one-detection-per-gt matching
as in the official devkit.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """AP from the recall and precision curves."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = float(np.max(prec[rec >= t])) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    # the envelope, then the area under the PR curve
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval(class_dets: List[np.ndarray], recs: Dict[int, list], classname: str,
             ovthresh: float = 0.5, use_07_metric: bool = False) -> float:
    """AP of one class.

    Args:
      class_dets: per-image (N, 5) [x1,y1,x2,y2,score] arrays (index =
        image id), the ``all_boxes[cls]`` layout.
      recs: image id → parsed annotation objects ({'name', 'difficult',
        'bbox'}).
      classname: the class name.

    Detections are taken by descending score; one is a true positive when
    its best IoU against this class's gt of its image is ≥ ``ovthresh``
    and that gt is neither difficult nor claimed already; difficult gt
    count neither as a miss nor toward the positives.
    """
    class_recs = {}
    npos = 0
    for img_id, objects in recs.items():
        objs = [o for o in objects if o["name"] == classname]
        bbox = np.array([o["bbox"] for o in objs], np.float32).reshape(-1, 4)
        difficult = np.array([o["difficult"] for o in objs], bool)
        npos += int((~difficult).sum())
        class_recs[img_id] = {"bbox": bbox, "difficult": difficult,
                              "det": np.zeros(len(objs), bool)}

    image_ids, confidence, boxes = [], [], []
    for img_id, dets in enumerate(class_dets):
        if dets is None or len(dets) == 0:
            continue
        for d in dets:
            image_ids.append(img_id)
            confidence.append(d[4])
            boxes.append(d[:4])
    if not image_ids:
        return 0.0
    confidence = np.asarray(confidence, np.float32)
    boxes = np.asarray(boxes, np.float32)
    order = np.argsort(-confidence)
    image_ids = [image_ids[i] for i in order]
    boxes = boxes[order]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        rec_ = class_recs.get(image_ids[d])
        if rec_ is None:
            fp[d] = 1.0
            continue
        bb = boxes[d]
        ovmax, jmax = -np.inf, -1
        gt = rec_["bbox"]
        if gt.size:
            ixmin = np.maximum(gt[:, 0], bb[0])
            iymin = np.maximum(gt[:, 1], bb[1])
            ixmax = np.minimum(gt[:, 2], bb[2])
            iymax = np.minimum(gt[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inter = iw * ih
            union = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                     + (gt[:, 2] - gt[:, 0] + 1.0) * (gt[:, 3] - gt[:, 1] + 1.0)
                     - inter)
            overlaps = inter / np.maximum(union, 1e-12)
            jmax = int(np.argmax(overlaps))
            ovmax = float(overlaps[jmax])
        if ovmax >= ovthresh:
            if not rec_["difficult"][jmax]:
                if not rec_["det"][jmax]:
                    tp[d] = 1.0
                    rec_["det"][jmax] = True
                else:
                    fp[d] = 1.0  # a second detection of a claimed gt
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / max(float(npos), 1.0)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return voc_ap(rec, prec, use_07_metric)
