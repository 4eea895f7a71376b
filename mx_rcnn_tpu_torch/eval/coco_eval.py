"""COCO box and mask evaluation (counterpart of
``mx_rcnn_tpu/eval/coco_eval.py``; no pycocotools).

The COCOeval protocol in numpy, float64 throughout:

* IoU thresholds 0.50:0.05:0.95, 101 recall points, area ranges
  all/small/medium/large, maxDets (1, 10, 100);
* greedy matching per (image, category), detections in a stable
  score-descending order, each gt claimed once, a crowd gt matchable many
  times with IoU = inter / detection area;
* crowd, ``ignore`` or out-of-range gt do not count as positives, and a
  detection matched to one (or unmatched and out of range itself) is
  neither a true nor a false positive;
* AP = mean interpolated precision over the valid (category, IoU) cells,
  AR = mean of the last recall.

``iou_type="segm"`` matches by mask IoU: each ``segmentation`` (polygons,
count-list or compressed RLE) becomes an RLE over its image
(``eval/mask_rle.py:ann_to_rle``), the IoUs come from the native
run-merge (``native.rle_iou``, which raises when the host library is
unavailable), and a detection's area is its ``area`` field or its mask's.
Headline keys: AP, AP50, AP75, APs, APm, APl, AR1, AR10, AR100, ARs, ARm,
ARl.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List

import numpy as np

from mx_rcnn_tpu_torch.eval.mask_rle import ann_to_rle, area
from mx_rcnn_tpu_torch.native import rle_iou

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                  iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU over xywh boxes with no +1; a crowd gt divides by the
    detection's area (pycocotools' ``bbIou``)."""
    if dt.size == 0 or gt.size == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0:1], dt[:, 1:2]
    dx2, dy2 = dt[:, 0:1] + dt[:, 2:3], dt[:, 1:2] + dt[:, 3:4]
    gx1, gy1 = gt[None, :, 0], gt[None, :, 1]
    gx2, gy2 = gt[None, :, 0] + gt[None, :, 2], gt[None, :, 1] + gt[None, :, 3]
    iw = np.minimum(dx2, gx2) - np.maximum(dx1, gx1)
    ih = np.minimum(dy2, gy2) - np.maximum(dy1, gy1)
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    da = (dt[:, 2:3] * dt[:, 3:4])
    ga = (gt[None, :, 2] * gt[None, :, 3])
    union = np.where(iscrowd[None, :], da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


class COCOEval:
    """Results (COCO results-json records) against an annotation file.
    One-shot: construct, then :meth:`evaluate`, which leaves the whole
    ``precision`` (T, R, K, A, M) and ``recall`` (T, K, A, M) arrays on
    the instance (-1 where a cell has no positives)."""

    def __init__(self, ann_file: str, results: List[dict],
                 iou_type: str = "bbox"):
        if iou_type not in ("bbox", "segm"):
            raise ValueError(iou_type)
        self.iou_type = iou_type
        with open(ann_file) as f:
            ann = json.load(f)
        self.imgs = {im["id"]: im for im in ann["images"]}
        self.img_ids = sorted(self.imgs)
        self.cat_ids = sorted(c["id"] for c in ann["categories"])

        self._gts = defaultdict(list)
        for g in ann["annotations"]:
            if g["image_id"] in self.imgs:
                self._gts[g["image_id"], g["category_id"]].append(g)
        self._dts = defaultdict(list)
        for d in results:
            self._dts[d["image_id"], d["category_id"]].append(d)
        self._cache: dict = {}

    # -- per (image, category) matching --------------------------------------
    def _prepared(self, img_id: int, cat_id: int):
        """Score-sorted detections, gts, their IoU matrix and the
        detections' areas for one (image, category), computed once and
        shared by every (area range, max_det) cell."""
        key = (img_id, cat_id)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        gts = self._gts[key]
        dts = self._dts[key]
        d_order = np.argsort([-d["score"] for d in dts], kind="stable")
        dts = [dts[i] for i in d_order]
        iscrowd = np.asarray([g.get("iscrowd", 0) for g in gts], bool)
        if self.iou_type == "bbox":
            dt = np.asarray([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
            gt = np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
            ious = bbox_iou_xywh(dt, gt, iscrowd)
            d_area = dt[:, 2] * dt[:, 3]
        else:
            im = self.imgs[img_id]
            h, w = im["height"], im["width"]
            dr = [ann_to_rle(d["segmentation"], h, w) for d in dts]
            gr = [ann_to_rle(g["segmentation"], h, w) for g in gts]
            ious = rle_iou(dr, gr, iscrowd)
            d_area = np.asarray([d.get("area") or area(r)
                                 for d, r in zip(dts, dr)], np.float64)
        out = (dts, gts, ious, d_area)
        self._cache[key] = out
        return out

    def _evaluate_img(self, img_id: int, cat_id: int, area_rng, max_det: int):
        dts_all, gts, ious_all, d_area_all = self._prepared(img_id, cat_id)
        if not gts and not dts_all:
            return None
        gt_ignore = np.asarray(
            [g.get("iscrowd", 0) or g.get("ignore", 0)
             or g["area"] < area_rng[0] or g["area"] > area_rng[1]
             for g in gts], bool)
        # gt order: the ones that count first (matching preference)
        g_order = np.argsort(gt_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        gt_ignore = gt_ignore[g_order]
        iscrowd = np.asarray([g.get("iscrowd", 0) for g in gts], bool)

        dts = dts_all[:max_det]
        d_area = d_area_all[:max_det]
        ious = ious_all[:max_det][:, g_order] if len(gts) else ious_all[:max_det]

        T, D, G = len(IOU_THRS), len(dts), len(gts)
        dt_match = np.zeros((T, D), np.int64)
        gt_match = np.zeros((T, G), np.int64)
        dt_ignore = np.zeros((T, D), bool)
        for ti, t in enumerate(IOU_THRS):
            for di in range(D):
                best = min(t, 1 - 1e-10)
                m = -1
                for gi in range(G):
                    if gt_match[ti, gi] > 0 and not iscrowd[gi]:
                        continue
                    # the ignored gt come last: with a real match in hand,
                    # stop where they begin
                    if m > -1 and not gt_ignore[m] and gt_ignore[gi]:
                        break
                    if ious[di, gi] < best:
                        continue
                    best = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_ignore[ti, di] = gt_ignore[m]
                dt_match[ti, di] = 1
                gt_match[ti, m] = di + 1
        # an unmatched detection outside the area range is ignored, not FP
        out_of_rng = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ignore |= (dt_match == 0) & out_of_rng[None, :]
        return {
            "scores": np.asarray([d["score"] for d in dts]),
            "dt_match": dt_match, "dt_ignore": dt_ignore,
            "num_gt": int((~gt_ignore).sum()),
        }

    # -- accumulate + summarize ----------------------------------------------
    def evaluate(self) -> Dict[str, float]:
        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.cat_ids), len(AREA_RNGS), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        area_items = list(AREA_RNGS.items())
        for ki, cat_id in enumerate(self.cat_ids):
            for ai, (_, rng) in enumerate(area_items):
                for mi, max_det in enumerate(MAX_DETS):
                    evs = [self._evaluate_img(i, cat_id, rng, max_det)
                           for i in self.img_ids]
                    evs = [e for e in evs if e is not None]
                    if not evs:
                        continue
                    scores = np.concatenate([e["scores"] for e in evs])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate([e["dt_match"] for e in evs], axis=1)[:, order]
                    dti = np.concatenate([e["dt_ignore"] for e in evs], axis=1)[:, order]
                    npig = sum(e["num_gt"] for e in evs)
                    if npig == 0:
                        continue
                    tps = (dtm == 1) & ~dti
                    fps = (dtm == 0) & ~dti
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                        # the precision envelope (monotone decreasing)
                        q = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q
        self.precision = precision
        self.recall = recall

        def _ap(iou=None, area="all", max_det=100):
            ai = list(AREA_RNGS).index(area)
            mi = MAX_DETS.index(max_det)
            p = precision[:, :, :, ai, mi]
            if iou is not None:
                p = p[[int(round((iou - 0.5) / 0.05))]]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else -1.0

        def _ar(area="all", max_det=100):
            ai = list(AREA_RNGS).index(area)
            mi = MAX_DETS.index(max_det)
            r = recall[:, :, ai, mi]
            r = r[r > -1]
            return float(np.mean(r)) if r.size else -1.0

        return {
            "AP": _ap(), "AP50": _ap(iou=0.5), "AP75": _ap(iou=0.75),
            "APs": _ap(area="small"), "APm": _ap(area="medium"),
            "APl": _ap(area="large"),
            "AR1": _ar(max_det=1), "AR10": _ar(max_det=10),
            "AR100": _ar(max_det=100),
            "ARs": _ar(area="small"), "ARm": _ar(area="medium"),
            "ARl": _ar(area="large"),
        }
