"""Post-process: decode → clip → per-class NMS → max_per_image
(counterpart of ``mx_rcnn_tpu/ops/postprocess.py``: ``decode_image_boxes``,
``per_class_nms``, ``device_postprocess``, ``device_dets_to_per_class``,
``detections_to_records``).

The host route runs per image, after the forward's readback, with the
reference ``pred_eval`` accounting: per-class score threshold → NMS (the
C++ ``native.nms``) → global per-image cap that keeps every detection tied
at the cut-off score.
The device route (:func:`device_postprocess`) runs the same steps on the
forward's tensors, where they lie, and keeps exactly ``max_per_image``
rows.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from mx_rcnn_tpu_torch import native
from mx_rcnn_tpu_torch.ops.boxes import bbox_pred, clip_boxes
from mx_rcnn_tpu_torch.ops.nms import nms_ranked

_NEG = -1e10


def decode_image_boxes(rois: np.ndarray, deltas: np.ndarray,
                       im_info_row) -> np.ndarray:
    """One image's (R, 4) rois + (R, 4K) head deltas → (R, 4K) boxes in the
    ORIGINAL image frame (bbox_pred + clip_boxes, then divide by the
    scale).  ``im_info_row`` is the (eh, ew, scale) triple."""
    eh, ew, s = (float(v) for v in np.asarray(im_info_row, np.float32))
    boxes = bbox_pred(torch.from_numpy(np.asarray(rois, np.float32)),
                      torch.from_numpy(np.asarray(deltas, np.float32)))
    boxes = clip_boxes(boxes, eh, ew)
    return boxes.numpy() / np.float32(s)


def per_class_nms(scores: np.ndarray, boxes: np.ndarray, valid,
                  num_classes: int, thresh: float, nms_thresh: float,
                  max_per_image: int,
                  nms_fn=None) -> List[Optional[np.ndarray]]:
    """One image's (R, K) scores + (R, 4K) original-frame boxes →
    per-class (N, 5) [x1,y1,x2,y2,score] detections; index 0 (background)
    is ``None``.  ``nms_fn`` defaults to the C++ ``native.nms``, which
    raises by name when the host library cannot be built; the numpy
    ``ops.nms.nms`` (its oracle, same kept lists) is injectable."""
    if nms_fn is None:
        nms_fn = native.nms
    v = np.asarray(valid, bool)
    dets: List[Optional[np.ndarray]] = [None] * num_classes
    for k in range(1, num_classes):
        sel = (scores[:, k] > thresh) & v
        cls_scores = scores[sel, k]
        cls_boxes = boxes[sel, 4 * k:4 * (k + 1)]
        cls_dets = np.hstack([cls_boxes, cls_scores[:, None]]).astype(
            np.float32)
        keep = nms_fn(cls_dets, nms_thresh)
        dets[k] = cls_dets[keep]
    # cap total detections per image; rows tied at the cut-off all stay
    if max_per_image > 0:
        scores_all = np.concatenate(
            [dets[k][:, 4] for k in range(1, num_classes)])
        if len(scores_all) > max_per_image:
            th = np.sort(scores_all)[-max_per_image]
            for k in range(1, num_classes):
                dets[k] = dets[k][dets[k][:, 4] >= th]
    return dets


def per_class_rows(rois, roi_valid, cls_prob, bbox_deltas, im_info, *,
                   num_classes: int, thresh: float):
    """The per-class NMS input of :func:`device_postprocess`: boxes decoded,
    clipped to the scaled frame and mapped to the original one, as (B, K−1,
    R, 4) boxes, (B, K−1, R) scores and (B, K−1, R) bool selection (score
    above ``thresh`` on a valid RoI), background left out.  float32."""
    b, r = rois.shape[:2]
    k = num_classes
    info = im_info.to(torch.float32)
    boxes = bbox_pred(rois.to(torch.float32), bbox_deltas.to(torch.float32))
    boxes = clip_boxes(boxes, info[:, 0, None, None], info[:, 1, None, None])
    boxes = boxes / info[:, 2, None, None]
    boxes_k = boxes.view(b, r, k, 4).permute(0, 2, 1, 3)[:, 1:]
    scores_k = cls_prob.to(torch.float32).transpose(1, 2)[:, 1:]
    sel_k = (scores_k > thresh) & roi_valid.to(torch.bool)[:, None, :]
    return boxes_k, scores_k, sel_k


def device_postprocess(rois, roi_valid, cls_prob, bbox_deltas, im_info, *,
                       num_classes: int, thresh: float, nms_thresh: float,
                       max_per_image: int, per_class_max: Optional[int] = None,
                       use_kernel: bool = False):
    """Decode, clip, per-class threshold, NMS and cap on the forward's
    tensors — ``pred_eval --device-postprocess``: the host reads back
    ``max_per_image`` final rows per image instead of the (R, K) scores
    and (R, 4K) deltas.

    The B·(K−1) per-class rows of the batch go through one
    :func:`~mx_rcnn_tpu_torch.ops.nms.nms_ranked` call (``use_kernel``:
    one launch of each NMS kernel for the batch), ``per_class_max`` slots
    a row (default ``max_per_image``).  The cap then keeps the top
    ``max_per_image`` rows by a stable descending sort, so equal scores
    keep the lower flat index (class, then rank), as ``lax.top_k`` does;
    the host route keeps every row tied at the cut-off instead.

    Returns ``dets`` (B, cap, 6) float32 [x1,y1,x2,y2,score,cls], score-
    descending with padded rows zeroed, and ``valid`` (B, cap) bool.
    """
    b, r = rois.shape[:2]
    k = num_classes
    pcm = per_class_max or (max_per_image if max_per_image > 0 else r)
    cap = max_per_image if max_per_image > 0 else (k - 1) * pcm
    cap = min(cap, (k - 1) * pcm)
    boxes_k, scores_k, sel_k = per_class_rows(
        rois, roi_valid, cls_prob, bbox_deltas, im_info,
        num_classes=num_classes, thresh=thresh)
    dets_k, mask_k = nms_ranked(boxes_k.reshape(b * (k - 1), r, 4),
                                scores_k.reshape(b * (k - 1), r), pcm,
                                nms_thresh, valid=sel_k.reshape(b * (k - 1), r),
                                use_kernel=use_kernel)
    flat = dets_k.view(b, (k - 1) * pcm, 5)
    fscore = torch.where(mask_k.view(b, -1), flat[..., 4], _NEG)
    top_s, top_i = torch.sort(fscore, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :cap], top_i[:, :cap]
    cls = (top_i // pcm + 1).to(torch.float32)
    out = torch.cat([torch.gather(flat, 1, top_i[..., None].expand(-1, -1, 5)),
                     cls[..., None]], dim=-1)
    dvalid = top_s > _NEG / 2
    return torch.where(dvalid[..., None], out, 0.0), dvalid


def device_dets_to_per_class(dets: np.ndarray, valid,
                             num_classes: int) -> List[Optional[np.ndarray]]:
    """One image's :func:`device_postprocess` readback → the per-class
    ``[None, (N1, 5), ...]`` list :func:`per_class_nms` returns.  Rows
    arrive score-descending, the host NMS's keep order within a class."""
    dets = np.asarray(dets, np.float32)
    rows = dets[np.asarray(valid, bool)]
    out: List[Optional[np.ndarray]] = [None] * num_classes
    for k in range(1, num_classes):
        out[k] = np.ascontiguousarray(rows[rows[:, 5] == k][:, :5],
                                      np.float32)
    return out


def detections_to_records(dets_per_class) -> List[dict]:
    """Per-class (N, 5) arrays → flat JSON-serialisable records sorted by
    descending score."""
    out = []
    for k, d in enumerate(dets_per_class):
        if not k or d is None:
            continue
        for row in d:
            out.append({"cls": int(k), "score": float(row[4]),
                        "bbox": [float(c) for c in row[:4]]})
    out.sort(key=lambda r: -r["score"])
    return out
