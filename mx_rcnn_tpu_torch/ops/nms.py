"""Non-maximum suppression (counterpart of ``mx_rcnn_tpu/ops/nms.py``).

* ``nms_padded`` — exact greedy NMS with a static output size, a loop over
  output slots: each step takes the first maximum of the live scores,
  emits it and suppresses its IoU neighbourhood in one vectorised pass.
  ``nms_padded_batch`` runs it over each image of a batch: the plain
  version of the CUDA bitmask kernel (``kernels/nms_cuda.py``), which
  serves CPU tensors with it.
* ``nms`` — host numpy greedy NMS over ``(N, 5)`` rows, the per-class NMS
  of the eval post-process.

A box is suppressed when IoU > thresh (strict) w.r.t. a kept box, with
legacy "+1" areas, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from mx_rcnn_tpu_torch.ops.boxes import bbox_overlaps

_NEG = -1e10


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
               iou_thresh: float, valid: torch.Tensor | None = None):
    """Exact greedy NMS over one image.

    Args:
      boxes: (N, 4) float32.
      scores: (N,) float.
      max_out: number of output slots.
      iou_thresh: suppress when IoU > thresh (compared in float32).
      valid: optional (N,) bool; False rows are never selected.

    Returns ``keep_idx`` (max_out,) int32 — indices in selection order
    (score-descending; the first maximum wins a tie, as ``jnp.argmax``),
    padded slots 0 — and ``keep_mask`` (max_out,) bool.
    """
    n = boxes.shape[0]
    dev = boxes.device
    if n == 0 or max_out == 0:
        return (torch.zeros(max_out, dtype=torch.int32, device=dev),
                torch.zeros(max_out, dtype=torch.bool, device=dev))
    thresh = float(np.float32(iou_thresh))
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    live = scores.to(torch.float32)
    if valid is not None:
        live = torch.where(valid, live, neg)
    idx, oks = [], []
    for _ in range(max_out):
        # index tensors, not Python ints: no device sync per step
        i = torch.argmax(live).view(1)
        ok = live.index_select(0, i) > _NEG / 2
        iou = bbox_overlaps(boxes.index_select(0, i), boxes)[0]
        live = torch.where((iou > thresh) & ok, neg, live)
        # also retire the selected box itself when iou_thresh >= 1
        live = live.index_put((i,), torch.where(ok, neg, live.index_select(0, i)))
        idx.append(torch.where(ok, i, 0))
        oks.append(ok)
    return torch.cat(idx).to(torch.int32), torch.cat(oks)


def nms_padded_batch(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
                     iou_thresh: float, valid: torch.Tensor):
    """:func:`nms_padded` over each image of a batch: (B, N, 4) boxes, (B, N)
    scores and valid → ``keep_idx`` (B, max_out) int32, ``keep_mask``
    (B, max_out) bool."""
    if boxes.shape[0] == 0:
        return (torch.zeros((0, max_out), dtype=torch.int32, device=boxes.device),
                torch.zeros((0, max_out), dtype=torch.bool, device=boxes.device))
    outs = [nms_padded(boxes[b], scores[b], max_out, iou_thresh, valid=valid[b])
            for b in range(boxes.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def nms(dets: np.ndarray, thresh: float) -> list:
    """Host numpy greedy NMS over (N, 5) [x1,y1,x2,y2,score] rows → kept
    row indices, score-descending, equal scores in row order (the stable
    sort of the reference's native NMS)."""
    if dets.size == 0:
        return []
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        inds = np.where(ovr <= thresh)[0]
        order = order[inds + 1]
    return keep
