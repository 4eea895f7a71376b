"""Non-maximum suppression (counterpart of ``mx_rcnn_tpu/ops/nms.py``).

* ``nms_padded`` — exact greedy NMS with a static output size, a loop over
  output slots: each step takes the first maximum of the live scores,
  emits it and suppresses its IoU neighbourhood in one vectorised pass.
  ``nms_padded_batch`` runs it over each image of a batch: the plain
  version of the CUDA bitmask kernel (``kernels/nms_cuda.py``), which
  serves CPU tensors with it.
* ``nms_ranked`` — greedy NMS over rows of UNSORTED candidates → score-
  ranked padded detections: the per-class NMS of the device post-process,
  every row of a batch in one call (one launch of each NMS kernel).
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


def rank_rows(boxes: torch.Tensor, scores: torch.Tensor,
              valid: torch.Tensor | None = None):
    """Rows of candidates sorted by descending score, the NMS input of
    :func:`nms_ranked`: (R, N, 4) boxes, (R, N) scores and valid →
    ``(boxes (R, N, 4) float32 contiguous, scores (R, N) float32, valid
    (R, N) bool)``.  Invalid candidates score ``-1e10`` and sink below
    every real one; equal scores keep their index order (a stable sort, as
    ``jnp.argsort(-s)``)."""
    s = scores.to(torch.float32)
    if valid is not None:
        s = torch.where(valid, s, _NEG)
    ss, order = torch.sort(s, dim=1, descending=True, stable=True)
    bs = torch.gather(boxes.to(torch.float32), 1,
                      order[..., None].expand(-1, -1, 4)).contiguous()
    return bs, ss, ss > _NEG / 2


def nms_ranked(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
               iou_thresh: float, valid: torch.Tensor | None = None,
               use_kernel: bool = False):
    """Greedy NMS over rows of unsorted candidates → score-ranked padded
    detections (counterpart of ``mx_rcnn_tpu/ops/nms.py:nms_ranked``, with
    the rows as a leading batch dimension).

    Args:
      boxes: (R, N, 4); scores: (R, N); valid: optional (R, N) bool.
      max_out: kept slots per row.
      use_kernel: the CUDA bitmask kernels (``kernels/nms_cuda.py:
        nms_bitmask``, one launch of each for all R rows, the plain version
        on CPU tensors); else :func:`nms_padded_batch`.

    Returns ``dets`` (R, max_out, 5) float32 [x1,y1,x2,y2,score], each row
    score-descending with padded slots zeroed, and ``keep_mask`` (R,
    max_out) bool.
    """
    bs, ss, sv = rank_rows(boxes, scores, valid)
    if use_kernel:
        from mx_rcnn_tpu_torch.kernels.nms_cuda import nms_bitmask

        keep_idx, keep_mask = nms_bitmask(bs, sv, max_out, iou_thresh)
    else:
        keep_idx, keep_mask = nms_padded_batch(bs, ss, max_out, iou_thresh,
                                               sv)
    k = keep_idx.long()
    dets = torch.cat([torch.gather(bs, 1, k[..., None].expand(-1, -1, 4)),
                      torch.gather(ss, 1, k)[..., None]], dim=-1)
    return torch.where(keep_mask[..., None], dets, 0.0), keep_mask


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
