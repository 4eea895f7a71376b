"""Proposal generation (RPN output → RoIs), counterpart of
``mx_rcnn_tpu/ops/proposal.py:propose`` and ``propose_fpn`` with the batch
written out.

Per image: decode the per-anchor deltas (``bbox_pred``), clip to the
image, drop boxes smaller than ``min_size · im_scale`` on either side,
keep the top ``pre_nms_top_n`` by fg score, greedy NMS, keep the top
``post_nms_top_n``.  The output has a static size: padded slots hold the
box of kept index 0 and the mask tells the truth (the duplicate-pad
contract of the JAX package).

FPN (:func:`propose_fpn`): the same per level, each level cut to
``pre_nms_top_n // levels``, then the levels' candidates concatenated,
sorted jointly by score and put through ONE NMS.  The JAX package's
two-stage ``_level_topk`` picks the same elements in the same order as a
stable descending sort (lax.top_k puts the lower index first among equal
scores, so the union of the rows' top-k, cut again, is the global top-k
in (score, index) order); the port sorts once.

The NMS is the CUDA bitmask kernel (``kernels/nms_cuda.py:nms_bitmask``),
one launch of each of its two kernels for the whole batch, when
``use_kernel`` (``cfg.*.CXX_PROPOSAL``) is set; else
``ops.nms.nms_padded_batch``.
"""

from __future__ import annotations

import torch

from mx_rcnn_tpu_torch.kernels.nms_cuda import nms_bitmask
from mx_rcnn_tpu_torch.ops.boxes import bbox_pred, clip_boxes
from mx_rcnn_tpu_torch.ops.nms import nms_padded_batch


def proposal_candidates(scores: torch.Tensor, bbox_deltas: torch.Tensor,
                        anchors: torch.Tensor, im_info: torch.Tensor, *,
                        pre_nms_top_n: int = 6000, min_size: int = 16):
    """The NMS input of :func:`propose`: decoded, clipped, size-filtered
    boxes, score-sorted and cut to ``pre_nms_top_n``.

    Returns ``top_boxes`` (B, k, 4) float32 (contiguous), ``top_scores``
    (B, k) and ``top_valid`` (B, k) bool, with k = min(pre_nms_top_n, N).
    """
    n = scores.shape[1]
    im_h, im_w, im_scale = (im_info[:, i].reshape(-1, 1) for i in range(3))
    boxes = bbox_pred(anchors, bbox_deltas)                  # (B, N, 4)
    boxes = clip_boxes(boxes, im_h[..., None], im_w[..., None])

    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    ms = min_size * im_scale
    scores = torch.where((ws >= ms) & (hs >= ms), scores, -1.0)

    # stable descending sort: exact ties keep the lower anchor index first,
    # like jax.lax.top_k
    k = min(pre_nms_top_n, n)
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    return top_boxes.contiguous(), top_scores, top_scores > -0.5


def propose(scores: torch.Tensor, bbox_deltas: torch.Tensor,
            anchors: torch.Tensor, im_info: torch.Tensor, *,
            pre_nms_top_n: int = 6000, post_nms_top_n: int = 300,
            nms_thresh: float = 0.7, min_size: int = 16,
            use_kernel: bool = True):
    """Generate proposals for a batch of images.

    Args:
      scores: (B, N) per-anchor foreground probability.
      bbox_deltas: (B, N, 4) per-anchor regression output.
      anchors: (N, 4) anchors of this feature shape.
      im_info: (B, 3) float32 rows (effective h, effective w, scale).

    Returns:
      rois: (B, post_nms_top_n, 4) float32, duplicate-padded.
      roi_scores: (B, post_nms_top_n) float32, 0 in padded slots.
      roi_valid: (B, post_nms_top_n) bool.
    """
    top_boxes, top_scores, top_valid = proposal_candidates(
        scores, bbox_deltas, anchors, im_info, pre_nms_top_n=pre_nms_top_n,
        min_size=min_size)
    return _nms_gather(top_boxes, top_scores, top_valid, post_nms_top_n,
                       nms_thresh, use_kernel)


def fpn_candidates(level_scores, level_deltas, level_anchors,
                   im_info: torch.Tensor, *, pre_nms_top_n: int = 12000,
                   min_size: int = 16):
    """The joint NMS input of :func:`propose_fpn`: each level's
    :func:`proposal_candidates` at ``max(pre_nms_top_n // levels, 1)``,
    concatenated in level order and stably sorted by score, descending →
    ``(boxes (B, k, 4) contiguous, scores (B, k), valid (B, k))``."""
    k_level = max(pre_nms_top_n // len(level_scores), 1)
    parts = [proposal_candidates(s, d, a, im_info, pre_nms_top_n=k_level,
                                 min_size=min_size)
             for s, d, a in zip(level_scores, level_deltas, level_anchors,
                                strict=True)]
    boxes = torch.cat([p[0] for p in parts], dim=1)
    scores = torch.cat([p[1] for p in parts], dim=1)
    # the levels are each sorted, not across: the NMS needs the joint
    # score order (jnp.argsort(-scores) is stable: equal scores keep their
    # level order)
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return boxes.contiguous(), scores, scores > -0.5


def propose_fpn(level_scores, level_deltas, level_anchors,
                im_info: torch.Tensor, *, pre_nms_top_n: int = 12000,
                post_nms_top_n: int = 2000, nms_thresh: float = 0.7,
                min_size: int = 16, use_kernel: bool = True):
    """Multi-level proposals for a batch: lists over pyramid levels of
    scores (B, N_l), deltas (B, N_l, 4) and anchors (N_l, 4) →
    :func:`propose`'s outputs, from one joint NMS over
    :func:`fpn_candidates` (at 800×1344 and the TEST config: 4 × 1200 +
    819 = 5 619 candidates, P6 having fewer anchors than its cut)."""
    boxes, scores, valid = fpn_candidates(
        level_scores, level_deltas, level_anchors, im_info,
        pre_nms_top_n=pre_nms_top_n, min_size=min_size)
    return _nms_gather(boxes, scores, valid, post_nms_top_n, nms_thresh,
                       use_kernel)


def _nms_gather(top_boxes, top_scores, top_valid, post_nms_top_n: int,
                nms_thresh: float, use_kernel: bool):
    """Greedy NMS over score-sorted candidates → ``(rois, roi_scores,
    roi_valid)`` at ``post_nms_top_n`` rows, duplicate-padded."""
    if use_kernel:
        keep_idx, keep_mask = nms_bitmask(top_boxes, top_valid,
                                          post_nms_top_n, nms_thresh)
    else:
        keep_idx, keep_mask = nms_padded_batch(top_boxes, top_scores,
                                               post_nms_top_n, nms_thresh,
                                               top_valid)

    keep_idx = keep_idx.long()
    rois = torch.gather(top_boxes, 1, keep_idx[..., None].expand(-1, -1, 4))
    roi_scores = torch.where(keep_mask, torch.gather(top_scores, 1, keep_idx),
                             0.0)
    return rois, roi_scores, keep_mask
