"""RoI sampling and target assignment for the R-CNN head, fixed-size and
batched over images (counterpart of ``mx_rcnn_tpu/ops/sample_rois.py``).

The reference's ``sample_rois`` (rcnn/io/rcnn.py) contract, as the
``ProposalTarget`` op calls it:

1. the caller appends the gt boxes to the proposals;
2. each RoI is matched to its argmax-IoU gt and takes that gt's class;
3. fg candidates have IoU ≥ ``fg_thresh``; at most
   ``round(batch_rois · fg_fraction)`` are sampled;
4. bg candidates have IoU in [``bg_thresh_lo``, ``bg_thresh_hi``) (any
   non-fg valid RoI when there is none) and fill the remaining slots, with
   replacement when too few: the ranked list is cycled, the multiset of
   ``npr.choice(replace=True)``; an image without bg cycles its fg;
5. exactly ``batch_rois`` rows come out: RoIs, labels (0 = background),
   a row weight (0 only when the image had no candidate at all), and the
   class-specific 4K targets normalised by ``bbox_means``/``bbox_stds``.

The uniforms that rank the candidates come from ``generator`` or as
``draws`` (see ``ops/assign_anchor.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from mx_rcnn_tpu_torch.ops.assign_anchor import uniform_draws
from mx_rcnn_tpu_torch.ops.boxes import bbox_overlaps, bbox_transform


def _ranked(mask: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Candidates first, in random order: ``argsort(−r)``, stable like
    ``jnp.argsort``."""
    r = torch.where(mask, r, -1.0)
    return torch.sort(-r, dim=-1, stable=True).indices


def sample_rois(rois: torch.Tensor, roi_valid: torch.Tensor,
                gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                gt_valid: torch.Tensor, *, num_classes: int,
                batch_rois: int = 128, fg_fraction: float = 0.25,
                fg_thresh: float = 0.5, bg_thresh_hi: float = 0.5,
                bg_thresh_lo: float = 0.0,
                bbox_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                bbox_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> dict:
    """Sample ``batch_rois`` RoIs per image.

    Args:
      rois: (B, R, 4) padded proposals, gt already appended; roi_valid:
        (B, R) bool.
      gt_boxes: (B, G, 4); gt_classes: (B, G) int; gt_valid: (B, G) bool.
      draws: the fg and bg ranking uniforms, each (B, R) float32; drawn
        from ``generator`` when None.

    Returns dict with ``rois`` (B, S, 4), ``label`` (B, S) int32,
    ``label_weight`` (B, S) float32, ``bbox_target`` and ``bbox_weight``
    (B, S, 4·num_classes) float32, and for the mask head's targets
    ``gt_index`` (B, S) int64 (each row's matched gt) and ``is_fg`` (B, S)
    bool; S = ``batch_rois``.
    """
    b, r, _ = rois.shape
    dev = rois.device
    fg_rois_cap = int(round(batch_rois * fg_fraction))

    overlaps = bbox_overlaps(rois, gt_boxes)                   # (B, R, G)
    overlaps = torch.where(gt_valid[:, None, :] & roi_valid[:, :, None],
                           overlaps, -1.0)
    max_ov = overlaps.max(dim=2).values
    argmax_gt = torch.argmax(overlaps, dim=2)

    fg_mask = (max_ov >= fg_thresh) & roi_valid
    bg_mask = ((max_ov < bg_thresh_hi) & (max_ov >= bg_thresh_lo) & roi_valid
               & ~fg_mask)
    no_bg = ~bg_mask.any(dim=1, keepdim=True)
    bg_mask = torch.where(no_bg, roi_valid & ~fg_mask, bg_mask)

    r_fg, r_bg = draws if draws is not None else uniform_draws(
        (b, r), dev, generator)
    fg_order = _ranked(fg_mask, r_fg)
    bg_order = _ranked(bg_mask, r_bg)
    fg_count = fg_mask.sum(dim=1, keepdim=True)
    bg_count = bg_mask.sum(dim=1, keepdim=True)

    num_fg = torch.clamp_max(fg_count, fg_rois_cap)
    slots = torch.arange(batch_rois, device=dev)[None, :]
    bg_slot = (slots - num_fg) % torch.clamp_min(bg_count, 1)
    fg_cycle = slots % torch.clamp_min(fg_count, 1)
    take_fg = slots < num_fg
    any_bg = bg_count > 0
    idx = torch.where(
        take_fg,
        torch.gather(fg_order, 1, torch.clamp_max(slots, r - 1).expand(b, -1)),
        torch.where(any_bg, torch.gather(bg_order, 1, bg_slot),
                    torch.gather(fg_order, 1, fg_cycle)))
    is_fg = take_fg | (~any_bg & (fg_count > 0))

    sampled_rois = torch.gather(rois, 1, idx[..., None].expand(-1, -1, 4))
    gt_idx = torch.gather(argmax_gt, 1, idx)
    label = torch.where(is_fg, torch.gather(gt_classes, 1, gt_idx),
                        0).to(torch.int32)
    degenerate = (fg_count + bg_count) == 0
    label_weight = torch.where(degenerate, 0.0, 1.0).expand(
        b, batch_rois).to(torch.float32)

    matched = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    means = torch.as_tensor(bbox_means, dtype=torch.float32, device=dev)
    stds = torch.as_tensor(bbox_stds, dtype=torch.float32, device=dev)
    raw = (bbox_transform(sampled_rois, matched) - means) / stds
    # class-specific 4K layout (expand_bbox_regression_targets): the 4
    # columns of the label's class
    col = label.long()[..., None] * 4 + torch.arange(4, device=dev)
    k4 = 4 * num_classes
    bbox_target = torch.zeros((b, batch_rois, k4), dtype=torch.float32,
                              device=dev).scatter(2, col, raw)
    fg_w = (is_fg & (label > 0)).to(torch.float32)[..., None].expand(-1, -1, 4)
    bbox_weight = torch.zeros_like(bbox_target).scatter(2, col, fg_w)
    return {"rois": sampled_rois, "label": label,
            "label_weight": label_weight,
            "bbox_target": bbox_target * bbox_weight,
            "bbox_weight": bbox_weight, "gt_index": gt_idx, "is_fg": is_fg}
