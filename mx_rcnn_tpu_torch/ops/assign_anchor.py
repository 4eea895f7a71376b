"""RPN anchor target assignment, fixed-size and masked, batched over images
(counterpart of ``mx_rcnn_tpu/ops/assign_anchor.py``).

The reference's ``assign_anchor`` (rcnn/io/rpn.py) contract:

1. only anchors fully inside the image (± ``allowed_border``) take part;
2. labels: 1 (fg) if the max IoU with some gt is ≥ ``pos_overlap`` **or**
   the anchor attains some gt's max IoU over inside anchors (ties
   included); 0 (bg) if the max IoU is < ``neg_overlap``; −1 (ignore)
   otherwise and for outside anchors; an image without gt is all bg;
3. subsample: at most ``fg_fraction · batch_size`` fg and
   ``batch_size − num_fg`` bg survive, chosen uniformly;
4. bbox targets = encode(anchor → its argmax gt), weight 1 on kept fg.

The IoU reductions go through the fused kernel's wrapper
(``kernels/assign_cuda.py``) when ``fused`` is set (``cfg.tpu.ASSIGN_FUSED``):
the kernel on a CUDA tensor, its plain version on a CPU one.  It takes at
most 128 gt per image and raises beyond, and it computes no bfloat16 IoU,
so ``fused`` with ``iou_bf16`` raises too: neither falls back to the dense
path, which runs only when ``fused`` is unset.  The subsampling draws its
uniforms from ``generator``, or
takes them as ``draws`` — the JAX package draws with ``jax.random``, whose
stream torch cannot reproduce, so parity tests feed its draws in.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mx_rcnn_tpu_torch.kernels.assign_cuda import (assign_reduce,
                                                   assign_reduce_plain)
from mx_rcnn_tpu_torch.ops.boxes import bbox_transform

Draws = Tuple[torch.Tensor, torch.Tensor]


def uniform_draws(shape, device,
                  generator: Optional[torch.Generator]) -> Draws:
    """The (fg, bg) float32 uniforms in [0, 1) of ``shape``."""
    return tuple(torch.rand(shape, generator=generator, device=device)
                 for _ in range(2))


def _keep_topk_random(mask: torch.Tensor, k: torch.Tensor, r: torch.Tensor,
                      k_cap: int) -> torch.Tensor:
    """Keep at most ``k`` (B,) True entries of each row of ``mask`` (B, N):
    those with the highest uniform priority ``r``.  A stable descending
    sort keeps ``lax.top_k``'s rule that ties go to the lower index, so
    the ≤ k contract is exact."""
    k_cap = min(k_cap, mask.shape[-1])
    r = torch.where(mask, r, -1.0)
    idx = torch.sort(r, dim=-1, descending=True, stable=True).indices[:, :k_cap]
    sel = torch.arange(k_cap, device=mask.device)[None, :] < k[:, None]
    keep = torch.zeros_like(mask).scatter(1, idx, sel)
    return keep & mask


def assign_anchor(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, im_info: torch.Tensor, *,
                  batch_size: int = 256, fg_fraction: float = 0.5,
                  pos_overlap: float = 0.7, neg_overlap: float = 0.3,
                  allowed_border: int = 0, clobber_positives: bool = False,
                  iou_bf16: bool = False, fused: bool = False,
                  draws: Optional[Draws] = None,
                  generator: Optional[torch.Generator] = None) -> dict:
    """RPN labels and targets for a batch.

    Args:
      anchors: (N, 4) all anchors of the feature shape, shared by the batch.
      gt_boxes: (B, G, 4) padded gt boxes; gt_valid: (B, G) bool.
      im_info: (B, ≥2) float32 rows starting (effective h, effective w).
      draws: the fg and bg subsampling uniforms, each (B, N) float32;
        drawn from ``generator`` when None.

    Returns dict with ``label`` (B, N) int32 ∈ {−1, 0, 1}, ``bbox_target``
    (B, N, 4) float32 and ``bbox_weight`` (B, N, 1) float32 (1 on kept
    fg; it broadcasts over the 4 deltas, as in the JAX package).
    """
    b, n = gt_boxes.shape[0], anchors.shape[0]
    num_fg_cap = int(batch_size * fg_fraction)
    im_h = im_info[:, 0:1].to(torch.float32)
    im_w = im_info[:, 1:2].to(torch.float32)
    inside = ((anchors[None, :, 0] >= -allowed_border)
              & (anchors[None, :, 1] >= -allowed_border)
              & (anchors[None, :, 2] < im_w + allowed_border)
              & (anchors[None, :, 3] < im_h + allowed_border))   # (B, N)
    any_gt = gt_valid.any(dim=1, keepdim=True)

    if fused and iou_bf16:
        raise ValueError("the fused assign kernel computes float32 IoU: "
                         "tpu.ASSIGN_FUSED does not combine with "
                         "TRAIN.RPN_ASSIGN_IOU_BF16")
    if fused:
        max_overlap, argmax_gt, _, is_gt_argmax = assign_reduce(
            anchors, gt_boxes, gt_valid, inside)
    else:
        max_overlap, argmax_gt, _, is_gt_argmax = assign_reduce_plain(
            anchors, gt_boxes, gt_valid, inside,
            torch.bfloat16 if iou_bf16 else torch.float32)

    # bfloat16 overlaps meet the thresholds in bfloat16, as JAX's weakly
    # typed Python floats do
    fg = (max_overlap >= pos_overlap) | is_gt_argmax
    bg = max_overlap < neg_overlap
    if clobber_positives:
        fg = fg & ~bg
    else:
        bg = bg & ~fg
    fg = fg & any_gt & inside
    bg = torch.where(any_gt, bg, True) & inside

    r_fg, r_bg = draws if draws is not None else uniform_draws(
        (b, n), anchors.device, generator)
    fg_kept = _keep_topk_random(
        fg, torch.full((b,), num_fg_cap, device=fg.device), r_fg, num_fg_cap)
    num_fg = fg_kept.sum(dim=1)
    bg_kept = _keep_topk_random(bg, batch_size - num_fg, r_bg, batch_size)

    label = torch.full((b, n), -1, dtype=torch.int32, device=anchors.device)
    label = torch.where(bg_kept, 0, label)
    label = torch.where(fg_kept, 1, label).to(torch.int32)

    matched = torch.gather(gt_boxes.to(torch.float32), 1,
                           argmax_gt[..., None].expand(-1, -1, 4))
    bbox_target = bbox_transform(anchors, matched)
    bbox_target = torch.where(any_gt[..., None], bbox_target, 0.0)
    bbox_weight = fg_kept[..., None].to(torch.float32)
    return {"label": label, "bbox_target": bbox_target * bbox_weight,
            "bbox_weight": bbox_weight}
