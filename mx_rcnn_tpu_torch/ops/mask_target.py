"""Mask-head training targets on the device (counterpart of
``mx_rcnn_tpu/ops/mask_target.py``).

The contract (Mask R-CNN §3): each sampled fg RoI's target is its matched
gt instance mask cropped to the RoI and resampled to ``MASK_SIZE``², values
{0, 1}.  The loader rasterises every gt mask once into a fixed (S, S) crop
aligned to its gt box (``data/mask.py``, ``gt_masks``); here each RoI's
``out × out`` pixel centres are mapped into that gt-box frame and sampled
bilinearly, then thresholded at 0.5.

The sampler is separable, as in the JAX package: RoI r's resample is
``Wy[r] @ mask[r] @ Wx[r]ᵀ`` with (out, S) one-axis interpolation
matrices, two batched matmuls in float32 with TF32 off.  The per-pixel
four-gather sampler (:func:`_sample_gather`) stays beside it as its
oracle.  Plain PyTorch, no kernel: the JAX package computes this outside
any Pallas kernel.
"""

from __future__ import annotations

import torch

from mx_rcnn_tpu_torch.ops.mask_paste import no_tf32


def _gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[b, index[b, r]]`` for x (B, G, …) and index (B, R) → (B, R, …)."""
    idx = index.to(torch.int64).reshape(index.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(index.shape + x.shape[2:]))


def _frame_coords(gt_boxes, rois, gt_index, s: int, out_size: int):
    """The RoI pixel centres mapped into their matched gt box's (S, S)
    frame: (my, mx), each (B, R, out)."""
    box = _gather_rows(gt_boxes.to(torch.float32), gt_index)     # (B, R, 4)
    rois = rois.to(torch.float32)
    bw = torch.clamp_min(box[..., 2] - box[..., 0], 1e-3)
    bh = torch.clamp_min(box[..., 3] - box[..., 1], 1e-3)
    grid = (torch.arange(out_size, dtype=torch.float32, device=rois.device)
            + 0.5) / out_size
    gy = rois[..., 1:2] + grid * (rois[..., 3:4] - rois[..., 1:2])
    gx = rois[..., 0:1] + grid * (rois[..., 2:3] - rois[..., 0:1])
    my = (gy - box[..., 1:2]) / bh[..., None] * s - 0.5
    mx = (gx - box[..., 0:1]) / bw[..., None] * s - 0.5
    return my, mx


def mask_targets_for_rois(gt_masks: torch.Tensor, gt_boxes: torch.Tensor,
                          rois: torch.Tensor, gt_index: torch.Tensor, *,
                          out_size: int = 28) -> torch.Tensor:
    """(B, G, S, S) gt-box-frame masks → (B, R, out, out) float32 targets.

    Args:
      gt_masks: (B, G, S, S), float or ``uint8`` {0, 1}: gt g's mask in its
        own box frame (cast to float32 here).
      gt_boxes: (B, G, 4) those frames (scaled image coordinates).
      rois: (B, R, 4) the sampled RoIs (scaled image coordinates).
      gt_index: (B, R) each RoI's matched gt.
    """
    s = gt_masks.shape[-1]
    my, mx = _frame_coords(gt_boxes, rois, gt_index, s, out_size)
    masks = _gather_rows(gt_masks, gt_index).to(torch.float32)  # (B, R, S, S)
    wy = _lerp_weights(my, s)                                  # (B, R, out, S)
    wx = _lerp_weights(mx, s)
    with no_tf32():
        out = wy @ masks @ wx.transpose(-1, -2)                 # (B, R, out, out)
    return (out >= 0.5).to(torch.float32)


def _lerp_weights(t: torch.Tensor, s: int) -> torch.Tensor:
    """One-axis linear-interpolation matrix (…, out, S) of coordinates
    ``t`` (…, out), with :func:`_sample_gather`'s edge semantics: weight
    ``1 − frac`` on ``clip(floor(t))`` and ``frac`` on ``clip(floor(t) +
    1)`` (at the top edge both clip to S − 1 and the weights sum to 1), and
    all-zero rows for points outside (t ≤ −1 or t ≥ S)."""
    cells = torch.arange(s, dtype=torch.float32, device=t.device)
    inside = (t > -1.0) & (t < s)
    t0 = torch.clamp(torch.floor(t), 0, s - 1)
    t1 = torch.clamp(t0 + 1, 0, s - 1)
    frac = torch.clamp(t - t0, 0.0, 1.0)
    w = ((1.0 - frac)[..., None] * (cells == t0[..., None])
         + frac[..., None] * (cells == t1[..., None]))
    return torch.where(inside[..., None], w, 0.0)


def _sample_gather(masks: torch.Tensor, my: torch.Tensor, mx: torch.Tensor,
                   out_size: int, s: int) -> torch.Tensor:
    """The per-pixel four-gather bilinear sampler, the separable form's
    oracle: masks (R, S, S), my/mx (R, out) → (R, out, out), unthresholded."""
    yy = my[:, :, None].expand(-1, out_size, out_size)
    xx = mx[:, None, :].expand(-1, out_size, out_size)
    inside = (yy > -1.0) & (yy < s) & (xx > -1.0) & (xx < s)
    y0 = torch.clamp(torch.floor(yy), 0, s - 1)
    x0 = torch.clamp(torch.floor(xx), 0, s - 1)
    y1 = torch.clamp(y0 + 1, 0, s - 1)
    x1 = torch.clamp(x0 + 1, 0, s - 1)
    ly = torch.clamp(yy - y0, 0.0, 1.0)
    lx = torch.clamp(xx - x0, 0.0, 1.0)
    flat = masks.to(torch.float32).reshape(masks.shape[0], -1)

    def at(y, x):
        return torch.gather(flat, 1, (y.long() * s + x.long()).reshape(
            masks.shape[0], -1)).reshape(y.shape)

    v = ((1 - ly) * (1 - lx) * at(y0, x0) + (1 - ly) * lx * at(y0, x1)
         + ly * (1 - lx) * at(y1, x0) + ly * lx * at(y1, x1))
    return torch.where(inside, v, 0.0)
