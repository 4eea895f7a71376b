"""Detection losses (counterpart of ``mx_rcnn_tpu/models/losses.py``).

Explicit-mask equivalents of the reference's MXNet loss ops:

* RPN cls:  ``SoftmaxOutput(use_ignore=True, ignore_label=-1,
  normalization='valid')`` → :func:`softmax_ce_ignore`;
* RPN bbox: ``smooth_l1(sigma=3)`` / RPN_BATCH_SIZE → :func:`smooth_l1`;
* RCNN cls: ``SoftmaxOutput(normalization='batch')`` →
  :func:`softmax_ce_weighted`;
* RCNN bbox: ``smooth_l1(sigma=1)`` / BATCH_ROIS → :func:`smooth_l1`;
* Mask R-CNN: per-pixel sigmoid BCE over the fg RoIs → :func:`mask_bce`.

Every reduction runs in float32 whatever the compute dtype.  ``fg_prob``
is the RPN objectness the proposal op reads.
"""

from __future__ import annotations

import torch


def softmax_ce_ignore(logits: torch.Tensor, label: torch.Tensor,
                      ignore_label: int = -1) -> torch.Tensor:
    """Cross-entropy with ignored labels, ``normalization='valid'``:
    logits (..., K), label (...) int; entries equal to ``ignore_label``
    leave both the sum and the count.  Returns a scalar."""
    logits = logits.to(torch.float32)
    valid = label != ignore_label
    ce = _ce_rows(logits, torch.where(valid, label, 0))
    num = torch.where(valid, ce, 0.0).sum()
    den = torch.clamp_min(valid.to(torch.float32).sum(), 1.0)
    return num / den


def _ce_rows(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Per-row cross-entropy ``−logp[label]``.  K == 2 uses the binary
    logit-difference form, ``softplus(∓z)`` with z = l1 − l0, written as
    ``logaddexp(x, 0)`` like ``jax.nn.softplus`` (``F.softplus`` switches
    to the identity above 20 and would differ)."""
    k = logits.shape[-1]
    if k == 2:
        z = logits[..., 1] - logits[..., 0]
        zero = torch.zeros((), dtype=z.dtype, device=z.device)
        return torch.where(label == 1, torch.logaddexp(-z, zero),
                           torch.logaddexp(z, zero))
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, label.long()[..., None])[..., 0]


def softmax_ce_weighted(logits: torch.Tensor, label: torch.Tensor,
                        weight: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over the static row count (``normalization='batch'``),
    each row scaled by ``weight`` (0 drops degenerate rows)."""
    ce = _ce_rows(logits.to(torch.float32), label)
    return (ce * weight).sum() / float(weight.numel())


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, weight: torch.Tensor,
              sigma: float, norm: float) -> torch.Tensor:
    """Masked smooth-L1 summed and divided by ``norm``: with
    x = weight · (pred − target), ``0.5·(σx)²`` where |x| < 1/σ², else
    ``|x| − 0.5/σ²`` — MXNet's ``smooth_l1(scalar=σ)`` + ``MakeLoss(
    grad_scale=1/norm)``."""
    x = weight * (pred.to(torch.float32) - target.to(torch.float32))
    s2 = sigma * sigma
    ax = torch.abs(x)
    val = torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)
    return val.sum() / norm


def mask_bce(logits: torch.Tensor, target: torch.Tensor,
             weight: torch.Tensor) -> torch.Tensor:
    """Per-pixel sigmoid BCE of the mask head in float32, averaged over the
    pixels of the weighted RoIs: logits and target (…, R, M, M), weight
    (…, R) (1 on fg RoIs); the denominator ``sum(weight)`` is clamped at 1.
    Reduces over R only, so that a batch (B, R, …) gives each image's loss
    (the JAX package's ``vmap(mask_bce)``)."""
    logits = logits.to(torch.float32)
    per_pix = (torch.clamp_min(logits, 0) - logits * target
               + torch.log1p(torch.exp(-torch.abs(logits))))
    per_roi = per_pix.mean(dim=(-1, -2))
    return ((per_roi * weight).sum(dim=-1)
            / torch.clamp_min(weight.sum(dim=-1), 1.0))


def fg_prob(cls_logits: torch.Tensor) -> torch.Tensor:
    """``softmax(logits, -1)[..., 1]`` of the K=2 RPN objectness head,
    computed as ``sigmoid(l1 − l0)`` in float32."""
    logits = cls_logits.to(torch.float32)
    return torch.sigmoid(logits[..., 1] - logits[..., 0])
