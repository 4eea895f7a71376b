"""Bitmask NMS on the card: wrappers of ``csrc/nms_bitmask.cu``.

The CUDA counterpart of ``mx_rcnn_tpu/kernels/nms_pallas.py``.  Two
kernels, each behind its own wrapper with its own launch count:

* :func:`nms_mask` — phase A (``_suppress_kernel``): the upper-triangle
  suppression bitmask of score-sorted boxes, 64-bit words.  Only the
  triangle is launched, one 128-thread block per strip of four 64×64
  tiles, two rows a thread; the IoU test is decided by the exact signs of
  two FMAs and takes the true division only within 2^-20 of the
  threshold;
* :func:`nms_sweep` — phase B (``_sweep_kernel`` + ``_nms_post``): the
  greedy sweep, writing ``(keep_idx, keep_mask)`` directly.  One block of
  256 threads per image walks the 64-row blocks in order, as
  ``_sweep_kernel`` walks its 8-row ones: one warp resolves each block
  serially from its rows' next eight words, staged in shared memory ahead
  of it, and carries the kept rows' next seven words in registers; the
  other seven warps OR the kept rows' later words into the shared
  ``removed`` words, four blocks at a time, while the resolver goes on —
  so no step of the chain waits on device memory.

:func:`nms_bitmask` chains them: one launch of each per batch, whatever
the batch size.  The TPU kernel's 8×8 ``diagp`` table (``_nms_prep``) has
no counterpart: the diagonal tile is part of the mask here.

Every wrapper serves a CPU tensor with its plain PyTorch version
(:func:`suppression_mask_plain`, :func:`sweep_plain`, and
``ops.nms.nms_padded_batch`` for :func:`nms_bitmask`), and a CUDA tensor with
its kernel or an exception — never with the plain version.  Boxes must
arrive score-sorted (``ops.proposal.propose`` sorts them).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from mx_rcnn_tpu_torch.kernels import _build
from mx_rcnn_tpu_torch.ops.boxes import bbox_overlaps
from mx_rcnn_tpu_torch.ops.nms import nms_padded_batch

WORD = 64
# the sweep keeps one word per 64 boxes in shared memory: 48 KB at this
# limit, beside its 34 KB of staged tiles and kept rows (the launcher opts
# in to more than the 48 KB default)
MAX_BOXES = WORD * (48 * 1024 // 8)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mxr_nms_mask": (_I, [_P, _I, _I, _F, _P, _P]),
    "mxr_nms_sweep": (_I, [_P, _P, _I, _I, _I, _P, _P, _P]),
}


def col_blocks(n: int) -> int:
    return (n + WORD - 1) // WORD


def _lib() -> ctypes.CDLL:
    return _build.load("nms_bitmask", _SIGNATURES)


def _launch(fn_name: str, t: torch.Tensor, *args) -> None:
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = getattr(_lib(), fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed with "
                           f"cudaError {rc}")


def _route(t: torch.Tensor) -> bool:
    """True for the kernel, False for the plain version; raises for any
    other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no NMS kernel for device {t.device}")


def _check_boxes(boxes: torch.Tensor) -> None:
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, n, 4), got {tuple(boxes.shape)}")
    if boxes.shape[1] > MAX_BOXES:
        raise ValueError(f"at most {MAX_BOXES} boxes per image, got "
                         f"{boxes.shape[1]}")


def _check_valid(valid: torch.Tensor, boxes_like: torch.Tensor) -> None:
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if tuple(valid.shape) != tuple(boxes_like.shape[:2]):
        raise ValueError(f"valid must be {tuple(boxes_like.shape[:2])}, got "
                         f"{tuple(valid.shape)}")
    if valid.device != boxes_like.device:
        raise ValueError("valid and boxes/mask are on different devices")


def _check_contiguous(*ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("the NMS kernels take contiguous tensors")


# ---- plain versions ---------------------------------------------------------

def suppression_mask_plain(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """(B, n, 4) → (B, n, ceil(n/64)) int64 words: bit j of word w in row i
    is IoU(i, 64w+j) > thresh for 64w+j > i, zero elsewhere."""
    b, n, _ = boxes.shape
    cb = col_blocks(n)
    sup = bbox_overlaps(boxes, boxes) > float(np.float32(iou_thresh))
    sup &= torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    bits = F.pad(sup, (0, cb * WORD - n)).view(b, n, cb, WORD).to(torch.int64)
    shifts = torch.arange(WORD, dtype=torch.int64, device=boxes.device)
    # one term at most is negative (bit 63), so the sum never overflows
    return (bits << shifts).sum(-1)


def sweep_plain(mask: torch.Tensor, valid: torch.Tensor, max_out: int):
    """Greedy sweep over the (B, n, ceil(n/64)) words of
    :func:`suppression_mask_plain` → (keep_idx (B, max_out) int32,
    keep_mask (B, max_out) bool).  Reads only the bits above the diagonal,
    like the kernel."""
    b, n, cb = mask.shape
    dev = mask.device
    keep_idx = torch.zeros((b, max_out), dtype=torch.int32, device=dev)
    keep_mask = torch.zeros((b, max_out), dtype=torch.bool, device=dev)
    if n == 0:
        return keep_idx, keep_mask
    shifts = torch.arange(WORD, dtype=torch.int64, device=dev)
    sup = ((mask[..., None] >> shifts) & 1).view(b, n, cb * WORD)[..., :n] > 0
    sup &= torch.ones(n, n, dtype=torch.bool, device=dev).triu(1)
    removed = ~valid
    rows = torch.arange(b, device=dev)
    for t in range(max_out):
        i = torch.argmax((~removed).to(torch.uint8), dim=1)  # first live row
        ok = ~removed[rows, i]
        removed = removed | (sup[rows, i] & ok[:, None])
        removed[rows, i] = True
        keep_idx[:, t] = torch.where(ok, i, 0).to(torch.int32)
        keep_mask[:, t] = ok
    return keep_idx, keep_mask


# ---- kernel wrappers --------------------------------------------------------

def nms_mask(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Phase A: (B, n, 4) float32 score-sorted boxes → (B, n, ceil(n/64))
    int64 suppression words.  On the card, words left of a row's own
    64-row block are left unwritten (the sweep never reads them)."""
    _check_boxes(boxes)
    if not _route(boxes):
        return suppression_mask_plain(boxes, iou_thresh)
    _check_contiguous(boxes)
    b, n, _ = boxes.shape
    mask = torch.empty((b, n, col_blocks(n)), dtype=torch.int64,
                       device=boxes.device)
    if b and n:
        _launch("mxr_nms_mask", boxes, boxes.data_ptr(), b, n,
                float(np.float32(iou_thresh)), mask.data_ptr())
        nms_mask.launches += 1
    return mask


nms_mask.launches = 0


def nms_sweep(mask: torch.Tensor, valid: torch.Tensor, max_out: int):
    """Phase B: greedy sweep of :func:`nms_mask`'s words → (keep_idx
    (B, max_out) int32 in score order with padded slots 0, keep_mask
    (B, max_out) bool)."""
    if mask.dtype != torch.int64 or mask.dim() != 3 or \
            mask.shape[2] != col_blocks(mask.shape[1]):
        raise ValueError(f"mask must be (B, n, ceil(n/64)) int64, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if mask.shape[1] > MAX_BOXES:
        raise ValueError(f"at most {MAX_BOXES} boxes per image, got "
                         f"{mask.shape[1]}")
    _check_valid(valid, mask)
    max_out = int(max_out)
    if max_out < 0:
        raise ValueError(f"max_out must be >= 0, got {max_out}")
    if not _route(mask):
        return sweep_plain(mask, valid, max_out)
    _check_contiguous(mask, valid)
    b, n, _ = mask.shape
    if n == 0:
        return (torch.zeros((b, max_out), dtype=torch.int32, device=mask.device),
                torch.zeros((b, max_out), dtype=torch.bool, device=mask.device))
    keep_idx = torch.empty((b, max_out), dtype=torch.int32, device=mask.device)
    keep_mask = torch.empty((b, max_out), dtype=torch.bool, device=mask.device)
    if b and max_out:
        _launch("mxr_nms_sweep", mask, mask.data_ptr(), valid.data_ptr(), b, n,
                max_out, keep_idx.data_ptr(), keep_mask.data_ptr())
        nms_sweep.launches += 1
    return keep_idx, keep_mask


nms_sweep.launches = 0


def nms_bitmask(boxes: torch.Tensor, valid: torch.Tensor, max_out: int,
                iou_thresh: float):
    """Greedy NMS of a batch of score-sorted boxes.

    Args:
      boxes: (B, n, 4) float32, each image sorted by descending score.
      valid: (B, n) bool; False rows are never kept and never suppress.
      max_out: output slots per image.
      iou_thresh: suppress when IoU > thresh.

    Returns ``keep_idx`` (B, max_out) int32 (score order, padded slots 0)
    and ``keep_mask`` (B, max_out) bool — ``ops.nms.nms_padded``'s
    contract per image.  CUDA: one launch of each kernel.  CPU:
    ``nms_padded_batch``.
    """
    _check_boxes(boxes)
    _check_valid(valid, boxes)
    if _route(boxes):
        return nms_sweep(nms_mask(boxes, iou_thresh), valid, max_out)
    b, n, _ = boxes.shape
    # selection order is index order: the boxes are score-sorted
    order = torch.arange(n, 0, -1, dtype=torch.float32).expand(b, n)
    return nms_padded_batch(boxes, order, max_out, iou_thresh, valid)
