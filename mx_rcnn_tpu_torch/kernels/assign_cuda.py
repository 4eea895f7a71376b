"""Fused anchor-assign IoU reductions on the card: wrappers of
``csrc/assign_iou.cu``.

The CUDA counterpart of ``mx_rcnn_tpu/kernels/assign_pallas.py``
(``_assign_kernel``): the four reductions of the (N, G) anchor × gt IoU
matrix that ``ops/assign_anchor.py`` needs, without the matrix.  Two
kernels on tiles of ``TILE`` anchors, each behind its own wrapper with its
own launch count:

* :func:`assign_gtmax` — every IoU once, over the valid gt only: per
  anchor the max IoU and its first-index argmax, the per-tile maxima over
  inside anchors per gt (``partials`` (B, ceil(N / TILE), G)), and
  ``gt_max``, reduced from the partials by the last block of each image;
* :func:`assign_rows` — the "ties a positive per-gt max" predicate, with
  the IoU recomputed only for the (tile, gt) pairs whose partial equals
  ``gt_max``: no other tile can hold a tying anchor.

:func:`assign_reduce` chains them: one launch of each per batch, whatever
the batch size (the JAX kernel ran images one at a time under
``lax.map``).  There is no backward: labels and targets are not
differentiated.

Every wrapper serves a CPU tensor with its plain PyTorch version
(:func:`gtmax_partials_plain`, :func:`rows_plain`, and the dense
:func:`assign_reduce_plain` for :func:`assign_reduce`), and a CUDA tensor
with its kernel or an exception — never with the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mx_rcnn_tpu_torch.kernels import _build
from mx_rcnn_tpu_torch.ops.boxes import bbox_overlaps

# the gt of an image sit in shared memory, one slot per gt (the TPU kernel
# padded gt to one 128-lane row for the same reason)
MAX_GT = 128
TILE = 256          # anchors per block of either kernel, one a thread
# int32 anchor indices in the kernels; the image index is grid.y
MAX_ANCHORS = 2 ** 31 - 1 - TILE
MAX_BATCH = 65535

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mxr_assign_gtmax": (_I, [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                              _P]),
    "mxr_assign_rows": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P]),
}
# (device index, stream) -> int32 arrival counters of assign_gtmax, one per
# image: zero before a launch, and the launch leaves them at zero
_ARRIVALS: dict = {}


def n_tiles(n: int) -> int:
    return (n + TILE - 1) // TILE


def _lib() -> ctypes.CDLL:
    return _build.load("assign_iou", _SIGNATURES)


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
    raise ValueError(f"no assign kernel for device {t.device}")


def _check(anchors, gt_boxes, gt_valid, inside) -> None:
    if anchors.dtype != torch.float32 or gt_boxes.dtype != torch.float32:
        raise TypeError(f"anchors and gt_boxes must be float32, got "
                        f"{anchors.dtype} and {gt_boxes.dtype}")
    if anchors.dim() != 2 or anchors.shape[1] != 4:
        raise ValueError(f"anchors must be (N, 4), got {tuple(anchors.shape)}")
    if gt_boxes.dim() != 3 or gt_boxes.shape[2] != 4:
        raise ValueError(f"gt_boxes must be (B, G, 4), got "
                         f"{tuple(gt_boxes.shape)}")
    b, g, _ = gt_boxes.shape
    n = anchors.shape[0]
    if not 1 <= g <= MAX_GT:
        raise ValueError(f"the assign kernels take 1 to {MAX_GT} gt boxes "
                         f"per image, got {g}")
    if not 1 <= n <= MAX_ANCHORS:
        raise ValueError(f"the assign kernels take 1 to {MAX_ANCHORS} "
                         f"anchors, got {n}")
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"the assign kernels take 1 to {MAX_BATCH} images, "
                         f"got {b}")
    for name, t, shape in (("gt_valid", gt_valid, (b, g)),
                           ("inside", inside, (b, n))):
        if t.dtype != torch.bool or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} bool, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if len({t.device for t in (anchors, gt_boxes, gt_valid, inside)}) != 1:
        raise ValueError("anchors, gt_boxes, gt_valid and inside are on "
                         "different devices")


def _check_contiguous(*ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("the assign kernels take contiguous tensors")
    for t in ts[:2]:
        if t.data_ptr() % 16:
            raise ValueError("the assign kernels read anchors and gt_boxes "
                             "as float4: they must be 16-byte aligned")


def _check_phase1(anchors, gt_boxes, gt_max, partials) -> None:
    b, g, _ = gt_boxes.shape
    n = anchors.shape[0]
    for name, t, shape in (("gt_max", gt_max, (b, g)),
                           ("partials", partials, (b, n_tiles(n), g))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != anchors.device):
            raise ValueError(f"{name} must be {shape} float32 on "
                             f"{anchors.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


# ---- plain versions ---------------------------------------------------------

def _masked_overlaps(anchors, gt_boxes, gt_valid, inside, dtype):
    """(B, N, G) IoU with invalid gt columns at −1, and its copy with the
    outside anchors' rows at −1 too."""
    ov = bbox_overlaps(anchors, gt_boxes).to(dtype)
    ov = torch.where(gt_valid[:, None, :], ov, -1.0)
    return ov, torch.where(inside[:, :, None], ov, -1.0)


def _tie(ov_in, gt_max, gt_valid):
    """The tie predicate from the inside-masked matrix and ``gt_max``."""
    return ((ov_in == gt_max[:, None, :]) & gt_valid[:, None, :]
            & (gt_max[:, None, :] > 0)).any(dim=2)


def assign_reduce_plain(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                        gt_valid: torch.Tensor, inside: torch.Tensor,
                        iou_dtype: torch.dtype = torch.float32):
    """The dense path: the (B, N, G) IoU matrix, then its reductions.

    Returns ``max_overlap`` (B, N), ``argmax`` (B, N) int64 (ties to the
    lowest gt index), ``gt_max`` (B, G) over inside anchors, and
    ``is_gt_argmax`` (B, N) bool.  ``iou_dtype=torch.bfloat16`` stores the
    matrix in bfloat16 (``TRAIN.RPN_ASSIGN_IOU_BF16``); the float outputs
    then come in that type."""
    ov, ov_in = _masked_overlaps(anchors, gt_boxes, gt_valid, inside,
                                 iou_dtype)
    gt_max = ov_in.max(dim=1).values
    return (ov.max(dim=2).values, torch.argmax(ov, dim=2), gt_max,
            _tie(ov_in, gt_max, gt_valid))


def gtmax_partials_plain(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                         gt_valid: torch.Tensor, inside: torch.Tensor):
    """:func:`assign_gtmax`'s outputs: ``max_overlap``, ``argmax`` and
    ``gt_max`` as :func:`assign_reduce_plain` gives them, and ``partials``
    (B, ceil(N / TILE), G), the maxima of the IoU over the inside anchors
    of each ``TILE``-anchor tile."""
    ov, ov_in = _masked_overlaps(anchors, gt_boxes, gt_valid, inside,
                                 torch.float32)
    b, n, g = ov_in.shape
    t = n_tiles(n)
    tiled = F.pad(ov_in, (0, 0, 0, t * TILE - n), value=-1.0)
    return (ov.max(dim=2).values, torch.argmax(ov, dim=2),
            ov_in.max(dim=1).values,
            tiled.view(b, t, TILE, g).max(dim=2).values)


def rows_plain(anchors: torch.Tensor, gt_boxes: torch.Tensor,
               gt_valid: torch.Tensor, inside: torch.Tensor,
               gt_max: torch.Tensor, partials: torch.Tensor) -> torch.Tensor:
    """:func:`assign_rows`' output, ``is_gt_argmax`` (B, N) bool, from the
    given ``gt_max``.  The kernel reads ``partials`` only to skip the tiles
    that cannot tie, so with :func:`assign_gtmax`'s partials the plain
    version needs ``gt_max`` alone."""
    _, ov_in = _masked_overlaps(anchors, gt_boxes, gt_valid, inside,
                                torch.float32)
    return _tie(ov_in, gt_max, gt_valid)


# ---- kernel wrappers --------------------------------------------------------

def _arrivals(dev: torch.device, b: int) -> torch.Tensor:
    """Zeroed arrival counters for a launch of assign_gtmax on the current
    stream.  A launch leaves them at zero, so they are kept per stream (one
    launch at a time uses them); a buffer first made while the stream is
    being captured into a CUDA graph is zeroed only when the graph replays,
    so it is used for that capture alone and not kept."""
    stream = torch.cuda.current_stream(dev)
    key = (dev.index, stream.cuda_stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < b:
        buf = torch.zeros(max(b, 64), dtype=torch.int32, device=dev)
        if not torch.cuda.is_current_stream_capturing():
            _ARRIVALS[key] = buf
    return buf


def _gtmax_kernel(anchors, gt_boxes, gt_valid, inside):
    """Launch assign_gtmax on checked, contiguous CUDA tensors."""
    b, g, _ = gt_boxes.shape
    n = anchors.shape[0]
    dev = anchors.device
    max_overlap = torch.empty((b, n), dtype=torch.float32, device=dev)
    argmax = torch.empty((b, n), dtype=torch.int64, device=dev)
    gt_max = torch.empty((b, g), dtype=torch.float32, device=dev)
    partials = torch.empty((b, n_tiles(n), g), dtype=torch.float32,
                           device=dev)
    with torch.cuda.device(dev):
        arrivals = _arrivals(dev, b)
    _launch("mxr_assign_gtmax", anchors, anchors.data_ptr(),
            gt_boxes.data_ptr(), gt_valid.data_ptr(), inside.data_ptr(), b, n,
            g, max_overlap.data_ptr(), argmax.data_ptr(), gt_max.data_ptr(),
            partials.data_ptr(), arrivals.data_ptr())
    assign_gtmax.launches += 1
    return max_overlap, argmax, gt_max, partials


def _rows_kernel(anchors, gt_boxes, gt_valid, inside, gt_max, partials):
    """Launch assign_rows on checked, contiguous CUDA tensors."""
    b, g, _ = gt_boxes.shape
    n = anchors.shape[0]
    tie = torch.empty((b, n), dtype=torch.bool, device=anchors.device)
    _launch("mxr_assign_rows", anchors, anchors.data_ptr(),
            gt_boxes.data_ptr(), gt_valid.data_ptr(), inside.data_ptr(),
            gt_max.data_ptr(), partials.data_ptr(), b, n, g, tie.data_ptr())
    assign_rows.launches += 1
    return tie


def assign_gtmax(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_valid: torch.Tensor, inside: torch.Tensor):
    """Phase 1: anchors (N, 4) float32, gt_boxes (B, G ≤ 128, 4) float32,
    gt_valid (B, G) bool, inside (B, N) bool → ``(max_overlap (B, N)
    float32, argmax (B, N) int64, gt_max (B, G) float32, partials (B,
    ceil(N / TILE), G) float32)``."""
    _check(anchors, gt_boxes, gt_valid, inside)
    if not _route(anchors):
        return gtmax_partials_plain(anchors, gt_boxes, gt_valid, inside)
    _check_contiguous(anchors, gt_boxes, gt_valid, inside)
    return _gtmax_kernel(anchors, gt_boxes, gt_valid, inside)


assign_gtmax.launches = 0


def assign_rows(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                gt_valid: torch.Tensor, inside: torch.Tensor,
                gt_max: torch.Tensor, partials: torch.Tensor) -> torch.Tensor:
    """Phase 2: the inputs of :func:`assign_gtmax` plus its ``gt_max`` and
    ``partials`` → ``is_gt_argmax`` (B, N) bool."""
    _check(anchors, gt_boxes, gt_valid, inside)
    _check_phase1(anchors, gt_boxes, gt_max, partials)
    if not _route(anchors):
        return rows_plain(anchors, gt_boxes, gt_valid, inside, gt_max,
                          partials)
    _check_contiguous(anchors, gt_boxes, gt_valid, inside, gt_max, partials)
    return _rows_kernel(anchors, gt_boxes, gt_valid, inside, gt_max,
                        partials)


assign_rows.launches = 0


def assign_reduce(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, inside: torch.Tensor):
    """The four assign reductions of a batch (see
    :func:`assign_reduce_plain` for the contract).  CUDA: one launch of
    each kernel.  CPU: :func:`assign_reduce_plain`."""
    _check(anchors, gt_boxes, gt_valid, inside)
    if not _route(anchors):
        return assign_reduce_plain(anchors, gt_boxes, gt_valid, inside)
    args = (anchors, gt_boxes, gt_valid, inside)
    _check_contiguous(*args)
    max_overlap, argmax, gt_max, partials = _gtmax_kernel(*args)
    return max_overlap, argmax, gt_max, _rows_kernel(*args, gt_max, partials)
