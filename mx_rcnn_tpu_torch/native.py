"""ctypes bindings of the host library, ``csrc/mxr_native.cpp``
(counterpart of ``mx_rcnn_tpu/native/__init__.py``: ``nms``,
``bbox_overlaps``, ``rle_encode_packed``, ``paste_rle``, ``rle_iou``).

The library is built on first use with the host C++ compiler
(``kernels/_build.py``).  Unlike the JAX package's bindings there is no
numpy fallback: when the library cannot be built or loaded, every function
here raises ``RuntimeError`` naming it, and the caller picks another route
by name (``TEST.MASK_PASTE="host"`` for the masks, an injected
``nms_fn=ops.nms.nms`` for the host per-class NMS).

Each thread encodes into its own scratch buffer, so the eval loop's host
workers may call these at once.

API:
  nms(dets (N, 5) float32, thresh) -> list[int]
  bbox_overlaps(boxes (N, 4), query (K, 4)) -> (N, K) float32
  rle_encode_packed(packed (Wp, Hp/8) uint8, h, w) -> list[int]
  paste_rle(prob (M, M) float32, box [x1, y1, x2, y2], h, w) -> list[int]
  rle_iou(dts, gts, iscrowd) -> (D, G) float64   (RLE dicts, count lists)
  available() -> bool
"""

from __future__ import annotations

import ctypes
import threading
from typing import List

import numpy as np

from mx_rcnn_tpu_torch.kernels import _build

_P, _I64, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "mxr_bbox_overlaps": (None, [_P, _I64, _P, _I64, _P]),
    "mxr_nms": (_I64, [_P, _I64, _F, _P]),
    "mxr_rle_encode": (_I64, [_P, _I64, _I64, _I64, _P]),
    "mxr_paste_rle": (_I64, [_P, _I64, _F, _F, _F, _F, _I64, _I64, _P]),
    "mxr_rle_iou": (None, [_P, _P, _I64, _P, _P, _I64, _P, _P, _P, _I64,
                           _P]),
}
_local = threading.local()


def _lib() -> ctypes.CDLL:
    try:
        return _build.load("mxr_native", _SIGNATURES)
    except (OSError, RuntimeError) as e:
        raise RuntimeError(f"the host library csrc/mxr_native.cpp is "
                           f"unavailable ({e}); set TEST.MASK_PASTE='host' "
                           f"for the numpy paste, or pass "
                           f"nms_fn=ops.nms.nms for the numpy NMS") from e


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _lib()
    except RuntimeError:
        return False
    return True


def nms(dets: np.ndarray, thresh: float) -> List[int]:
    """Greedy NMS over (N, 5) [x1, y1, x2, y2, score] rows with legacy +1
    areas → kept row indices, score-descending, equal scores in row order
    (``ops/nms.py:nms``'s contract, which is its numpy oracle)."""
    lib = _lib()
    dets = np.ascontiguousarray(dets, np.float32).reshape(-1, 5)
    n = len(dets)
    if n == 0:
        return []
    keep = np.empty(n, np.int64)
    cnt = lib.mxr_nms(dets.ctypes.data, n, float(thresh), keep.ctypes.data)
    return keep[:cnt].tolist()


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(N, 4) × (K, 4) boxes → (N, K) float32 IoU with legacy +1 areas."""
    lib = _lib()
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    query = np.ascontiguousarray(query, np.float32).reshape(-1, 4)
    out = np.empty((len(boxes), len(query)), np.float32)
    lib.mxr_bbox_overlaps(boxes.ctypes.data, len(boxes), query.ctypes.data,
                          len(query), out.ctypes.data)
    return out


def _counts_buffer(n: int) -> np.ndarray:
    """This thread's uint32 scratch of at least ``n`` counts."""
    buf = getattr(_local, "buf", None)
    if buf is None or buf.size < n:
        buf = _local.buf = np.empty(n, np.uint32)
    return buf


def rle_encode_packed(packed: np.ndarray, h: int, w: int) -> List[int]:
    """A bit-packed transposed mask (Wp, Hp/8) uint8 (``ops/mask_paste.py``
    layout: bit ``y & 7`` of byte ``[x, y >> 3]`` is pixel (y, x)) →
    column-major COCO RLE counts over the true (h, w) frame."""
    packed = np.ascontiguousarray(packed, np.uint8)
    hp = packed.shape[1] * 8
    if hp % 64:
        raise ValueError(f"packed height {hp} must be a multiple of 64")
    if h > hp or w > packed.shape[0]:
        raise ValueError(f"frame ({h}, {w}) exceeds the packed capacity "
                         f"({hp}, {packed.shape[0]})")
    lib = _lib()
    buf = _counts_buffer(h * w + 1)
    n = lib.mxr_rle_encode(packed.ctypes.data, hp, h, w, buf.ctypes.data)
    return buf[:n].tolist()


def paste_rle(prob: np.ndarray, box, h: int, w: int) -> List[int]:
    """(M, M) mask probabilities + an original-frame box → the full-frame
    column-major RLE counts of ``eval/tester.py:paste_mask``'s mask
    (integer window [floor, ceil], half-pixel bilinear, threshold 0.5),
    streamed column by column without the frame."""
    prob = np.ascontiguousarray(prob, np.float32)
    lib = _lib()
    buf = _counts_buffer(h * w + 1)
    n = lib.mxr_paste_rle(prob.ctypes.data, prob.shape[0], float(box[0]),
                          float(box[1]), float(box[2]), float(box[3]), h, w,
                          buf.ctypes.data)
    return buf[:n].tolist()


def _flatten_counts(rles: list):
    counts = [np.asarray(r["counts"], np.uint32) for r in rles]
    off = np.zeros(len(rles) + 1, np.int64)
    off[1:] = np.cumsum([len(c) for c in counts])
    flat = np.concatenate(counts) if counts else np.zeros(0, np.uint32)
    return np.ascontiguousarray(flat), off


def rle_iou(dts: list, gts: list, iscrowd) -> np.ndarray:
    """(D, G) mask IoU of RLE dicts with uncompressed counts over one
    frame; a crowd gt divides by the detection's area."""
    lib = _lib()
    d, g = len(dts), len(gts)
    out = np.zeros((d, g), np.float64)
    if d == 0 or g == 0:
        return out
    n = int(dts[0]["size"][0]) * int(dts[0]["size"][1])
    dc, doff = _flatten_counts(dts)
    gc, goff = _flatten_counts(gts)
    d_area = np.asarray([int(np.sum(np.asarray(r["counts"])[1::2]))
                         for r in dts], np.int64)
    g_area = np.asarray([int(np.sum(np.asarray(r["counts"])[1::2]))
                         for r in gts], np.int64)
    crowd = np.ascontiguousarray(np.asarray(iscrowd, np.uint8))
    lib.mxr_rle_iou(dc.ctypes.data, doff.ctypes.data, d, gc.ctypes.data,
                    goff.ctypes.data, g, d_area.ctypes.data,
                    g_area.ctypes.data, crowd.ctypes.data, n,
                    out.ctypes.data)
    return out
