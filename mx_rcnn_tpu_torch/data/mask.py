"""Host-side gt mask rasterisation for Mask R-CNN training (counterpart of
``mx_rcnn_tpu/data/mask.py``), without cv2.

Each gt instance's segmentation (COCO's, in original image coordinates) is
rasterised once a sample into a fixed (S, S) crop aligned to its gt box;
``ops/mask_target.py`` resamples these crops into each sampled RoI's frame
on the card, so the host does O(G) small rasterisations an image, never
O(R) a step.

* polygons: mirrored ``x → width − x − 1`` on a flipped record, mapped
  into the gt-box frame, rounded half to even, parts of fewer than 3
  points skipped, filled by ``eval/mask_rle.py:fill_poly`` (equal to
  ``cv2.fillPoly``);
* RLE dicts: decoded, mirrored on a flipped record, cropped to the gt
  box's integer bounds and resized to (S, S) by :func:`resize_nearest`
  (equal to ``cv2.resize(..., INTER_NEAREST)``);
* ``None`` (VOC, synthetic): the full box.

The crops are ``uint8`` {0, 1}: the values the JAX package's float32
crops hold, at a quarter of the bytes through the worker pipe and the
copy to the card; ``mask_targets_for_rois`` casts them to float32 there.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from mx_rcnn_tpu_torch.eval.mask_rle import decode, fill_poly, string_to_counts

GT_MASK_SIZE = 112  # the gt-box-frame crop's side (4× the head's 28)


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """OpenCV's ``INTER_NEAREST`` source index of each of ``dst`` output
    pixels: ``min(floor(d · (1/fx)), src − 1)`` with ``fx = dst/src`` in
    double."""
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64),
                      src - 1)


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """A 2-D array resized to (height, width) by nearest neighbour, as
    ``cv2.resize(img, (width, height), interpolation=cv2.INTER_NEAREST)``."""
    return img[_nearest_index(img.shape[0], height)[:, None],
               _nearest_index(img.shape[1], width)[None, :]]


def rasterize_gt_masks(segs: Sequence, boxes: np.ndarray, width: int,
                       flipped: bool, max_gt: int,
                       size: int = GT_MASK_SIZE) -> np.ndarray:
    """(max_gt, size, size) uint8 gt-box-frame masks.

    Args:
      segs: each gt's COCO segmentation (polygon list, RLE dict or None).
      boxes: (G, 4) gt boxes in original image coordinates, already
        mirrored on a flipped record (the roidb contract); truncated at
        ``max_gt``.
      width: the original image width (the polygons' mirror).
      flipped: whether the record is an x-flip.
    """
    g = min(len(boxes), max_gt)
    out = np.zeros((max_gt, size, size), np.uint8)
    for j in range(g):
        seg = segs[j] if segs is not None and j < len(segs) else None
        if seg is None:
            out[j] = 1  # no segmentation: the full box
            continue
        x1, y1, x2, y2 = boxes[j]
        bw = max(x2 - x1, 1e-3)
        bh = max(y2 - y1, 1e-3)
        if isinstance(seg, list):
            pts = []
            for poly in seg:
                p = np.asarray(poly, np.float64).reshape(-1, 2)
                if flipped:
                    p[:, 0] = width - p[:, 0] - 1
                p[:, 0] = (p[:, 0] - x1) / bw * size
                p[:, 1] = (p[:, 1] - y1) / bh * size
                if len(p) >= 3:
                    pts.append(p.round().astype(np.int32))
            if pts:
                fill_poly(out[j], pts, 1)
        elif isinstance(seg, dict):
            counts = seg.get("counts")
            if isinstance(counts, (str, bytes)):
                counts = string_to_counts(counts)
            full = decode({"size": seg["size"], "counts": counts})
            if flipped:
                full = full[:, ::-1]
            xi1, yi1 = int(max(x1, 0)), int(max(y1, 0))
            xi2 = int(min(x2 + 1, full.shape[1]))
            yi2 = int(min(y2 + 1, full.shape[0]))
            crop = full[yi1:yi2, xi1:xi2]
            if crop.size:
                out[j] = resize_nearest(crop, size, size)
    return out
