"""COCO RLE mask operations (counterpart of ``mx_rcnn_tpu/eval/mask_rle.py``:
``encode``, ``decode``, ``area``, ``counts_to_string``,
``string_to_counts``, ``merge``, ``poly_to_rle``, ``ann_to_rle``,
``rle_iou``, ``masks_to_boxes``), in numpy without cv2.

* column-major run-length encoding starting with a run of zeros (possibly
  empty);
* the COCO compressed string (5-bit groups, delta-coded from the third
  count on);
* ``rle_iou`` with the crowd rule (a crowd gt divides by the detection's
  area); COCO evaluation uses the native one (``native.py``);
* polygons rasterised by :func:`fill_poly`, the port's own scanline fill,
  which reproduces ``cv2.fillPoly`` (8-connected, no shift) on integer
  vertices pixel for pixel (held to cv2 on ~10 000 seeded polygons:
  convex, concave, self-intersecting, degenerate, partly and wholly
  outside, several at once): every edge is drawn as a line first, clipped
  to the image, then the spans between the active edges of each row are
  filled in 16.16 fixed point, even-odd over all polygons at once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def encode(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask → RLE dict ``{"size": [H, W], "counts": list}``
    (column-major runs, starting with the count of leading zeros)."""
    h, w = mask.shape
    flat = np.asarray(mask).reshape(-1, order="F").astype(np.int8)
    if flat.size == 0:
        return {"size": [h, w], "counts": [0]}
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    ends = np.concatenate([change, [flat.size]])
    counts = np.diff(np.concatenate([[0], ends])).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def decode(rle: Dict) -> np.ndarray:
    """RLE dict (count list or compressed string) → binary (H, W) uint8."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    for i, c in enumerate(counts):
        if i % 2:
            flat[pos:pos + c] = 1
        pos += c
    return flat.reshape((h, w), order="F")


def area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return int(sum(counts[1::2]))


def counts_to_string(counts: Sequence[int]) -> str:
    """COCO's compressed RLE string (``maskApi.c rleToString``)."""
    out = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c6 = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not c6 & 0x10)
                        or (x == -1 and c6 & 0x10))
            if more:
                c6 |= 0x20
            out.append(chr(c6 + 48))
    return "".join(out)


def string_to_counts(s: Union[str, bytes]) -> List[int]:
    """Inverse of :func:`counts_to_string` (``maskApi.c rleFrString``)."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and c & 0x10:
                x |= -1 << (5 * (k + 1))   # sign extension
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def merge(rles: List[Dict]) -> Dict:
    """The union of masks of one frame (``rleMerge``, intersect=0)."""
    if not rles:
        return {"size": [0, 0], "counts": [0]}
    if len(rles) == 1:
        return rles[0]
    m = decode(rles[0])
    for r in rles[1:]:
        m |= decode(r)
    return encode(m)


# ---- the polygon fill ---------------------------------------------------------

def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """Cohen–Sutherland clip of a segment to the (w, h) frame in integer
    arithmetic with a double quotient truncated toward zero (OpenCV's
    ``clipLine``) → ``(inside, x1, y1, x2, y2)``; the points may be moved
    even when the segment is outside."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _outside(w: int, h: int, x1: int, y1: int, x2: int, y2: int) -> bool:
    return not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h)


def _line(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
          color) -> None:
    """An 8-connected Bresenham segment, clipped, drawn from its left end
    (OpenCV's ``LineIterator`` with ``leftToRight``)."""
    h, w = img.shape
    if _outside(w, h, x1, y1, x2, y2):
        ok, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    # the major axis moves every step, the minor one when err < 0
    if dy > dx:
        major, minor, (mx, my), (nx, ny) = dy, dx, (0, sy), (1, 0)
    else:
        major, minor, (mx, my), (nx, ny) = dx, dy, (1, 0), (0, sy)
    n = major + 1
    err = major - 2 * minor
    xs = np.empty(n, np.int64)
    ys = np.empty(n, np.int64)
    x, y = x1, y1
    for i in range(n):
        xs[i], ys[i] = x, y
        step = err < 0
        err += -2 * minor + (2 * major if step else 0)
        x += mx + (nx if step else 0)
        y += my + (ny if step else 0)
    img[ys, xs] = color


def _collect_edges(img: np.ndarray, pts: np.ndarray, edges: list,
                   color) -> None:
    """Draw each edge of one closed polygon and add its non-horizontal
    edges as ``[y0, y1, x, dx]`` (x, dx in 16.16 fixed point) to
    ``edges`` (OpenCV's ``CollectPolyEdges``)."""
    h, w = img.shape
    n = len(pts)
    x0, y0 = int(pts[-1][0]) << XY_SHIFT, int(pts[-1][1])
    for i in range(n):
        x1, y1 = int(pts[i][0]) << XY_SHIFT, int(pts[i][1])
        t0x, t1x = (x0 + (XY_ONE >> 1)) >> XY_SHIFT, \
                   (x1 + (XY_ONE >> 1)) >> XY_SHIFT
        _line(img, t0x, y0, t1x, y1, color)
        c0x, c0y, c1x, c1y = x0, y0, x1, y1
        if _outside(w, h, t0x, y0, t1x, y1):
            # an edge that leaves the image takes its slope from its clipped
            # ends; clipped to one row, it keeps its rows at the clipped x
            _, a, b, c, d = _clip_line(w, h, t0x, y0, t1x, y1)
            c0x, c1x = a << XY_SHIFT, c << XY_SHIFT
            if b != d:
                c0y, c1y = b, d
        if y0 != y1:
            num, den = c1x - c0x, c1y - c0y
            q = abs(num) // abs(den)
            dx = q if (num >= 0) == (den > 0) else -q   # C's truncation
            if y0 < y1:
                edges.append([y0, y1, c0x + (y0 - c0y) * dx, dx])
            else:
                edges.append([y1, y0, c1x + (y1 - c1y) * dx, dx])
        x0, y0 = x1, y1


def _fill_edges(img: np.ndarray, edges: list, color) -> None:
    """Even-odd scanline fill over all collected edges (OpenCV's
    ``FillEdgeCollection``): each row's active edges in x order, filled
    pairwise from ceil(left) to floor(right), each pair's x stepping by its
    slope as it is drawn."""
    h, w = img.shape
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    total = len(edges)
    i = 0
    active: list = []
    for y in range(edges[0][0], min(y_max, h)):
        merged = []
        prev = None
        draw = False
        j = 0
        while j < len(active) or (i < total and edges[i][0] == y):
            last = active[j] if j < len(active) else None
            if last is not None and last[1] == y:
                j += 1          # the edge ends at this row
                continue
            new_y0 = edges[i][0] if i < total else None
            if last is not None and (new_y0 is None or new_y0 > y
                                     or last[2] < edges[i][2]):
                cur = last
                j += 1
            else:
                cur = edges[i]  # an edge starts at this row
                i += 1
            if draw:
                if y >= 0:
                    lo, hi = (cur, prev) if prev[2] > cur[2] else (prev, cur)
                    x1 = (lo[2] + XY_ONE - 1) >> XY_SHIFT
                    x2 = hi[2] >> XY_SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = color
                prev[2] += prev[3]
                cur[2] += cur[3]
            merged.append(cur)
            prev = cur
            draw = not draw
        active = sorted(merged, key=lambda e: e[2])   # stable, as a bubble sort


def fill_poly(img: np.ndarray, polys: Sequence[np.ndarray], color=1) -> None:
    """Fill integer polygons ``[(n, 2) x, y]`` into the 2-D ``img`` in
    place, as ``cv2.fillPoly(img, polys, color)`` does."""
    edges: list = []
    for pts in polys:
        _collect_edges(img, np.asarray(pts, np.int64).reshape(-1, 2), edges,
                       color)
    _fill_edges(img, [list(e) for e in edges], color)


def poly_to_rle(polys: List[Sequence[float]], h: int, w: int) -> Dict:
    """COCO polygons ``[[x1, y1, x2, y2, ...], ...]`` → RLE; vertices are
    rounded half to even, polygons of fewer than 3 points left out."""
    mask = np.zeros((h, w), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in polys if len(p) >= 6]
    if pts:
        fill_poly(mask, pts, 1)
    return encode(mask)


def ann_to_rle(seg, h: int, w: int) -> Dict:
    """A COCO ``segmentation`` (polygons, count-list RLE or compressed RLE)
    → RLE dict with a count list."""
    if isinstance(seg, list):
        return poly_to_rle(seg, h, w)
    if isinstance(seg, dict):
        if isinstance(seg["counts"], (str, bytes)):
            return {"size": seg["size"],
                    "counts": string_to_counts(seg["counts"])}
        return seg
    raise TypeError(f"bad segmentation: {type(seg)}")


def _intersect_runs(a_counts, b_counts, n: int) -> int:
    """|A ∧ B| by walking both run lists (no decode)."""
    ia = ib = 0
    ca = a_counts[0] if a_counts else n
    cb = b_counts[0] if b_counts else n
    va = vb = 0
    pos = inter = 0
    while pos < n:
        step = min(ca, cb)
        if va and vb:
            inter += step
        ca -= step
        cb -= step
        pos += step
        if ca == 0:
            ia += 1
            ca = a_counts[ia] if ia < len(a_counts) else n
            va ^= 1
        if cb == 0:
            ib += 1
            cb = b_counts[ib] if ib < len(b_counts) else n
            vb ^= 1
    return inter


def rle_iou(dts: List[Dict], gts: List[Dict], iscrowd) -> np.ndarray:
    """(D, G) mask IoU; a crowd gt divides by the detection's area."""
    out = np.zeros((len(dts), len(gts)))
    for di, d in enumerate(dts):
        n = d["size"][0] * d["size"][1]
        da = area(d)
        for gi, g in enumerate(gts):
            inter = _intersect_runs(d["counts"], g["counts"], n)
            union = da if iscrowd[gi] else da + area(g) - inter
            out[di, gi] = inter / union if union > 0 else 0.0
    return out


def masks_to_boxes(rle: Dict) -> np.ndarray:
    """The tight xywh box of an RLE (``rleToBbox``)."""
    ys, xs = np.nonzero(decode(rle))
    if ys.size == 0:
        return np.zeros(4)
    return np.asarray([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                       ys.max() - ys.min() + 1], np.float64)
