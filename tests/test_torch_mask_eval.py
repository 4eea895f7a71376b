"""The port's mask evaluation pieces against the JAX package (and cv2, which
the JAX package calls), on the CPU, with no model.

* ``eval/mask_rle.py`` against ``mx_rcnn_tpu/eval/mask_rle.py``: encode,
  decode, area, the compressed strings, merge, ``ann_to_rle``, ``rle_iou``
  and ``masks_to_boxes`` equal on seeded masks;
* the port's polygon fill against ``cv2.fillPoly``, bit for bit, on seeded
  polygons of eight kinds (convex, self-intersecting, partly outside,
  wholly outside, degenerate: 1–2 points or collinear, several in one
  call, concave stars, axis-aligned and thin), and ``poly_to_rle`` against
  the JAX one on float vertices;
* ``native.py`` (the port's build of ``csrc/mxr_native.cpp``) against the
  JAX package's native library: ``rle_encode_packed``, ``paste_rle`` and
  ``rle_iou`` bitwise (the same C++ arithmetic);
* ``paste_mask`` (numpy) and ``ops/mask_paste.py:paste_masks`` (the device
  paste, here on the CPU) against the JAX ``paste_mask`` (cv2.resize): at
  most 3 flipped pixels a mask on random probabilities (float32 products
  rounded in another order flip pixels within an ulp of 0.5), and exact on
  0/1 probabilities that no interpolation brings near 0.5 (all ones; a
  step edge at 1× and 2×); the packed bits decode through
  ``rle_encode_packed`` to the same mask;
* ``COCOEval(iou_type="segm")`` against the JAX one: stats, ``precision``
  and ``recall`` bit for bit, on polygon, count-list and compressed-string
  gt, a crowd RLE gt and ``area`` fields given or not;
* ``COCODataset.segmentations_to_coco`` and ``evaluate_sds`` against the
  JAX ones.
"""

import json

import cv2
import numpy as np
import pytest

from mx_rcnn_tpu import native as jnative
from mx_rcnn_tpu.data.coco_dataset import COCODataset as JCOCODataset
from mx_rcnn_tpu.eval import mask_rle as jrle
from mx_rcnn_tpu.eval.coco_eval import COCOEval as JCOCOEval
from mx_rcnn_tpu.eval.tester import paste_mask as j_paste_mask

import torch

from mx_rcnn_tpu_torch import native
from mx_rcnn_tpu_torch.data.coco_dataset import COCODataset
from mx_rcnn_tpu_torch.eval import mask_rle
from mx_rcnn_tpu_torch.eval.coco_eval import COCOEval
from mx_rcnn_tpu_torch.eval.tester import paste_mask
from mx_rcnn_tpu_torch.ops.mask_paste import paste_masks

torch.set_num_threads(2)

FLIP_BOUND = 3   # pixels a mask between two pastes of random probabilities
STAT_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
             "AR100", "ARs", "ARm", "ARl")
POLY_KINDS = ("convex", "self_intersecting", "partly_outside",
              "wholly_outside", "degenerate", "several", "concave_star",
              "axis_aligned")


def random_masks(rng, n, h, w):
    out = []
    for i in range(n):
        m = np.zeros((h, w), np.uint8)
        if i % 4:
            for _ in range(rng.randint(1, 4)):
                x, y = rng.randint(0, w), rng.randint(0, h)
                m[y:y + rng.randint(1, h), x:x + rng.randint(1, w)] = 1
            m ^= (rng.rand(h, w) < 0.02).astype(np.uint8)
        if i % 7 == 3:
            m[0, 0] = 1       # starts with foreground: a leading 0 count
        out.append(m)
    return out


def test_rle_helpers_match_jax():
    rng = np.random.RandomState(0)
    masks = random_masks(rng, 24, 37, 53)
    rles, jrles = [], []
    for m in masks:
        r, jr = mask_rle.encode(m), jrle.encode(m)
        assert r == jr
        np.testing.assert_array_equal(mask_rle.decode(r), m)
        s = mask_rle.counts_to_string(r["counts"])
        assert s == jrle.counts_to_string(jr["counts"])
        assert mask_rle.string_to_counts(s) == r["counts"]
        assert mask_rle.string_to_counts(s.encode()) == r["counts"]
        assert mask_rle.area(r) == jrle.area(jr) == int(m.sum())
        assert mask_rle.area({"counts": s}) == int(m.sum())
        np.testing.assert_array_equal(mask_rle.masks_to_boxes(r),
                                      jrle.masks_to_boxes(jr))
        cs = {"size": r["size"], "counts": s}
        assert mask_rle.ann_to_rle(cs, 37, 53) == jrle.ann_to_rle(cs, 37, 53)
        assert mask_rle.ann_to_rle(r, 37, 53) is r
        rles.append(r)
        jrles.append(jr)
    assert mask_rle.merge(rles[:5]) == jrle.merge(jrles[:5])
    assert mask_rle.merge([rles[2]]) is rles[2]
    assert mask_rle.encode(np.zeros((0, 4), np.uint8)) == \
        jrle.encode(np.zeros((0, 4), np.uint8))
    crowd = rng.rand(len(rles)) < 0.3
    np.testing.assert_array_equal(mask_rle.rle_iou(rles, rles, crowd),
                                  jrle.rle_iou(jrles, jrles, crowd))
    with pytest.raises(TypeError):
        mask_rle.ann_to_rle(3, 4, 4)


def polygons(rng, kind, h, w):
    """One call's integer polygons of ``kind`` in an (h, w) frame."""
    if kind == "convex":
        c, r = rng.uniform([0, 0], [w, h]), rng.uniform(2, min(h, w) / 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, rng.randint(3, 9)))
        polys = [c + r * np.stack([np.cos(ang), np.sin(ang)], 1)]
    elif kind == "self_intersecting":
        polys = [rng.uniform([-5, -5], [w + 5, h + 5],
                             (rng.randint(3, 12), 2))]
    elif kind == "partly_outside":
        polys = [rng.uniform([-w, -h], [2 * w, 2 * h],
                             (rng.randint(3, 7), 2))]
    elif kind == "wholly_outside":
        polys = [rng.uniform([w + 1, -h], [3 * w, 2 * h],
                             (rng.randint(3, 6), 2))]
    elif kind == "degenerate":
        m = rng.randint(1, 4)
        p = rng.uniform([0, 0], [w, h], (m, 2))
        if m == 3:
            p[2] = p[0] + 2 * (p[1] - p[0])       # collinear: zero area
        polys = [p]
    elif kind == "several":
        polys = [rng.uniform([0, 0], [w, h], (rng.randint(3, 8), 2))
                 for _ in range(rng.randint(2, 5))]
    elif kind == "concave_star":
        c, k = rng.uniform([0, 0], [w, h]), rng.randint(5, 12)
        ang = np.linspace(0, 2 * np.pi, 2 * k, endpoint=False)
        r = np.where(np.arange(2 * k) % 2, rng.uniform(1, 10),
                     rng.uniform(10, 60))
        polys = [c + r[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)]
    else:
        x, y = rng.randint(-10, w), rng.randint(-10, h)
        dx, dy = rng.randint(0, 40, 2)
        polys = [np.asarray([[x, y], [x + dx, y], [x + dx, y + dy],
                             [x, y + dy]], float)]
    return [np.round(p).astype(np.int32) for p in polys]


@pytest.mark.parametrize("kind", POLY_KINDS)
def test_fill_poly_equals_cv2(kind):
    rng = np.random.RandomState(POLY_KINDS.index(kind))
    for h, w in ((60, 80), (100, 130), (37, 23), (480, 640)):
        for _ in range(60 if h < 400 else 8):
            polys = polygons(rng, kind, h, w)
            want = np.zeros((h, w), np.uint8)
            cv2.fillPoly(want, polys, 1)
            got = np.zeros((h, w), np.uint8)
            mask_rle.fill_poly(got, polys, 1)
            np.testing.assert_array_equal(
                got, want, err_msg=f"{kind} {h}x{w}: "
                f"{[p.tolist() for p in polys]}")


def test_poly_to_rle_matches_jax():
    rng = np.random.RandomState(20)
    for _ in range(40):
        h, w = rng.randint(20, 200, 2)
        polys = [list(rng.uniform(-10, max(h, w) + 10, 2 * rng.randint(1, 9)))
                 for _ in range(rng.randint(1, 4))]
        # half-pixel vertices round half to even on both sides
        polys.append([10.5, 3.5, 30.5, 3.5, 20.5, 17.5])
        assert mask_rle.poly_to_rle(polys, h, w) == \
            jrle.poly_to_rle(polys, h, w)
        assert mask_rle.ann_to_rle(polys, h, w) == \
            jrle.ann_to_rle(polys, h, w)
    assert mask_rle.poly_to_rle([[1.0, 2.0, 3.0, 4.0]], 5, 6) == \
        jrle.poly_to_rle([[1.0, 2.0, 3.0, 4.0]], 5, 6)


@pytest.fixture(scope="module")
def jax_native():
    assert jnative.available(), "the JAX native library is the reference"
    assert native.available()
    return jnative


def paste_cases(rng, h, w, n):
    """Boxes of every paste geometry: upscale, downscale, the full frame,
    a corner, sub-pixel, past the edges, wholly outside, degenerate."""
    boxes = [np.asarray(b, np.float32) for b in (
        [10.3, 20.7, 60.2, 80.9], [5.0, 5.0, 15.0, 12.0],
        [0.0, 0.0, w - 1.0, h - 1.0], [w - 10.0, h - 10.0, w - 1.0, h - 1.0],
        [50.0, 50.0, 50.4, 50.4], [-20.5, -7.2, 40.1, 30.0],
        [w - 5.0, h - 30.0, w + 40.0, h + 12.5], [w + 3.0, 5.0, w + 30.0,
                                                  40.0],
        [30.0, 30.0, 29.5, 29.5], [30.0, 30.0, 29.0, 29.0])]
    for _ in range(n):
        x1, y1 = rng.uniform(-10, w - 5), rng.uniform(-10, h - 5)
        boxes.append(np.asarray([x1, y1, x1 + rng.uniform(1, w),
                                 y1 + rng.uniform(1, h)], np.float32))
    return boxes


def test_native_library_bitwise_equal_to_jax(jax_native):
    rng = np.random.RandomState(3)
    h, w = 100, 130
    for box in paste_cases(rng, h, w, 30):
        for prob in (rng.rand(28, 28).astype(np.float32),
                     (rng.rand(28, 28) > 0.5).astype(np.float32)):
            assert native.paste_rle(prob, box, h, w) == \
                jax_native.paste_rle(prob, box, h, w)
    for hp, wp, hh, ww in ((128, 256, 100, 130), (64, 64, 64, 64),
                           (192, 128, 130, 1)):
        for _ in range(6):
            packed = rng.randint(0, 256, (wp, hp // 8)).astype(np.uint8)
            packed[: wp // 3] = 0
            packed[wp // 2:wp // 2 + 3] = 255
            assert native.rle_encode_packed(packed, hh, ww) == \
                jax_native.rle_encode_packed(packed, hh, ww)
    with pytest.raises(ValueError):
        native.rle_encode_packed(np.zeros((8, 4), np.uint8), 8, 8)
    dts = [mask_rle.encode(m) for m in random_masks(rng, 9, 40, 30)]
    gts = [mask_rle.encode(m) for m in random_masks(rng, 7, 40, 30)]
    crowd = np.asarray([0, 1, 0, 0, 1, 0, 0], bool)
    got = native.rle_iou(dts, gts, crowd)
    np.testing.assert_array_equal(got, jax_native.rle_iou(dts, gts, crowd))
    np.testing.assert_array_equal(got, mask_rle.rle_iou(dts, gts, crowd))
    assert native.rle_iou([], gts, crowd).shape == (0, 7)


def unpack(packed: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.unpackbits(packed, axis=-1, bitorder="little")[:w, :h].T


def reversed_box(box) -> bool:
    """ceil(x2) < floor(x1) on an axis: no decoded box is (its width is
    exp(dw)·w > 0), and there the device paste (window clamped to one
    pixel) and the host pastes (empty window) differ in both packages."""
    return bool(np.ceil(box[2]) < np.floor(box[0])
                or np.ceil(box[3]) < np.floor(box[1]))


def test_pastes_against_jax_paste_mask(jax_native):
    rng = np.random.RandomState(4)
    h, w, hp, wp = 100, 130, 128, 256
    boxes = paste_cases(rng, h, w, 23)
    probs = rng.rand(len(boxes), 28, 28).astype(np.float32)
    packed = paste_masks(torch.from_numpy(probs[None]),
                         torch.from_numpy(np.stack(boxes)[None]), hp, wp,
                         chunk=5)[0].numpy()
    assert packed.shape == (len(boxes), wp, hp // 8)
    for r, box in enumerate(boxes):
        want = j_paste_mask(probs[r], box, h, w)
        host = paste_mask(probs[r], box, h, w)
        dev = unpack(packed[r], h, w)
        assert np.sum(host != want) <= FLIP_BOUND, (r, box)
        if not reversed_box(box):
            assert np.sum(dev != want) <= FLIP_BOUND, (r, box)
        counts = native.rle_encode_packed(packed[r], h, w)
        np.testing.assert_array_equal(
            mask_rle.decode({"size": [h, w], "counts": counts}), dev)
    # probabilities that no interpolation brings near 0.5 — all ones at
    # every box, and a step edge pasted at 1× and 2× (weights 0, 1/4, 3/4)
    # at integer origins — must paste exactly alike
    half = np.zeros((28, 28), np.float32)
    half[:, :14] = 1.0
    cases = [(np.ones((28, 28), np.float32), b) for b in boxes] + [
        (half, np.asarray(b, np.float32)) for b in (
            [0, 0, 27, 27], [30, 12, 57, 39], [3, 4, 58, 59],
            [-20, 50, 35, 105], [100, 7, 155, 62])]
    packed = paste_masks(
        torch.from_numpy(np.stack([c[0] for c in cases])[None]),
        torch.from_numpy(np.stack([c[1] for c in cases])[None]), hp,
        wp)[0].numpy()
    for r, (prob, box) in enumerate(cases):
        want = j_paste_mask(prob, box, h, w)
        np.testing.assert_array_equal(paste_mask(prob, box, h, w), want)
        if not reversed_box(box):
            np.testing.assert_array_equal(unpack(packed[r], h, w), want)
        np.testing.assert_array_equal(mask_rle.decode(
            {"size": [h, w],
             "counts": native.paste_rle(prob, box, h, w)}), want)
    with pytest.raises(ValueError):
        paste_masks(torch.zeros(1, 1, 28, 28), torch.zeros(1, 1, 4), 100, 64)


def segm_set(rng):
    """Annotations with polygon, count-list and compressed-string gt, a
    crowd RLE, two categories; results of RLE detections jittered from the
    gt or random, scores on a grid, ``area`` given on some."""
    images, anns, results = [], [], []
    for i in range(4):
        h, w = int(rng.randint(60, 160)), int(rng.randint(60, 160))
        images.append({"id": 7 + i, "file_name": f"{i}.jpg", "height": h,
                       "width": w})
        for j in range(int(rng.randint(1, 5))):
            cat = int(rng.choice([2, 9]))
            x, y = rng.uniform(0, w - 20), rng.uniform(0, h - 20)
            bw, bh = rng.uniform(8, w - x), rng.uniform(8, h - y)
            poly = [x, y, x + bw, y + rng.uniform(0, bh), x + bw * 0.6,
                    y + bh, x, y + bh * 0.7]
            rle = jrle.poly_to_rle([poly], h, w)
            seg = ([poly] if j % 3 == 0 else rle if j % 3 == 1 else
                   {"size": rle["size"],
                    "counts": jrle.counts_to_string(rle["counts"])})
            crowd = int(j == 3)
            if crowd:
                m = np.zeros((h, w), np.uint8)
                m[: h // 2, : w // 2] = 1
                seg = jrle.encode(m)
            anns.append({"id": len(anns) + 1, "image_id": 7 + i,
                         "category_id": cat, "segmentation": seg,
                         "area": float(jrle.area(jrle.ann_to_rle(seg, h, w))),
                         "bbox": [x, y, bw, bh], "iscrowd": crowd})
            for k in range(int(rng.randint(0, 3))):
                m = jrle.decode(jrle.ann_to_rle(seg, h, w))
                m = np.roll(m, (rng.randint(-4, 5), rng.randint(-4, 5)),
                            (0, 1))
                det = {"image_id": 7 + i, "category_id": cat,
                       "segmentation": jrle.encode(m),
                       "score": float(rng.randint(1, 11)) / 10}
                if k % 2:
                    det["area"] = float(m.sum())
                results.append(det)
        m = (rng.rand(h, w) < 0.1).astype(np.uint8)
        results.append({"image_id": 7 + i, "category_id": 9,
                        "segmentation": jrle.encode(m), "score": 0.35})
    return {"images": images, "annotations": anns, "categories": [
        {"id": 2, "name": "a"}, {"id": 9, "name": "b"}]}, results


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cocoeval_segm_bitwise_equal_to_jax(tmp_path, seed):
    ann, results = segm_set(np.random.RandomState(30 + seed))
    path = str(tmp_path / "ann.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    ev = COCOEval(path, results, iou_type="segm")
    jev = JCOCOEval(path, results, iou_type="segm")
    stats, jstats = ev.evaluate(), jev.evaluate()
    assert tuple(stats) == STAT_KEYS
    assert stats == jstats
    np.testing.assert_array_equal(ev.precision, jev.precision)
    np.testing.assert_array_equal(ev.recall, jev.recall)
    assert stats["AP"] > 0
    with pytest.raises(ValueError):
        COCOEval(path, [], iou_type="keypoints")


def test_segm_results_and_evaluate_sds_match_jax(tmp_path):
    rng = np.random.RandomState(40)
    ann, _ = segm_set(rng)
    root = tmp_path / "coco"
    (root / "annotations").mkdir(parents=True)
    with open(root / "annotations" / "instances_val2017.json", "w") as f:
        json.dump(ann, f)
    port = COCODataset("val2017", str(tmp_path / "p"), str(root))
    jax_ds = JCOCODataset("val2017", str(tmp_path / "j"), str(root))
    dets = [[None] * port.num_images for _ in range(port.num_classes)]
    masks = [[None] * port.num_images for _ in range(port.num_classes)]
    for k in range(1, port.num_classes):
        for i, im in enumerate(ann["images"]):
            n = int(rng.randint(0, 4))
            h, w = im["height"], im["width"]
            x1, y1 = rng.uniform(0, w / 2, n), rng.uniform(0, h / 2, n)
            d = np.stack([x1, y1, x1 + rng.uniform(5, w / 2, n),
                          y1 + rng.uniform(5, h / 2, n),
                          rng.rand(n)], 1).astype(np.float32)
            dets[k][i] = d
            if n and i != 2:   # image 2's rows have no masks
                masks[k][i] = [mask_rle.encode(m) for m in
                               random_masks(rng, n, h, w)]
    got = port.segmentations_to_coco(dets, masks)
    assert got == jax_ds.segmentations_to_coco(dets, masks)
    assert got and all(r["image_id"] != ann["images"][2]["id"] for r in got)
    out, jout = port.evaluate_sds(dets, masks), jax_ds.evaluate_sds(dets,
                                                                     masks)
    assert set(out) == {"bbox", "segm"}
    assert out == jout
