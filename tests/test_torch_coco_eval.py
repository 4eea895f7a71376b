"""The port's COCO box evaluation (``mx_rcnn_tpu_torch/eval/coco_eval.py``)
against the JAX package's ``mx_rcnn_tpu/eval/coco_eval.py``, on the CPU.

Both are float64 numpy running the same arithmetic in the same order, so
the tolerance is none: the 12 stats and the whole ``precision`` (T, R, K,
A, M) and ``recall`` (T, K, A, M) arrays must be equal bit for bit, on
seeded annotation/result sets that cover crowd gt, ``ignore`` flags, all
four area ranges, exact score ties, more than 100 detections per (image,
category), gt without detections and the reverse, and a category with no
gt; on sets drawn by ``hypothesis``; and on the five protocol cases of
``tests/test_coco_eval.py``, whose own assertions are kept.  The segm
route's parity is in ``tests/test_torch_mask_eval.py``; here it raises on
gt without masks as the JAX one does.
"""

import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mx_rcnn_tpu.eval.coco_eval import COCOEval as JCOCOEval
from mx_rcnn_tpu.eval.coco_eval import bbox_iou_xywh as j_bbox_iou_xywh

from mx_rcnn_tpu_torch.eval import coco_eval
from mx_rcnn_tpu_torch.eval.coco_eval import COCOEval, bbox_iou_xywh

STAT_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
             "AR100", "ARs", "ARm", "ARl")


def write_ann(path, ann) -> str:
    with open(path, "w") as f:
        json.dump(ann, f)
    return str(path)


def both(ann_file: str, results: list):
    """Port and JAX evaluations of the same results: stats, precision and
    recall equal bit for bit.  Returns the port's stats."""
    ev, jev = COCOEval(ann_file, results), JCOCOEval(ann_file, results)
    stats, jstats = ev.evaluate(), jev.evaluate()
    assert tuple(stats) == STAT_KEYS
    assert stats == jstats
    np.testing.assert_array_equal(ev.precision, jev.precision)
    np.testing.assert_array_equal(ev.recall, jev.recall)
    assert ev.precision.dtype == ev.recall.dtype == np.float64
    return stats


def seeded_set(rng, n_images=6, cat_ids=(1, 3, 7, 90), n_many=130,
               n_gt=(0, 8), n_det=(0, 25)):
    """An annotation dict and a results list drawn from ``rng``: boxes of
    every area range (side 4..400 px), ~10% crowd and ~10% ``ignore`` gt,
    detections jittered from gt or placed at random, scores on a coarse
    grid (exact ties), one (image, category) with ``n_many`` detections,
    the last category without gt, an image id with detections only in the
    results (not in the set) and images whose gt get no detection."""
    images = [{"id": 10 + 3 * i, "file_name": f"{i}.jpg",
               "height": int(rng.randint(200, 700)),
               "width": int(rng.randint(200, 700))} for i in range(n_images)]
    cats = [{"id": c, "name": f"c{c}"} for c in cat_ids]
    anns, results = [], []
    aid = 1

    def box(im):
        side = float(np.exp(rng.uniform(np.log(4), np.log(400))))
        bw = min(side * rng.uniform(0.5, 1.5), im["width"] - 1)
        bh = min(side * rng.uniform(0.5, 1.5), im["height"] - 1)
        x = rng.uniform(0, im["width"] - bw)
        y = rng.uniform(0, im["height"] - bh)
        return [float(x), float(y), float(bw), float(bh)]

    def score():
        return float(rng.randint(1, 21)) / 20.0   # a grid: exact ties

    for im in images:
        for c in cat_ids[:-1]:                    # the last: no gt at all
            for _ in range(rng.randint(*n_gt)):
                b = box(im)
                a = {"id": aid, "image_id": im["id"], "category_id": c,
                     "bbox": b, "area": b[2] * b[3] * rng.uniform(0.7, 1.0),
                     "iscrowd": int(rng.rand() < 0.1)}
                if rng.rand() < 0.1:
                    a["ignore"] = 1
                anns.append(a)
                aid += 1
                if rng.rand() < 0.7:              # a jittered detection
                    j = np.asarray(b) + rng.normal(0, 0.08, 4) * (b[2:] * 2)
                    results.append({"image_id": im["id"], "category_id": c,
                                    "bbox": [float(v) for v in j],
                                    "score": score()})
        if im is images[-1]:
            continue                              # its gt get no detection
        for c in cat_ids:
            for _ in range(rng.randint(*n_det)):
                results.append({"image_id": im["id"], "category_id": c,
                                "bbox": box(im), "score": score()})
    if len(anns) >= 2:                            # at least one of each
        anns[0]["iscrowd"], anns[1]["ignore"] = 1, 1
    im0, c0 = images[0], cat_ids[0]
    for _ in range(n_many):
        results.append({"image_id": im0["id"], "category_id": c0,
                        "bbox": box(im0), "score": score()})
    results.append({"image_id": 999, "category_id": c0,
                    "bbox": [1.0, 1.0, 5.0, 5.0], "score": 0.5})
    return {"images": images, "categories": cats, "annotations": anns}, \
        results


def test_bbox_iou_xywh_matches_jax(rng):
    dt = rng.uniform(0, 50, (7, 4))
    gt = rng.uniform(0, 50, (5, 4))
    gt[2] = dt[3]                                  # one exact overlap
    crowd = np.array([0, 1, 0, 1, 0], bool)
    got = bbox_iou_xywh(dt, gt, crowd)
    np.testing.assert_array_equal(got, j_bbox_iou_xywh(dt, gt, crowd))
    assert abs(got[3, 2] - 1.0) < 1e-12
    # crowd: intersection over the detection's area
    inter = got[:, 1] * dt[:, 2] * dt[:, 3]
    assert np.all(got[:, 1] <= 1.0) and np.all(inter >= 0)
    assert bbox_iou_xywh(dt[:0], gt, crowd).shape == (0, 5)
    assert bbox_iou_xywh(dt, gt[:0], crowd[:0]).shape == (7, 0)


def test_protocol_constants_match_jax():
    from mx_rcnn_tpu.eval import coco_eval as jce

    np.testing.assert_array_equal(coco_eval.IOU_THRS, jce.IOU_THRS)
    np.testing.assert_array_equal(coco_eval.REC_THRS, jce.REC_THRS)
    assert coco_eval.AREA_RNGS == jce.AREA_RNGS
    assert coco_eval.MAX_DETS == jce.MAX_DETS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_sets_match_jax(tmp_path, seed):
    ann, results = seeded_set(np.random.RandomState(seed))
    # the set really covers what the docstring claims
    by_cat = {}
    for r in results:
        by_cat.setdefault((r["image_id"], r["category_id"]), []).append(r)
    assert max(len(v) for v in by_cat.values()) > 100
    scores = [r["score"] for r in results]
    assert len(set(scores)) < len(scores)
    areas = [a["area"] for a in ann["annotations"]]
    assert min(areas) < 32 ** 2 and max(areas) > 96 ** 2
    assert any(32 ** 2 < a < 96 ** 2 for a in areas)
    assert any(a["iscrowd"] for a in ann["annotations"])
    assert any(a.get("ignore") for a in ann["annotations"])
    stats = both(write_ann(tmp_path / "ann.json", ann), results)
    assert 0.0 < stats["AP50"] <= 1.0


def test_shuffled_results_and_img_ids_match_jax(tmp_path):
    """The stable sort within an (image, category) and the mergesort
    across images decide the order of tied scores: the input order of the
    results must reach both alike, and both score every image of the
    annotation file, in id order."""
    rng = np.random.RandomState(5)
    ann, results = seeded_set(rng, n_det=(3, 12))
    path = write_ann(tmp_path / "ann.json", ann)
    shuffled = [results[i] for i in rng.permutation(len(results))]
    both(path, shuffled)
    ev, jev = COCOEval(path, shuffled), JCOCOEval(path, shuffled)
    assert ev.img_ids == jev.img_ids == sorted(
        im["id"] for im in ann["images"])


def test_empty_results_and_no_gt(tmp_path):
    ann, results = seeded_set(np.random.RandomState(3))
    path = write_ann(tmp_path / "ann.json", ann)
    stats = both(path, [])
    assert stats["AP"] == 0.0 and stats["AR100"] == 0.0
    empty = dict(ann, annotations=[])
    stats = both(write_ann(tmp_path / "empty.json", empty), results)
    assert all(v == -1.0 for v in stats.values())


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n_images=st.integers(1, 4),
       n_cats=st.integers(1, 3), n_many=st.integers(0, 120))
def test_random_sets_match_jax(tmp_path_factory, seed, n_images, n_cats,
                               n_many):
    rng = np.random.RandomState(seed)
    cat_ids = tuple(sorted(rng.choice(np.arange(1, 91), n_cats + 1,
                                      replace=False).tolist()))
    ann, results = seeded_set(rng, n_images=n_images, cat_ids=cat_ids,
                              n_many=n_many, n_gt=(0, 5), n_det=(0, 8))
    path = write_ann(tmp_path_factory.mktemp("h") / "ann.json", ann)
    both(path, results)


# --- tests/test_coco_eval.py's protocol cases, against the port -------------

TINY_ANN = {
    "images": [{"id": 1, "file_name": "a.jpg", "height": 200, "width": 200},
               {"id": 2, "file_name": "b.jpg", "height": 200, "width": 200}],
    "categories": [{"id": 1, "name": "cat"}, {"id": 2, "name": "dog"}],
    "annotations": [
        {"id": 1, "image_id": 1, "category_id": 1,
         "bbox": [10, 10, 20, 20], "area": 400, "iscrowd": 0},
        {"id": 2, "image_id": 1, "category_id": 2,
         "bbox": [50, 50, 60, 60], "area": 3600, "iscrowd": 0},
        {"id": 3, "image_id": 2, "category_id": 1,
         "bbox": [0, 0, 100, 100], "area": 10000, "iscrowd": 0},
    ],
}
CROWD_ANN = {
    "images": [{"id": 1, "file_name": "a.jpg", "height": 100, "width": 100}],
    "categories": [{"id": 1, "name": "cat"}],
    "annotations": [
        {"id": 1, "image_id": 1, "category_id": 1,
         "bbox": [0, 0, 50, 50], "area": 2500, "iscrowd": 1},
        {"id": 2, "image_id": 1, "category_id": 1,
         "bbox": [60, 60, 20, 20], "area": 400, "iscrowd": 0},
    ],
}


def _det(img, cat, bbox, score):
    return {"image_id": img, "category_id": cat, "bbox": bbox, "score": score}


def _perfect(s):
    assert np.isclose(s["AP"], 1.0) and np.isclose(s["AP50"], 1.0)
    assert np.isclose(s["AR100"], 1.0)


def _miss_and_fp(s):
    assert 0.0 < s["AP"] < 1.0 and 0.4 < s["AP50"] < 0.6


def _loose(s):
    assert np.isclose(s["AP50"], 1.0) and s["AP75"] < 1.0
    assert 0.5 < s["AP"] < 1.0


def _crowd(s):
    assert np.isclose(s["AP"], 1.0)


def _areas(s):
    assert np.isclose(s["APs"], 1.0) and np.isclose(s["APm"], 1.0)
    assert np.isclose(s["APl"], 1.0)


PROTOCOL_CASES = {
    "perfect": (TINY_ANN, [_det(1, 1, [10, 10, 20, 20], 0.9),
                           _det(1, 2, [50, 50, 60, 60], 0.8),
                           _det(2, 1, [0, 0, 100, 100], 0.95)], _perfect),
    "miss_and_fp": (TINY_ANN, [_det(1, 1, [10, 10, 20, 20], 0.9),
                               _det(1, 2, [150, 150, 20, 20], 0.99),
                               _det(1, 2, [50, 50, 60, 60], 0.8)],
                    _miss_and_fp),
    "loose_box_only_counts_at_low_iou": (
        TINY_ANN, [_det(1, 1, [12, 12, 20, 20], 0.9),
                   _det(1, 2, [50, 50, 60, 60], 0.8),
                   _det(2, 1, [0, 0, 100, 100], 0.95)], _loose),
    "crowd_not_counted": (CROWD_ANN, [_det(1, 1, [10, 10, 30, 30], 0.9),
                                      _det(1, 1, [60, 60, 20, 20], 0.8)],
                          _crowd),
    "area_breakdown": (TINY_ANN, [_det(1, 1, [10, 10, 20, 20], 0.9),
                                  _det(1, 2, [50, 50, 60, 60], 0.8),
                                  _det(2, 1, [0, 0, 100, 100], 0.95)],
                       _areas),
}


@pytest.mark.parametrize("case", list(PROTOCOL_CASES))
def test_protocol_case_matches_jax(tmp_path, case):
    ann, results, check = PROTOCOL_CASES[case]
    check(both(write_ann(tmp_path / "ann.json", ann), results))


def test_real_match_kept_over_an_ignored_gt(tmp_path):
    """With a real match in hand, matching stops where the ignored gt
    begin (pycocotools' break): the detection stays a true positive of
    the gt it overlaps at 0.82, though an ignored gt overlaps it at 1.0;
    above 0.82 it falls to the ignored gt and is neither TP nor FP."""
    ann = {"images": [{"id": 1, "file_name": "a.jpg", "height": 100,
                       "width": 100}],
           "categories": [{"id": 1, "name": "cat"}],
           "annotations": [
               {"id": 1, "image_id": 1, "category_id": 1,
                "bbox": [10, 10, 40, 40], "area": 1600, "iscrowd": 0},
               {"id": 2, "image_id": 1, "category_id": 1, "ignore": 1,
                "bbox": [12, 12, 40, 40], "area": 1600, "iscrowd": 0}]}
    stats = both(write_ann(tmp_path / "ann.json", ann),
                 [_det(1, 1, [12, 12, 40, 40], 0.9)])
    assert stats["AP50"] == 1.0 and stats["AP75"] == 1.0
    assert stats["AP"] == pytest.approx(0.7)     # 7 of the 10 thresholds


def test_segm_mode_raises(tmp_path):
    """``iou_type="segm"`` (ported with the mask path) on a set whose gt
    have no ``segmentation``: with box records or none, ``evaluate`` raises
    the JAX package's ``KeyError``; another ``iou_type`` is a
    ``ValueError``."""
    path = write_ann(tmp_path / "ann.json", CROWD_ANN)
    for results in ([], [_det(1, 1, [12, 12, 40, 40], 0.9)]):
        for cls in (COCOEval, JCOCOEval):
            ev = cls(path, results, iou_type="segm")
            with pytest.raises(KeyError, match="segmentation"):
                ev.evaluate()
    with pytest.raises(ValueError):
        COCOEval(path, [], iou_type="keypoints")
