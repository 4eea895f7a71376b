"""The port's COCO reader (``mx_rcnn_tpu_torch/data/coco_dataset.py``)
against the JAX package's ``mx_rcnn_tpu/data/coco_dataset.py``, on the CPU.

Two sets: ``tests/fixtures.py:make_mini_coco`` (real JPEGs, sparse ids,
polygon segmentations) and a hand-written annotation file over images in
both orientations that holds what real COCO holds and the fixture does
not: crowd boxes, a zero-area box, boxes past the image edge, boxes
narrower or shorter than one pixel, an image without annotations,
annotations of images outside the set, sparse category ids out of order,
and an image with 110 non-crowd boxes (above ``MAX_GT``).  Tolerance:
none — class lists, image order, every ``gt_roidb`` field (flipped copies
too) and the results records equal, arrays of the same dtype bit for bit;
the cache file is the JAX package's, and each package reads the other's.
Also: ``get_imdb`` for ``--dataset coco``, the COCO preset against the
JAX one field by field, ``MAX_GT`` truncation in the loader against the
JAX loader, and the segm entry points against the JAX ones.
"""

import argparse
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data import loader as j_loader
from mx_rcnn_tpu.data.coco_dataset import COCODataset as JCOCODataset

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data import loader as t_loader
from mx_rcnn_tpu_torch.data.coco_dataset import COCODataset
from mx_rcnn_tpu_torch.tools.common import get_imdb
from tests.fixtures import make_mini_coco

# (h, w) of the hand-written set, both orientations, COCO's usual sizes
SIZES = ((480, 640), (640, 480), (375, 500), (640, 427), (333, 500))


def write_images(root, image_set, sizes, seed=0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    d = os.path.join(root, image_set)
    os.makedirs(d, exist_ok=True)
    names = []
    for i, (h, w) in enumerate(sizes):
        name = f"{i:012d}.jpg"
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
            os.path.join(d, name), quality=90)
        names.append(name)
    return names


@pytest.fixture(scope="module")
def hand_set(tmp_path_factory):
    """The hand-written set: ``{root}/val2017`` and its annotation file."""
    root = str(tmp_path_factory.mktemp("coco"))
    names = write_images(root, "val2017", SIZES)
    ids = [42, 7, 139, 285, 9]                # not in file order
    images = [{"id": i, "file_name": n, "height": h, "width": w}
              for i, n, (h, w) in zip(ids, names, SIZES)]
    cats = [{"id": c, "name": f"cat{c}"} for c in (90, 1, 18, 44, 3)]
    anns = []

    def ann(img, cat, bbox, area=None, crowd=0, seg=None):
        a = {"id": len(anns) + 1, "image_id": img, "category_id": cat,
             "bbox": [float(v) for v in bbox],
             "area": float(bbox[2] * bbox[3] if area is None else area),
             "iscrowd": crowd}
        if seg is not None:
            a["segmentation"] = seg
        anns.append(a)

    ann(42, 18, [10.5, 20.25, 100.0, 50.0],
        seg=[[10.5, 20.25, 110.5, 20.25, 110.5, 70.25]])
    ann(42, 1, [0, 0, 640, 480])                          # the whole image
    ann(42, 90, [600.0, 400.0, 100.0, 200.0])             # past both edges
    ann(42, 3, [-5.0, -3.0, 40.0, 30.0])                  # before the origin
    ann(42, 44, [50, 50, 300, 300], crowd=1,
        seg={"size": [480, 640], "counts": "abc"})        # crowd: skipped
    ann(42, 44, [60, 60, 10, 10], area=0.0)               # zero area
    ann(7, 1, [5.0, 5.0, 0.5, 30.0])                      # narrower than 1
    ann(7, 18, [5.0, 5.0, 30.0, 0.25])                    # shorter than 1
    ann(7, 90, [478.0, 10.0, 10.0, 10.0])                 # at the right edge
    ann(7, 90, [479.5, 10.0, 10.0, 10.0])                 # past it: x2 < x1
    ann(7, 3, [100.0, 600.0, 50.0, 80.0])                 # past the bottom
    ann(139, 44, [1, 1, 2, 2])
    # 285: no annotation at all; 9: 110 non-crowd boxes and a crowd one
    rng = np.random.RandomState(1)
    for _ in range(110):
        w, h = rng.randint(4, 80, 2)
        ann(9, int(rng.choice([1, 3, 18, 44, 90])),
            [float(rng.randint(0, 500 - w)), float(rng.randint(0, 333 - h)),
             float(w), float(h)])
    ann(9, 1, [0, 0, 100, 100], crowd=1)
    ann(12345, 1, [0, 0, 10, 10])                         # not in the set
    os.makedirs(os.path.join(root, "annotations"))
    with open(os.path.join(root, "annotations",
                           "instances_val2017.json"), "w") as f:
        json.dump({"images": images, "categories": cats,
                   "annotations": anns}, f)
    return root


@pytest.fixture(scope="module")
def mini_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini") / "coco")
    make_mini_coco(root, image_set="minitrain", n=5, seed=3)
    return root


def assert_records_equal(got, want):
    assert len(got) == len(want)
    for i, (r, s) in enumerate(zip(got, want)):
        assert set(r) == set(s), i
        for k in s:
            if isinstance(s[k], np.ndarray):
                assert r[k].dtype == s[k].dtype, (i, k)
                assert r[k].shape == s[k].shape, (i, k)
                np.testing.assert_array_equal(r[k], s[k], err_msg=f"{i} {k}")
            else:
                assert r[k] == s[k] and type(r[k]) is type(s[k]), (i, k)


def both(root, image_set, tmp_path):
    port = COCODataset(image_set, str(tmp_path / "port"), root)
    jax_ = JCOCODataset(image_set, str(tmp_path / "jax"), root)
    return port, jax_


@pytest.mark.parametrize("which", ["hand", "mini"])
def test_dataset_matches_jax(which, hand_set, mini_set, tmp_path):
    root, image_set = ((hand_set, "val2017") if which == "hand"
                       else (mini_set, "minitrain"))
    port, jax_ = both(root, image_set, tmp_path)
    assert port.name == jax_.name == f"coco_{image_set}"
    assert port.classes == jax_.classes
    assert port.num_classes == jax_.num_classes
    assert port.num_images == jax_.num_images
    assert port.image_ids == jax_.image_ids == sorted(port.image_ids)
    assert port.ann_file == jax_.ann_file
    assert [port.image_path(i) for i in range(port.num_images)] == \
        [jax_.image_path(i) for i in range(jax_.num_images)]
    roidb, jroidb = port.gt_roidb(), jax_.gt_roidb()
    assert_records_equal(roidb, jroidb)
    assert_records_equal(port.append_flipped_images(roidb),
                         jax_.append_flipped_images(jroidb))
    assert_records_equal(port.filter_roidb(roidb), jax_.filter_roidb(jroidb))


def test_hand_set_sanitisation(hand_set, tmp_path):
    """What the reference's sanitisation keeps of the hand-written set."""
    port, _ = both(hand_set, "val2017", tmp_path)
    assert port.classes == ["__background__", "cat1", "cat3", "cat18",
                            "cat44", "cat90"]
    assert port.image_ids == [7, 9, 42, 139, 285]
    roidb = port.gt_roidb()
    by_id = dict(zip(port.image_ids, roidb))
    r42 = by_id[42]
    # crowd and zero-area dropped; the rest clipped into 640×480
    np.testing.assert_array_equal(r42["boxes"], np.float32([
        [10.5, 20.25, 109.5, 69.25], [0, 0, 639, 479], [600, 400, 639, 479],
        [0, 0, 39, 29]]))
    assert r42["gt_classes"].tolist() == [3, 1, 5, 2]
    assert r42["segmentation"][0] == [[10.5, 20.25, 110.5, 20.25, 110.5,
                                       70.25]]
    assert r42["segmentation"][1:] == [None, None, None]
    assert (r42["width"], r42["height"]) == (640, 480)
    # bw, bh < 1 keep one pixel column/row; a box starting past the last
    # column (x1 > w − 1 after the clip) is dropped
    np.testing.assert_array_equal(by_id[7]["boxes"], np.float32([
        [5, 5, 5, 34], [5, 5, 34, 5], [478, 10, 479, 19],
        [100, 600, 149, 639]]))
    assert len(by_id[9]["boxes"]) == 110
    assert len(by_id[285]["boxes"]) == 0
    assert by_id[285]["max_overlaps"].shape == (0,)
    assert port.filter_roidb(roidb) == [r for r in roidb
                                        if r["image"] != by_id[285]["image"]]


def test_cache_is_shared_with_jax(hand_set, tmp_path):
    cache = str(tmp_path / "shared")
    jax_ = JCOCODataset("val2017", cache, hand_set)
    jroidb = jax_.gt_roidb()                       # the JAX package writes
    path = os.path.join(cache, "cache", "coco_val2017_gt_roidb.pkl")
    assert os.path.exists(path)
    port = COCODataset("val2017", cache, hand_set)
    with open(path, "rb") as f:
        on_disk = pickle.load(f)
    assert_records_equal(port.gt_roidb(), on_disk)  # the port reads it
    other = str(tmp_path / "other")
    assert_records_equal(COCODataset("val2017", other, hand_set).gt_roidb(),
                         jroidb)                   # the port writes
    assert os.listdir(os.path.join(other, "cache")) == [
        "coco_val2017_gt_roidb.pkl"]
    assert_records_equal(JCOCODataset("val2017", other, hand_set).gt_roidb(),
                         jroidb)                   # JAX reads the port's


def seeded_detections(rng, num_classes, num_images):
    """The ``all_boxes`` layout: None, empty and (N, 5) float32 rows."""
    dets = [[None] * num_images]
    for _ in range(1, num_classes):
        row = []
        for _ in range(num_images):
            n = rng.randint(0, 5)
            if n == 0:
                row.append(None if rng.rand() < 0.5
                           else np.zeros((0, 5), np.float32))
                continue
            xy = rng.uniform(0, 300, (n, 2))
            wh = rng.uniform(0, 200, (n, 2))
            row.append(np.hstack([xy, xy + wh, rng.rand(n, 1)]).astype(
                np.float32))
        dets.append(row)
    return dets


def test_detections_to_coco_and_scores_match_jax(hand_set, tmp_path):
    port, jax_ = both(hand_set, "val2017", tmp_path)
    dets = seeded_detections(np.random.RandomState(0), port.num_classes,
                             port.num_images)
    # some detections on the gt, so that the scores are not all zero
    for rec_i, rec in enumerate(port.gt_roidb()):
        for b, c in zip(rec["boxes"][:3], rec["gt_classes"][:3]):
            row = np.float32([[*b, 0.9]])
            old = dets[c][rec_i]
            dets[c][rec_i] = row if old is None else np.vstack([old, row])
    res, jres = port.detections_to_coco(dets), jax_.detections_to_coco(dets)
    assert res == jres and len(res) > 20
    assert {r["category_id"] for r in res} <= {1, 3, 18, 44, 90}
    r0 = next(r for r in res if r["score"] == np.float32(0.9))
    assert isinstance(r0["bbox"][0], float)
    stats = port.evaluate_detections(dets)
    assert stats == jax_.evaluate_detections(dets)
    assert 0.0 < stats["AP"] < 1.0


def test_get_imdb_for_coco(hand_set, tmp_path):
    cfg = generate_config("resnet101", "coco")
    cfg = cfg.replace(dataset=dataclasses.replace(
        cfg.dataset, DATASET_PATH=hand_set, IMAGE_SET="val2017",
        TEST_IMAGE_SET="val2017"))
    args = argparse.Namespace(synthetic=False, root_path=str(tmp_path))
    for test in (False, True):
        imdb = get_imdb(args, cfg, test=test)
        assert isinstance(imdb, COCODataset)
        assert imdb.name == "coco_val2017" and imdb.num_images == 5
    cfg = cfg.replace(dataset=dataclasses.replace(cfg.dataset,
                                                  TEST_IMAGE_SET="test-dev"))
    with pytest.raises(FileNotFoundError, match="instances_test-dev.json"):
        get_imdb(args, cfg, test=True)


def test_coco_preset_matches_jax():
    """Every field of the COCO preset equals the JAX one, but the port's
    documented ``tpu.PREFETCH`` (0: the prefetch thread measured slower on
    the card), which differs the same way for VOC."""
    def diff(dataset):
        j = dataclasses.asdict(j_generate_config("resnet101", dataset))
        p = dataclasses.asdict(generate_config("resnet101", dataset))
        assert set(j) == set(p)
        out = {}
        for sec in p:
            if not isinstance(p[sec], dict):
                if p[sec] != j[sec]:
                    out[sec] = (p[sec], j[sec])
                continue
            assert set(p[sec]) == set(j[sec]), sec
            out.update({(sec, k): (v, j[sec][k]) for k, v in p[sec].items()
                        if v != j[sec][k]})
        return out

    assert diff("coco") == diff("PascalVOC") == {("tpu", "PREFETCH"): (0, 2)}
    cfg = generate_config("resnet101", "coco")
    assert cfg.NUM_CLASSES == cfg.dataset.NUM_CLASSES == 81
    assert cfg.tpu.SCALES == ((800, 1333),)
    assert cfg.TRAIN.LR_STEP == (6,) and cfg.TRAIN.BATCH_ROIS == 128
    assert (cfg.dataset.IMAGE_SET, cfg.dataset.TEST_IMAGE_SET,
            cfg.dataset.DATASET_PATH) == ("train2017", "val2017", "data/coco")


def test_max_gt_truncation_matches_jax(hand_set, tmp_path):
    """Image 9 has 110 boxes: both loaders keep the first ``MAX_GT`` (100)
    and do not raise; every other record passes whole, portrait ones into
    the transposed bucket."""
    port, _ = both(hand_set, "val2017", tmp_path)
    roidb = port.append_flipped_images(port.gt_roidb())
    cfg = generate_config("resnet50", "coco", tpu__SCALES=((128, 192),))
    jcfg = j_generate_config("resnet50", "coco", tpu__SCALES=((128, 192),),
                             tpu__DEVICE_PREP=True)
    assert cfg.tpu.MAX_GT == jcfg.tpu.MAX_GT == 100
    shapes = set()
    for rec in roidb:
        scale = (128, 192)
        got = t_loader._load_record(rec, cfg, scale)
        want = j_loader._load_record(rec, jcfg, scale)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)
        n = min(len(rec["boxes"]), 100)
        assert int(got["gt_valid"].sum()) == n
        np.testing.assert_array_equal(got["gt_classes"][:n],
                                      rec["gt_classes"][:n])
        shapes.add(got["images"].shape)
    assert shapes == {(128, 192, 3), (192, 128, 3)}


def test_segm_entry_points_raise(hand_set, tmp_path):
    """The segm entry points (ported with the mask path) against the JAX
    ones on the hand set: ``segmentations_to_coco`` gives the same records
    (a row without its mask left out); ``evaluate_sds`` and
    ``evaluate_detections(iou_type="segm")`` raise the JAX package's
    ``KeyError`` there, the set's gt (and box records) having no
    ``segmentation``."""
    from mx_rcnn_tpu_torch.eval.mask_rle import encode

    port, jax_ = both(hand_set, "val2017", tmp_path)
    rng = np.random.RandomState(1)
    dets = seeded_detections(rng, port.num_classes, port.num_images)
    masks = [[None] * port.num_images for _ in dets]
    for k in range(1, port.num_classes):
        for i, d in enumerate(dets[k]):
            if d is None or not len(d) or i == 3:
                continue
            h, w = SIZES[i]
            masks[k][i] = [encode((rng.rand(h, w) < 0.01).astype(np.uint8))
                           for _ in range(len(d) - (k == 2))]
    got = port.segmentations_to_coco(dets, masks)
    assert got and got == jax_.segmentations_to_coco(dets, masks)
    for ds in (jax_, port):
        with pytest.raises(KeyError, match="segmentation"):
            ds.evaluate_sds(dets, masks)
        with pytest.raises(KeyError, match="segmentation"):
            ds.evaluate_detections(dets, iou_type="segm")
