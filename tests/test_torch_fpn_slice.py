"""The FPN / Mask R-CNN inference slice of the PyTorch port against the JAX
package, on the CPU: ``python -m mx_rcnn_tpu_torch.test --network
resnet101_fpn_mask --dataset coco --device cpu`` on a mini COCO set.

Config: ``tests/test_torch_fpn_model.py``'s tiny FPN (64×96 bucket,
``NETWORK="resnet50"``, ``FPN_ANCHOR_SCALES=(4,)``, TEST 250 → 32,
``PIXEL_STDS=127``, float32) on the ``resnet101_fpn_mask`` COCO preset (81
classes), ``TEST.MAX_PER_IMAGE=20``.  Weights: the port's seeded
``random_params``, ``cls_score`` scaled ×30 so that the class scores
spread (no near-ties at the cap), saved as ``.npz`` and read by both
packages.  Data: ``tests/fixtures.py:make_mini_coco`` (4 JPEGs, polygon
segmentations) under COCO's 80 category ids, plus a crowd RLE.

* the port's driver on the host route (``MASK_PASTE="native"``) and with
  ``--device-postprocess`` (which switches to the device paste), each
  serial (``--eval-inflight 0``) and overlapped, against the JAX
  ``pred_eval(with_masks=True)`` on its device-prep path on the same
  route (serial: the JAX overlapped mask pass shares one encode buffer
  between its threads): per image and class the same detection count,
  scores within 1e-5, boxes within 1e-3 px, each RLE within 3 pixels of
  the JAX one, the box and segm stats within 1e-6; the overlapped loop
  bit-identical to the serial one;
* the three ``MASK_PASTE`` modes on the host route: the same detections
  bitwise, masks within 3 pixels of each other;
* the pyramid cache: a token of an earlier batch raises, a captured
  pyramid gives the cached masks, ``predict_masks`` from the images too.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data.coco_dataset import COCODataset as JCOCODataset
from mx_rcnn_tpu.data.loader import TestLoader as JTestLoader
from mx_rcnn_tpu.eval import Predictor as JPredictor
from mx_rcnn_tpu.eval import pred_eval as j_pred_eval
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.train.checkpoint import load_params_npz as j_load_params_npz

from mx_rcnn_tpu_torch import test as test_driver
from mx_rcnn_tpu_torch.data.coco_dataset import COCODataset
from mx_rcnn_tpu_torch.data.loader import TestLoader
from mx_rcnn_tpu_torch.eval.mask_rle import decode, encode
from mx_rcnn_tpu_torch.eval.tester import Predictor
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.tools.common import config_from_args
from mx_rcnn_tpu_torch.train.checkpoint import epoch_path, save_params_npz
from mx_rcnn_tpu_torch.utils.convert_jax import random_params
from tests.fixtures import make_mini_coco

torch.set_num_threads(2)

BATCH = 2
SCALE = (64, 96)
MAX_PER_IMAGE = 20
SCORE_ATOL, BOX_ATOL, STAT_ATOL, FLIP_BOUND = 1e-5, 1e-3, 1e-6, 3
COCO_IDS = tuple(i for i in range(1, 91)
                 if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
TINY = ["--network", "resnet101_fpn_mask", "--dataset", "coco",
        "--cfg", f"tpu__SCALES=({SCALE},)",
        "--cfg", "network__NETWORK='resnet50'",
        "--cfg", "network__FPN_ANCHOR_SCALES=(4,)",
        "--cfg", "network__PIXEL_STDS=(127.0,127.0,127.0)",
        "--cfg", "tpu__COMPUTE_DTYPE='float32'",
        "--cfg", "TEST__RPN_PRE_NMS_TOP_N=250",
        "--cfg", "TEST__RPN_POST_NMS_TOP_N=32",
        "--cfg", f"TEST__MAX_PER_IMAGE={MAX_PER_IMAGE}"]


def write_set(root: str) -> str:
    """make_mini_coco's 4 images under COCO's 80 ids (the fixture's 1, 4
    and 7 among them), and one crowd RLE on the first image."""
    path = make_mini_coco(root, image_set="minival", n=4)
    with open(path) as f:
        ann = json.load(f)
    names = {c["id"]: c["name"] for c in ann["categories"]}
    ann["categories"] = [{"id": i, "name": names.get(i, f"c{i}")}
                         for i in COCO_IDS]
    im = ann["images"][0]
    m = np.zeros((im["height"], im["width"]), np.uint8)
    m[5:40, 10:70] = 1
    ann["annotations"].append({
        "id": len(ann["annotations"]) + 1, "image_id": im["id"],
        "category_id": 1, "bbox": [10.0, 5.0, 60.0, 35.0],
        "area": float(m.sum()), "iscrowd": 1, "segmentation": encode(m)})
    with open(path, "w") as f:
        json.dump(ann, f)
    return root


def jax_cfg(paste: str):
    cfg = j_generate_config("resnet101_fpn_mask", "coco",
                            TEST__RPN_PRE_NMS_TOP_N=250,
                            TEST__RPN_POST_NMS_TOP_N=32,
                            TEST__MAX_PER_IMAGE=MAX_PER_IMAGE,
                            TEST__MASK_PASTE=paste, tpu__DEVICE_PREP=True)
    net = dataclasses.replace(cfg.network, NETWORK="resnet50",
                              FPN_ANCHOR_SCALES=(4,),
                              PIXEL_STDS=(127.0, 127.0, 127.0))
    tpu = dataclasses.replace(cfg.tpu, SCALES=(SCALE,),
                              COMPUTE_DTYPE="float32")
    return cfg.replace(network=net, tpu=tpu)


class JCapture(JCOCODataset):
    def evaluate_sds(self, detections, masks):
        self.captured = (detections, masks)
        return super().evaluate_sds(detections, masks)


def run_driver(argv):
    """The port's test driver, ``evaluate_sds``'s inputs recorded →
    (stats, all_boxes, all_masks)."""
    seen = []
    orig = COCODataset.evaluate_sds

    def record(self, detections, masks):
        seen.append((detections, masks))
        return orig(self, detections, masks)

    COCODataset.evaluate_sds = record
    try:
        stats = test_driver.test_rcnn(test_driver.parse_args(argv))
    finally:
        COCODataset.evaluate_sds = orig
    (boxes, masks), = seen
    return stats, boxes, masks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fpnslice")
    coco = write_set(str(root / "coco"))
    paths = ["--image_set", "minival", "--root_path", str(root / "data"),
             "--dataset_path", coco]
    prefix = str(root / "model" / "mask")
    cfg = config_from_args(test_driver.parse_args(TINY + paths), train=False)
    assert (cfg.NUM_CLASSES, cfg.network.HAS_MASK) == (81, True)
    params = random_params(build_model(cfg), seed=3)
    params["rcnn_out/cls_score/kernel"] *= 30.0
    save_params_npz(epoch_path(prefix, 1), params)

    out = {"cfg": cfg, "paths": paths, "prefix": prefix, "coco": coco}
    jparams = j_load_params_npz(epoch_path(prefix, 1))
    for route, paste in (("host", "native"), ("device", "device")):
        jcfg = jax_cfg(paste)
        jimdb = JCapture("minival", str(root / "jax"), coco)
        stats = j_pred_eval(
            JPredictor(j_build_model(jcfg), jparams, jcfg),
            JTestLoader(jimdb.gt_roidb(), jcfg, batch_size=BATCH,
                        device_prep=True),
            jimdb, with_masks=True, inflight=0,
            device_postprocess=route == "device")
        out["jax", route] = (stats, *jimdb.captured)
    base = TINY + paths + ["--prefix", prefix, "--epoch", "1", "--device",
                           "cpu", "--batch_images", str(BATCH)]
    for route, extra in (("host", []), ("device", ["--device-postprocess"])):
        for loop, inflight in (("serial", "0"), ("pipelined", "2")):
            out["port", route, loop] = run_driver(
                base + extra + ["--eval-inflight", inflight])
    for paste in ("host", "device"):
        out["paste", paste] = run_driver(
            base + ["--eval-inflight", "0", "--cfg",
                    f"TEST__MASK_PASTE='{paste}'"])
    return out


def mask_diff(a, b) -> int:
    assert a["size"] == b["size"]
    return int(np.sum(decode(a) != decode(b)))


@pytest.mark.parametrize("route", ["host", "device"])
def test_driver_matches_jax_pred_eval_with_masks(runs, route):
    jstats, jboxes, jmasks = runs["jax", route]
    stats, boxes, masks = runs["port", route, "serial"]
    assert len(boxes) == 81
    n_masks = 0
    for k in range(1, 81):
        for i in range(4):
            got, want = boxes[k][i], jboxes[k][i]
            msg = f"class {k} image {i}"
            assert got.shape == want.shape, msg
            np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0,
                                       atol=SCORE_ATOL, err_msg=msg)
            np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0,
                                       atol=BOX_ATOL, err_msg=msg)
            assert (masks[k][i] is None) == (jmasks[k][i] is None), msg
            for a, b in zip(masks[k][i] or [], jmasks[k][i] or []):
                assert mask_diff(a, b) <= FLIP_BOUND, msg
                n_masks += 1
    assert n_masks > 20, "the tiny model must give masks to compare"
    assert set(stats) == {"bbox", "segm", "eval_pipeline"}
    for kind in ("bbox", "segm"):
        assert set(stats[kind]) == set(jstats[kind])
        for key, v in jstats[kind].items():
            assert abs(stats[kind][key] - v) <= STAT_ATOL, (kind, key)
    pipe = stats["eval_pipeline"]
    assert pipe["mode"] == ("serial+devpost" if route == "device"
                            else "serial")
    assert pipe["mask_pass_s"] > 0


@pytest.mark.parametrize("route", ["host", "device"])
def test_overlapped_loop_is_bit_identical(runs, route):
    s_stats, s_boxes, s_masks = runs["port", route, "serial"]
    p_stats, p_boxes, p_masks = runs["port", route, "pipelined"]
    for k in range(1, 81):
        for i in range(4):
            np.testing.assert_array_equal(p_boxes[k][i], s_boxes[k][i])
            assert p_masks[k][i] == s_masks[k][i]
    for kind in ("bbox", "segm"):
        assert p_stats[kind] == s_stats[kind]
    assert p_stats["eval_pipeline"]["mode"].startswith("pipelined")


def test_mask_paste_modes_agree(runs):
    _, boxes, native_masks = runs["port", "host", "serial"]
    n = 0
    for paste in ("host", "device"):
        _, pboxes, pmasks = runs["paste", paste]
        for k in range(1, 81):
            for i in range(4):
                np.testing.assert_array_equal(pboxes[k][i], boxes[k][i])
                for a, b in zip(pmasks[k][i] or [], native_masks[k][i] or []):
                    assert mask_diff(a, b) <= FLIP_BOUND, (paste, k, i)
                    n += 1
    assert n > 40


def test_pyramid_cache_token(runs):
    cfg = runs["cfg"]
    pred = Predictor(build_model(cfg), epoch_path(runs["prefix"], 1), cfg,
                     device="cpu")
    imdb = COCODataset("minival", os.path.dirname(runs["coco"]) + "/t",
                       runs["coco"])
    loader = TestLoader(imdb.gt_roidb(), cfg, batch_size=BATCH)
    loader.put = pred.batch_put
    first, second = list(loader)[:2]
    boxes = np.tile(np.asarray([[4, 6, 40, 30], [10, 2, 60, 50]],
                               np.float32), (BATCH, 1, 1))
    labels = np.asarray([[1, 7]] * BATCH)
    pred.predict(first["images"], first["im_info"])
    feats, token = pred.capture_feats()
    assert token == pred.feats_token
    want = pred.predict_masks_cached(boxes, labels, token)
    pred.predict(second["images"], second["im_info"])
    with pytest.raises(AssertionError, match="stale pyramid cache"):
        pred.predict_masks_cached(boxes, labels, token)
    again = pred.predict_masks_cached(boxes, labels, None, feats=feats)
    assert torch.equal(again, want)
    direct = pred.predict_masks(first["images"], first["im_info"], boxes,
                                labels)
    assert torch.equal(direct, want)
    assert want.shape == (BATCH, 2, 28, 28)
