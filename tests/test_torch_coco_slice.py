"""The COCO slice of the PyTorch port against the JAX package, on the CPU:
``--dataset coco`` through training, evaluation, re-scoring, the demo and
serving, at the COCO preset's 81 classes.

Config: ``tests/test_torch_eval_slice.py``'s tiny ResNet-50 (bucket
128×192, ``ANCHOR_SCALES=(2, 4)``, float32 compute, ``PIXEL_STDS=127``)
on the COCO preset, with ``TEST.MAX_PER_IMAGE`` cut to 20 so that the
plain NMS of the device route (B·80 rows on the CPU) stays short.  Data:
``tests/fixtures.py:make_mini_coco`` JPEGs, each split landscape and
portrait images (``minitrain`` 4, ``minival`` 4).  One module-scoped
fixture trains the model with the port's ``train_end2end --dataset coco
--device cpu`` for 2 steps; every case shares that checkpoint.

* ``pred_eval`` of both packages on ``minival`` on the host and the device
  route, the JAX side on its device-prep path (the port preps on the
  device, as the serve tests hold it): per image and class the same
  detection count, scores within 1e-5 and boxes within 1e-3 px (the eval
  slice's tolerances), the 12 COCO stats within 1e-6;
* the port's host route runs through its ``test`` driver (serial loop):
  the 12 keys, no ``KeyError`` in its log line; ``tools/reeval`` on its
  detections cache gives the same stats; on a VOC devkit the driver still
  returns ``mAP``;
* ``demo --device cpu`` against the JAX ``demo.py:demo_net``'s loop on the
  JAX device-prep route (the image paired with itself at batch 2): the
  same detections in order, within the same tolerances;
* one served batch in each mode at 81 classes against the port's offline
  ``Predictor`` path on the same two images: equal records (scores within
  1e-6, boxes within 1e-3 px), row by row.
"""

import dataclasses
import json
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data.coco_dataset import COCODataset as JCOCODataset
from mx_rcnn_tpu.data.image import get_image as j_get_image
from mx_rcnn_tpu.data.image import stage_raw_to_bucket as j_stage
from mx_rcnn_tpu.data.loader import TestLoader as JTestLoader
from mx_rcnn_tpu.eval import Predictor as JPredictor
from mx_rcnn_tpu.eval import pred_eval as j_pred_eval
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.native import nms as j_nms
from mx_rcnn_tpu.ops import postprocess as jpost
from mx_rcnn_tpu.train.checkpoint import load_params_npz as j_load_params_npz

from mx_rcnn_tpu_torch import demo
from mx_rcnn_tpu_torch import test as test_driver
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data.coco_dataset import COCODataset
from mx_rcnn_tpu_torch.data.image import stage_raw_to_bucket
from mx_rcnn_tpu_torch.data.loader import TestLoader
from mx_rcnn_tpu_torch.eval.tester import Predictor, im_detect, pred_eval
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.ops import postprocess as post
from mx_rcnn_tpu_torch.serve import ServeEngine, ServeOptions
from mx_rcnn_tpu_torch.tools import reeval
from mx_rcnn_tpu_torch.tools.common import config_from_args
from mx_rcnn_tpu_torch.train.checkpoint import epoch_path, save_params_npz
from mx_rcnn_tpu_torch.utils.convert_jax import random_params
from tests.fixtures import make_mini_coco, make_mini_voc

torch.set_num_threads(2)

BATCH = 2
SCALE = (128, 192)
MAX_PER_IMAGE = 20
SCORE_ATOL, BOX_ATOL, STAT_ATOL = 1e-5, 1e-3, 1e-6
# COCO's 80 sparse category ids
COCO_IDS = tuple(i for i in range(1, 91)
                 if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
STAT_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
             "AR100", "ARs", "ARm", "ARl")
TINY = ["--network", "resnet50", "--cfg", f"tpu__SCALES=({SCALE},)",
        "--cfg", "tpu__MAX_GT=8", "--cfg", "network__ANCHOR_SCALES=(2,4)",
        "--cfg", "network__PIXEL_STDS=(127.0,127.0,127.0)",
        "--cfg", "tpu__COMPUTE_DTYPE='float32'",
        "--cfg", "TEST__RPN_PRE_NMS_TOP_N=300",
        "--cfg", "TEST__RPN_POST_NMS_TOP_N=50",
        "--cfg", f"TEST__MAX_PER_IMAGE={MAX_PER_IMAGE}"]
COCO = TINY + ["--dataset", "coco"]
TRAIN = ["--image_set", "minitrain", "--num-steps", "2", "--end_epoch", "1",
         "--cfg", "TRAIN__BATCH_IMAGES=2",
         "--cfg", "TRAIN__RPN_PRE_NMS_TOP_N=200",
         "--cfg", "TRAIN__RPN_POST_NMS_TOP_N=32",
         "--cfg", "TRAIN__BATCH_ROIS=16"]


def tiny(gen, **kw):
    cfg = gen("resnet50", "coco", TEST__RPN_PRE_NMS_TOP_N=300,
              TEST__RPN_POST_NMS_TOP_N=50, TEST__MAX_PER_IMAGE=MAX_PER_IMAGE,
              **kw)
    net = dataclasses.replace(cfg.network, ANCHOR_SCALES=(2, 4),
                              PIXEL_STDS=(127.0, 127.0, 127.0))
    tpu = dataclasses.replace(cfg.tpu, SCALES=(SCALE,), MAX_GT=8,
                              COMPUTE_DTYPE="float32")
    return cfg.replace(network=net, tpu=tpu)


def mini_coco_split(root, split, n_land, n_port, seed):
    """``make_mini_coco``'s landscape (120×160) and portrait (160×120)
    images merged into one split, landscape first, ids renumbered, under
    COCO's 80 category ids (the fixture's three, 1, 4 and 7, among them),
    so that the dataset has the config's 81 classes."""
    ann = {"images": [], "annotations": [], "categories": None}
    os.makedirs(os.path.join(root, split))
    for part, (n, size) in enumerate(((n_land, (120, 160)),
                                      (n_port, (160, 120)))):
        tmp = os.path.join(root, f"_{split}{part}")
        with open(make_mini_coco(tmp, image_set="s", n=n, size=size,
                                 seed=seed + part)) as f:
            a = json.load(f)
        off = len(ann["images"])
        for im in a["images"]:
            name = f"{im['id'] + off:012d}.jpg"
            shutil.copyfile(os.path.join(tmp, "s", im["file_name"]),
                            os.path.join(root, split, name))
            ann["images"].append(dict(im, id=im["id"] + off, file_name=name))
        n_ann = len(ann["annotations"])
        ann["annotations"] += [dict(x, id=x["id"] + n_ann,
                                    image_id=x["image_id"] + off)
                               for x in a["annotations"]]
        names = {c["id"]: c["name"] for c in a["categories"]}
        ann["categories"] = [{"id": i, "name": names.get(i, f"c{i}")}
                             for i in COCO_IDS]
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    with open(os.path.join(root, "annotations",
                           f"instances_{split}.json"), "w") as f:
        json.dump(ann, f)


def read(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from mx_rcnn_tpu_torch import train_end2end

    root = tmp_path_factory.mktemp("cocoslice")
    coco = str(root / "coco")
    mini_coco_split(coco, "minitrain", 2, 2, seed=0)
    mini_coco_split(coco, "minival", 2, 2, seed=10)
    paths = ["--root_path", str(root / "data"), "--dataset_path", coco]
    prefix = str(root / "model" / "e2e")
    train_end2end.train_net(train_end2end.parse_args(
        COCO + TRAIN + paths + ["--device", "cpu", "--prefix", prefix]))
    npz = epoch_path(prefix, 1)

    jcfg = tiny(j_generate_config, tpu__DEVICE_PREP=True)
    jpred = JPredictor(j_build_model(jcfg), j_load_params_npz(npz), jcfg)
    jimdb = JCOCODataset("minival", str(root / "jax"), coco)
    cfg = tiny(generate_config)
    pred = Predictor(build_model(cfg), npz, cfg, device="cpu")
    imdb = COCODataset("minival", str(root / "port"), coco)

    out = {"cfg": cfg, "pred": pred, "jpred": jpred, "jcfg": jcfg,
           "paths": paths, "prefix": prefix, "root": root,
           "image": imdb.image_path(0)}
    for devpost in (False, True):
        tag = "device" if devpost else "host"
        path = str(root / f"jax-{tag}.pkl")
        stats = j_pred_eval(jpred, JTestLoader(jimdb.gt_roidb(), jcfg,
                                               batch_size=BATCH,
                                               device_prep=True),
                            jimdb, det_cache=path, inflight=0,
                            device_postprocess=devpost)
        out["jax", tag] = (stats, read(path))
    # the port's host route through its test driver (serial loop), the
    # device route through pred_eval
    path = str(root / "port-host.pkl")
    out["cli"] = COCO + ["--image_set", "minival"] + paths
    stats = test_driver.test_rcnn(test_driver.parse_args(
        out["cli"] + ["--prefix", prefix, "--epoch", "1", "--device", "cpu",
                      "--batch_images", str(BATCH), "--eval-inflight", "0",
                      "--dets_cache", path]))
    out["port", "host"] = (stats, read(path), path)
    path = str(root / "port-device.pkl")
    stats = pred_eval(pred, TestLoader(imdb.gt_roidb(), cfg,
                                       batch_size=BATCH),
                      imdb, det_cache=path, inflight=0,
                      device_postprocess=True)
    out["port", "device"] = (stats, read(path))
    return out


@pytest.mark.parametrize("route", ["host", "device"])
def test_pred_eval_matches_jax(runs, route):
    jstats, jboxes = runs["jax", route]
    stats, boxes = runs["port", route][:2]
    assert len(boxes) == len(jboxes) == 81
    n_dets = 0
    for k in range(1, 81):
        assert len(boxes[k]) == len(jboxes[k]) == 4
        for i, (got, want) in enumerate(zip(boxes[k], jboxes[k])):
            assert got.shape == want.shape, (k, i)
            np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0,
                                       atol=SCORE_ATOL,
                                       err_msg=f"class {k} image {i}")
            np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0,
                                       atol=BOX_ATOL,
                                       err_msg=f"class {k} image {i}")
            n_dets += len(got)
    assert n_dets > 0, "the tiny model must produce detections to compare"
    assert tuple(k for k in stats if k != "eval_pipeline") == STAT_KEYS
    assert set(jstats) == set(STAT_KEYS)
    for key in STAT_KEYS:
        assert abs(stats[key] - jstats[key]) <= STAT_ATOL, key
    assert jstats["AP50"] > 0, "some detections must hit the gt"
    assert stats["eval_pipeline"]["mode"] == (
        "serial+devpost" if route == "device" else "serial")


def test_test_driver_on_coco_then_reeval(runs):
    """``python -m mx_rcnn_tpu_torch.test --dataset coco --device cpu``
    (the fixture's host-route run) returns the 12 COCO stats and no
    ``mAP``; its log line (the flattened stats, as the JAX driver logs
    them) no longer reads ``stats["mAP"]``.  ``tools/reeval`` re-scores
    its detections cache to the same stats."""
    stats, _, dets = runs["port", "host"]
    assert stats["eval_pipeline"]["mode"] == "serial"
    want = {k: v for k, v in stats.items() if k != "eval_pipeline"}
    assert tuple(want) == STAT_KEYS and "mAP" not in stats
    flat = test_driver.flat_stats(stats)
    assert flat["AP"] == round(want["AP"], 4)
    assert flat["eval_pipeline/images"] == 4.0
    assert "eval_pipeline/mode" not in flat
    assert reeval.reeval(reeval.parse_args(
        runs["cli"] + ["--detections", dets])) == want


def test_test_driver_on_voc_still_returns_map(tmp_path):
    """The VOC scorer's dict through the repaired log line: ``mAP`` and
    the per-class APs come back as before (seeded random 21-class weights
    on two images of a mini devkit)."""
    devkit = str(tmp_path / "VOCdevkit")
    make_mini_voc(devkit, n_train=0, n_test=2)
    prefix = str(tmp_path / "model" / "voc")
    args = test_driver.parse_args(
        TINY + ["--image_set", "2007_minitest", "--dataset_path", devkit,
                "--root_path", str(tmp_path / "data"), "--prefix", prefix,
                "--epoch", "1", "--device", "cpu", "--eval-inflight", "0"])
    cfg = config_from_args(args, train=False)
    assert cfg.NUM_CLASSES == 21
    save_params_npz(epoch_path(prefix, 1),
                    random_params(build_model(cfg), seed=0))
    stats = test_driver.test_rcnn(args)
    assert 0.0 <= stats["mAP"] <= 1.0
    assert len([k for k in stats if k not in ("mAP", "eval_pipeline")]) == 20


def jax_demo(runs, image_path, thresh):
    """The JAX ``demo.py:demo_net`` loop (threshold, native NMS, class
    names) on the JAX device-prep route, the image in both rows of a
    batch of two."""
    jpred, jcfg = runs["jpred"], runs["jcfg"]
    s, hw, r, info = j_stage(j_get_image(image_path), SCALE, 16)
    batch = jpred.batch_put({
        "images": np.stack([s, s]), "raw_hw": np.stack([hw, hw]),
        "prep_ratio": np.stack([r, r]), "flip": np.zeros(2, bool),
        "im_info": np.stack([info, info])})
    rois, valid, scores, deltas, _ = [
        np.asarray(jax.device_get(x))
        for x in jpred.predict(batch["images"], batch["im_info"])]
    boxes = jpost.decode_image_boxes(rois[0], deltas[0], info)
    out = []
    v = valid[0].astype(bool)
    for k in range(1, jcfg.NUM_CLASSES):
        sel = (scores[0][:, k] > thresh) & v
        dets = np.hstack([boxes[sel, 4 * k:4 * (k + 1)],
                          scores[0][sel, k][:, None]]).astype(np.float32)
        out += [(f"class{k}", d) for d in dets[j_nms(dets, jcfg.TEST.NMS)]]
    return out, scores[0][v][:, 1:]


def test_demo_matches_jax(runs):
    """``python -m mx_rcnn_tpu_torch.demo --dataset coco --device cpu`` on
    a ``minival`` image.  The threshold is set inside the widest gap of
    the upper half of the image's class scores (the top score above it),
    so that it selects some rows and no score lies within twice the
    tolerance of it."""
    path = runs["image"]
    _, scores = jax_demo(runs, path, 1.0)
    s = np.unique(scores)[len(scores.ravel()) // 2:]
    gap = int(np.argmax(np.diff(s)))
    assert s[gap + 1] - s[gap] > 4 * SCORE_ATOL
    thresh = float((s[gap] + s[gap + 1]) / 2)
    want, _ = jax_demo(runs, path, thresh)
    got = demo.demo_net(demo.parse_args(
        COCO + runs["paths"] + ["--prefix", runs["prefix"], "--epoch", "1",
                                "--device", "cpu", "--image", path,
                                "--thresh", repr(thresh)]))
    assert 0 < len(got) < len(scores.ravel())
    assert [c for c, _ in got] == [c for c, _ in want]
    for (_, d), (_, e) in zip(got, want):
        assert d.dtype == np.float32
        assert abs(d[4] - e[4]) <= SCORE_ATOL
        np.testing.assert_allclose(d[:4], e[:4], rtol=0, atol=BOX_ATOL)


def test_demo_out_raises_by_name(runs):
    with pytest.raises(NotImplementedError, match="cv2"):
        demo.demo_net(demo.parse_args(
            COCO + ["--device", "cpu", "--image", runs["image"], "--out",
                    "x.png"]))


def offline_records(pred, cfg, images, e2e):
    """The port's offline path on ``images`` as one batch."""
    te = cfg.TEST
    staged = [stage_raw_to_bucket(im, SCALE, 16) for im in images]
    batch = pred.batch_put({k: np.stack([s[i] for s in staged])
                            for i, k in enumerate(("images", "raw_hw",
                                                   "prep_ratio",
                                                   "im_info"))})
    if e2e:
        dets, valid = pred.predict_detections(batch["images"],
                                              batch["im_info"],
                                              te.MAX_PER_IMAGE, te.THRESH)
        per_cls = [post.device_dets_to_per_class(d, v, cfg.NUM_CLASSES)
                   for d, v in zip(dets.numpy(), valid.numpy())]
    else:
        per_cls = [post.per_class_nms(sc, bx, va, cfg.NUM_CLASSES,
                                      te.THRESH, te.NMS, te.MAX_PER_IMAGE)
                   for sc, bx, va in im_detect(pred, batch)]
    return [post.detections_to_records(d) for d in per_cls]


@pytest.mark.parametrize("mode", ["host_nms", "e2e"])
def test_served_batch_at_81_classes(runs, mode):
    cfg, pred = runs["cfg"], runs["pred"]
    assert cfg.NUM_CLASSES == 81
    rng = np.random.RandomState(3)
    images = [rng.randint(0, 256, (90, 150, 3), np.uint8),
              rng.randint(0, 256, (120, 170, 3), np.uint8)]
    engine = ServeEngine(pred, cfg, ServeOptions(
        batch_size=BATCH, max_delay_ms=60000.0, max_queue=4,
        serve_e2e=mode == "e2e")).start()
    try:
        futs = [engine.submit(im, deadline_ms=0) for im in images]
        served = [f.result(timeout=300) for f in futs]
        rows = [f.batch_row for f in futs]
        batches = engine.counters["batches"]
    finally:
        engine.stop()
    assert batches == 1 and sorted(rows) == [0, 1]
    offline = offline_records(pred, cfg, [images[rows.index(b)]
                                          for b in range(BATCH)],
                              mode == "e2e")
    n = 0
    for got, row in zip(served, rows):
        want = offline[row]
        assert len(got) == len(want)
        for d, e in zip(got, want):
            assert d["cls"] == e["cls"] and 1 <= d["cls"] <= 80
            assert abs(d["score"] - e["score"]) <= 1e-6
            np.testing.assert_allclose(d["bbox"], e["bbox"], rtol=0,
                                       atol=BOX_ATOL)
        n += len(got)
    assert n > 0
    assert max(r["cls"] for g in served for r in g) > 20
