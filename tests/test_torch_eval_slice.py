"""The evaluation slice of the PyTorch port against the JAX package, on the
CPU, on ``make_mini_voc`` (16 training and 8 test images, JPEG) and the
tiny detector of ``tests/test_torch_port_model.py``.

The port's ``train_end2end`` trains it from the devkit (the dataset route,
2 steps) and writes the flat ``.npz``; both packages load that checkpoint,
so the weights are carried and some detections hit the gt.  Then
``PascalVOC`` → ``TestLoader`` → ``Predictor`` → ``pred_eval`` → per-class
AP and mAP in each package: the JAX side is its own ``pred_eval`` with
``DEVICE_PREP`` and ``inflight=0``, on the host route and on the device
route (``use_pallas`` off the TPU delegates to ``nms_padded``).

Per image and class: equal detection counts, scores within 1e-5, boxes
within 1e-3 px; per-class AP and mAP within 1e-4.  The port's overlapped
loop is bit-identical to its serial loop.  The CLI round trip ``test
--device cpu --dets_cache`` → ``reeval`` gives the same mAP.
"""

import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data.loader import TestLoader as JTestLoader
from mx_rcnn_tpu.data.pascal_voc import PascalVOC as JPascalVOC
from mx_rcnn_tpu.eval import Predictor as JPredictor
from mx_rcnn_tpu.eval import pred_eval as j_pred_eval
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.train.checkpoint import load_params_npz as j_load_params_npz

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data.loader import TestLoader
from mx_rcnn_tpu_torch.data.pascal_voc import PascalVOC
from mx_rcnn_tpu_torch.eval.tester import Predictor, pred_eval
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.tools import reeval
from mx_rcnn_tpu_torch.train.checkpoint import epoch_path
from tests.fixtures import make_mini_voc

torch.set_num_threads(2)

TEST_SET = "2007_minitest"
BATCH = 2
OVERRIDES = dict(TEST__RPN_PRE_NMS_TOP_N=300, TEST__RPN_POST_NMS_TOP_N=50)
# the same config as command-line flags
TINY = ["--network", "resnet50", "--cfg", "tpu__SCALES=((128,192),)",
        "--cfg", "tpu__MAX_GT=8", "--cfg", "network__ANCHOR_SCALES=(2,4)",
        "--cfg", "network__PIXEL_STDS=(127.0,127.0,127.0)",
        "--cfg", "tpu__COMPUTE_DTYPE='float32'"]
TRAIN = ["--image_set", "2007_trainval", "--num-steps", "2", "--end_epoch",
         "1", "--cfg", "TRAIN__BATCH_IMAGES=2",
         "--cfg", "TRAIN__RPN_PRE_NMS_TOP_N=200",
         "--cfg", "TRAIN__RPN_POST_NMS_TOP_N=32", "--cfg", "TRAIN__BATCH_ROIS=16"]
TEST = ["--image_set", TEST_SET, "--cfg", "TEST__RPN_PRE_NMS_TOP_N=300",
        "--cfg", "TEST__RPN_POST_NMS_TOP_N=50"]


def tiny(gen, **kw):
    """tests/test_torch_port_model.py's tiny detector in float32."""
    cfg = gen("resnet50", "PascalVOC", **OVERRIDES, **kw)
    net = dataclasses.replace(cfg.network, ANCHOR_SCALES=(2, 4),
                              PIXEL_STDS=(127.0, 127.0, 127.0))
    tpu = dataclasses.replace(cfg.tpu, SCALES=((128, 192),), MAX_GT=8,
                              COMPUTE_DTYPE="float32")
    return cfg.replace(network=net, tpu=tpu)


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    from mx_rcnn_tpu_torch import train_end2end

    root = tmp_path_factory.mktemp("evalslice")
    devkit = str(root / "VOCdevkit")
    make_mini_voc(devkit)
    paths = ["--root_path", str(root / "data"), "--dataset_path", devkit]
    prefix = str(root / "model" / "e2e")
    train_end2end.train_net(train_end2end.parse_args(
        TINY + TRAIN + paths + ["--device", "cpu", "--prefix", prefix]))
    npz = epoch_path(prefix, 1)

    jcfg = tiny(j_generate_config, tpu__DEVICE_PREP=True)
    jpred = JPredictor(j_build_model(jcfg), j_load_params_npz(npz), jcfg)
    jimdb = JPascalVOC(TEST_SET, str(root / "jax"), devkit)
    jroidb = jimdb.gt_roidb()

    cfg = tiny(generate_config)
    pred = Predictor(build_model(cfg), npz, cfg, device="cpu")
    imdb = PascalVOC(TEST_SET, str(root / "port"), devkit)
    roidb = imdb.gt_roidb()

    def boxes_of(path):
        with open(path, "rb") as f:
            return pickle.load(f)

    runs = {}
    for devpost in (False, True):
        tag = "device" if devpost else "host"
        path = str(root / f"jax-{tag}.pkl")
        stats = j_pred_eval(jpred, JTestLoader(jroidb, jcfg, batch_size=BATCH,
                                               device_prep=True), jimdb,
                            det_cache=path, inflight=0,
                            device_postprocess=devpost)
        runs["jax", tag] = (stats, boxes_of(path))
        for inflight in (0, 2):
            path = str(root / f"port-{tag}-{inflight}.pkl")
            stats = pred_eval(pred, TestLoader(roidb, cfg, batch_size=BATCH),
                              imdb, det_cache=path, inflight=inflight,
                              device_postprocess=devpost)
            runs["port", tag, inflight] = (stats, boxes_of(path))
    runs["cli"] = (TINY + TEST + paths, ["--prefix", prefix, "--epoch", "1"])
    return runs


@pytest.mark.parametrize("route", ["host", "device"])
def test_pred_eval_matches_jax(slice_runs, route):
    jstats, jboxes = slice_runs["jax", route]
    stats, boxes = slice_runs["port", route, 0]
    assert len(boxes) == len(jboxes) == 21
    n_dets = 0
    for k in range(1, 21):
        assert len(boxes[k]) == len(jboxes[k]) == 8
        for i, (got, want) in enumerate(zip(boxes[k], jboxes[k])):
            assert got.shape == want.shape, (k, i)
            np.testing.assert_allclose(got[:, 4], want[:, 4], atol=1e-5,
                                       rtol=0, err_msg=f"class {k} image {i}")
            np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3,
                                       rtol=0, err_msg=f"class {k} image {i}")
            n_dets += len(got)
    assert n_dets > 0, "the tiny model must produce detections to compare"
    assert jstats["mAP"] > 0, "some detections must hit the gt"
    aps = {k: v for k, v in stats.items() if k != "eval_pipeline"}
    assert set(aps) == set(jstats)
    for cls, ap in jstats.items():
        assert abs(aps[cls] - ap) <= 1e-4, (cls, aps[cls], ap)
    assert 0.0 <= stats["mAP"] <= 1.0
    assert stats["eval_pipeline"]["mode"] == (
        "serial+devpost" if route == "device" else "serial")


@pytest.mark.parametrize("route", ["host", "device"])
def test_pipelined_is_bit_identical_to_serial(slice_runs, route):
    serial, piped = (slice_runs["port", route, n] for n in (0, 2))
    for k in range(1, 21):
        for got, want in zip(piped[1][k], serial[1][k], strict=True):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    meta = piped[0]["eval_pipeline"]
    assert meta["images"] == 8 and meta["inflight"] == 2
    assert meta["mode"].startswith("pipelined")
    assert 0.0 <= meta["overlap_frac"] <= 1.0


def test_cli_test_then_reeval(slice_runs, tmp_path):
    """``python -m mx_rcnn_tpu_torch.test --device cpu --dets_cache`` on the
    trained checkpoint (overlapped host route, the default) → the same
    detections as ``pred_eval``; ``tools/reeval`` re-scores the cache to
    the same mAP."""
    from mx_rcnn_tpu_torch import test as test_driver

    dets = str(tmp_path / "dets.pkl")
    common, ckpt = slice_runs["cli"]
    stats = test_driver.test_rcnn(test_driver.parse_args(
        common + ckpt + ["--device", "cpu", "--batch_images", str(BATCH),
                         "--dets_cache", dets]))
    assert stats["eval_pipeline"]["mode"] == "pipelined"
    aps = {k: v for k, v in stats.items() if k != "eval_pipeline"}
    want = slice_runs["port", "host", 2][0]
    assert aps == {k: v for k, v in want.items() if k != "eval_pipeline"}
    assert reeval.reeval(reeval.parse_args(
        common + ["--detections", dets])) == aps
