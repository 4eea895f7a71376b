"""The alternate-training slice of the PyTorch port end to end on the CPU:
``python -m mx_rcnn_tpu_torch.train_alternate --device cpu`` on
``make_mini_voc`` (16 training images, flipped: 32 records) with the tiny
detector of ``tests/test_torch_eval_slice.py``, ``--pretrained`` an
``.npz`` of ``random_params``, 2 steps of 2 images a stage.

The stages' ``fit`` calls are recorded (weights in, weights exported
after, trainable mask): each stage starts from the weights the JAX
driver gives it, its frozen leaves stay bitwise and its trainable ones
move, and the final ``{prefix}-0001.npz`` holds stage 4's backbone and RPN
and stage 6's head bitwise (de-normalised).  Both packages' evaluation on
that checkpoint give the same detections (the eval slice's tolerance:
equal counts, scores within 1e-5, boxes within 1e-3 px).  Then the stage
tools chained by hand: ``train_rpn`` → its checkpoint → ``test_rpn`` →
the proposal cache → ``train_rcnn --proposals``.
"""

import os
import pickle

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

from mx_rcnn_tpu_torch import test as test_driver
from mx_rcnn_tpu_torch import train_alternate
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.tools import test_rpn as test_rpn_mod
from mx_rcnn_tpu_torch.tools import train_rcnn as train_rcnn_mod
from mx_rcnn_tpu_torch.tools import train_rpn as train_rpn_mod
from mx_rcnn_tpu_torch.train.checkpoint import (denormalize_for_save,
                                                epoch_path, load_params_npz,
                                                save_params_npz)
from mx_rcnn_tpu_torch.utils.convert_jax import (export_jax_params,
                                                 random_params)
from tests.fixtures import make_mini_voc
from tests.test_torch_eval_slice import TEST, TINY, tiny

torch.set_num_threads(2)

TRAIN = ["--image_set", "2007_trainval", "--num-steps", "2", "--end_epoch",
         "1", "--batch_images", "2",
         "--cfg", "TRAIN__RPN_PRE_NMS_TOP_N=200",
         "--cfg", "TRAIN__RPN_POST_NMS_TOP_N=32", "--cfg", "TRAIN__BATCH_ROIS=16",
         "--cfg", "TEST__RPN_PRE_NMS_TOP_N=200",
         "--cfg", "TEST__RPN_POST_NMS_TOP_N=32"]
HEAD = ("head_body/", "rcnn_out/")


def recording(fit, log):
    """``fit`` that appends (graph, frozen prefixes, weights in, weights
    exported after, mask, loader steps) to ``log``."""
    def wrapped(cfg, model, params, loader, **kw):
        before = {k: np.array(v) for k, v in params.items()}
        state = fit(cfg, model, params, loader, **kw)
        log.append(dict(graph=kw["graph"], fixed=kw["fixed_prefixes"],
                        before=before, after=export_jax_params(state.model),
                        mask=state.mask, steps=state.step,
                        prefix=kw["prefix"]))
        return state
    return wrapped


@pytest.fixture(scope="module")
def alt_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("altslice")
    devkit = str(root / "VOCdevkit")
    make_mini_voc(devkit)
    paths = ["--root_path", str(root / "data"), "--dataset_path", devkit]
    cfg = tiny(generate_config)
    pretrained = str(root / "pretrained.npz")
    save_params_npz(pretrained, random_params(build_model(cfg), seed=5))
    prefix = str(root / "model" / "alt")
    fits, props = [], []
    mp = pytest.MonkeyPatch()
    for mod in (train_rpn_mod, train_rcnn_mod):
        mp.setattr(mod, "fit", recording(mod.fit, fits))

    def gen(predictor, loader, roidb, cache_path=None):
        out = generate_proposals(predictor, loader, roidb, cache_path)
        props.append([np.array(r["proposals"]) for r in out])
        return out

    generate_proposals = test_rpn_mod.generate_proposals
    mp.setattr(test_rpn_mod, "generate_proposals", gen)
    try:
        final = train_alternate.alternate_train(train_alternate.parse_args(
            TINY + TRAIN + paths + ["--device", "cpu", "--prefix", prefix,
                                    "--pretrained", pretrained]))
    finally:
        mp.undo()
    return dict(root=root, paths=paths, prefix=prefix, fits=fits,
                props=props, final=final, pretrained=pretrained)


def test_stages_chain_as_the_jax_driver(alt_run):
    fits, props = alt_run["fits"], alt_run["props"]
    cfg = tiny(generate_config)
    assert [f["graph"] for f in fits] == ["rpn", "rcnn", "rpn", "rcnn"]
    assert [f["fixed"] for f in fits] == [
        cfg.network.FIXED_PARAMS, cfg.network.FIXED_PARAMS,
        cfg.network.FIXED_PARAMS_SHARED, cfg.network.FIXED_PARAMS_SHARED]
    assert all(f["prefix"] is None and f["steps"] == 2 for f in fits)
    init = load_params_npz(alt_run["pretrained"])
    s1, s3, s4, s6 = fits
    for start, want in ((s1, init), (s3, init), (s4, s3["after"]),
                        (s6, s4["after"])):
        assert start["before"].keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(start["before"][k], want[k])
    for i, f in enumerate(fits):
        moved = {k for k in f["mask"]
                 if not np.array_equal(f["after"][k], f["before"][k])}
        frozen = {k for k, t in f["mask"].items() if not t}
        assert not moved & frozen, (i, sorted(moved & frozen)[:3])
        # every trainable leaf moves (a bias at 0 only by its gradient)
        assert {k for k in f["mask"] if f["mask"][k] and
                f["before"][k].any()} <= moved, i
    assert any(k.startswith("backbone/stage2") for k, t in s1["mask"].items()
               if t)
    assert not any(k.startswith("backbone/stage3") for k, t in
                   s4["mask"].items() if t)
    assert len(props) == 2 and all(len(p) == 32 for p in props)
    for p in props:
        assert all(0 < len(x) <= 32 for x in p)


def test_final_checkpoint_combines_stage_4_and_stage_6(alt_run):
    _, _, s4, s6 = alt_run["fits"]
    cfg = tiny(generate_config)
    saved = load_params_npz(epoch_path(alt_run["prefix"], 1))
    head = denormalize_for_save(s6["after"], cfg)
    assert saved.keys() == s4["after"].keys()
    for k, v in saved.items():
        want = head[k] if k.startswith(HEAD) else s4["after"][k]
        np.testing.assert_array_equal(v, want, err_msg=k)
    for k, v in alt_run["final"].items():
        src = s6 if k.startswith(HEAD) else s4
        np.testing.assert_array_equal(v, src["after"][k], err_msg=k)


def test_checkpoint_evaluates_as_in_the_jax_package(alt_run, tmp_path):
    """``python -m mx_rcnn_tpu_torch.test --epoch 1`` on the combined
    checkpoint against the JAX ``Predictor`` + ``pred_eval``."""
    root, devkit = alt_run["root"], alt_run["paths"][-1]
    npz = epoch_path(alt_run["prefix"], 1)
    dets = str(tmp_path / "port.pkl")
    stats = test_driver.test_rcnn(test_driver.parse_args(
        TINY + TEST + alt_run["paths"] + [
            "--prefix", alt_run["prefix"], "--epoch", "1", "--device", "cpu",
            "--batch_images", "2", "--eval-inflight", "0",
            "--dets_cache", dets]))
    jcfg = tiny(j_generate_config, tpu__DEVICE_PREP=True)
    jpred = JPredictor(j_build_model(jcfg), j_load_params_npz(npz), jcfg)
    jimdb = JPascalVOC("2007_minitest", str(root / "jax"), devkit)
    jdets = str(tmp_path / "jax.pkl")
    jstats = j_pred_eval(jpred, JTestLoader(jimdb.gt_roidb(), jcfg,
                                            batch_size=2, device_prep=True),
                         jimdb, det_cache=jdets, inflight=0)
    with open(dets, "rb") as f:
        got = pickle.load(f)
    with open(jdets, "rb") as f:
        want = pickle.load(f)
    n = 0
    for k in range(1, 21):
        for i, (a, b) in enumerate(zip(got[k], want[k], strict=True)):
            assert a.shape == b.shape, (k, i)
            np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=0, atol=1e-5)
            np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=1e-3)
            n += len(a)
    assert n > 0
    assert abs(stats["mAP"] - jstats["mAP"]) <= 1e-4


def test_stage_tools_chained_by_hand(alt_run, tmp_path):
    """``train_rpn`` → ``{prefix}-0001.npz`` → ``test_rpn`` → the proposal
    cache of the gt roidb → ``train_rcnn --proposals`` →
    ``{prefix}-0001.npz``; ``selective_search`` and a roidb without
    proposals raise."""
    paths = ["--root_path", str(tmp_path / "data"),
             "--dataset_path", alt_run["paths"][-1]]
    common = TINY + paths + ["--device", "cpu"]
    rpn = str(tmp_path / "rpn")
    train_rpn_mod.train_rpn(train_rpn_mod.parse_args(
        common + TRAIN + ["--prefix", rpn, "--pretrained",
                          alt_run["pretrained"]]))
    assert os.path.exists(epoch_path(rpn, 1))
    roidb = test_rpn_mod.test_rpn(test_rpn_mod.parse_args(
        common + TRAIN[-4:] + ["--image_set", "2007_trainval", "--prefix",
                               rpn, "--epoch", "1"]))
    cache = str(tmp_path / "data" / "cache"
                / "voc_2007_trainval_rpn_proposals.pkl")
    with open(cache, "rb") as f:
        cached = pickle.load(f)
    assert len(cached) == len(roidb) == 16
    assert not any(r.get("flipped") for r in roidb)
    rcnn = str(tmp_path / "rcnn")
    state = train_rcnn_mod.train_rcnn(train_rcnn_mod.parse_args(
        common + TRAIN + ["--prefix", rcnn, "--proposals", cache,
                          "--pretrained", epoch_path(rpn, 1)]))
    assert state.step == 2 and os.path.exists(epoch_path(rcnn, 1))
    with pytest.raises(NotImplementedError, match="selective"):
        train_rcnn_mod.train_rcnn(train_rcnn_mod.parse_args(
            common + TRAIN + ["--proposals", "selective_search"]))
    with pytest.raises(ValueError, match="no cached proposals"):
        train_rcnn_mod.train_rcnn(train_rcnn_mod.parse_args(common + TRAIN))
