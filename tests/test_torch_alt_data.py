"""The data of alternate training against the JAX package, on the CPU:
proposals attached from a cache and flipped (``load_proposals`` →
``append_flipped_images``), ``ROIIter``'s batches, ``generate_proposals``
over flipped records, ``Predictor.predict_rpn`` on a flipped record, and
``combine_model``.

Loaders are compared with the JAX package's device-prep route
(``tpu.DEVICE_PREP``): the same staged bytes, sidecars, gt, ``rois`` and
``roi_valid``, bitwise.  Proposals come from the tiny detector of
``tests/test_torch_port_model.py`` (JAX ``init_params``, float32) at batch
1 and 2: equal counts and order, boxes within 1e-3 px.  The pixels after
the predictors' device prep within 1e-5 (the inference slice's
tolerance).
"""

import dataclasses
import logging
import pickle

import jax
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data.loader import ROIIter as JROIIter
from mx_rcnn_tpu.data.loader import TestLoader as JTestLoader
from mx_rcnn_tpu.data.synthetic import SyntheticDataset as JSynthetic
from mx_rcnn_tpu.eval import Predictor as JPredictor
from mx_rcnn_tpu.eval import generate_proposals as j_generate_proposals
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.models import init_params
from mx_rcnn_tpu.utils.combine_model import combine_model as j_combine_model
from mx_rcnn_tpu.utils.load_data import load_proposals as j_load_proposals

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data.loader import ROIIter, TestLoader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.eval.tester import Predictor, generate_proposals
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.utils.combine_model import combine_model
from mx_rcnn_tpu_torch.utils.load_data import load_proposals
from tests.test_torch_port_model import flatten, tiny
from tests.test_torch_train_ops import assert_roidbs_equal, loader_cfg

torch.set_num_threads(2)

CAP = 12  # TRAIN.RPN_POST_NMS_TOP_N of the loader config


def proposal_cache(roidb, seed=0):
    """One entry per record: none (``None``), an empty array, a few, and
    more than ``CAP``; some boxes outside the image or inverted, for
    ``sanitize_proposals`` to repair."""
    rng = np.random.RandomState(seed)
    out = []
    for i, rec in enumerate(roidb):
        n = (None, 0, 5, CAP + 7, 3)[(i + 3 * seed) % 5]
        if n is None:
            out.append(None)
            continue
        w, h = rec["width"], rec["height"]
        x1 = rng.uniform(-10, w, n)
        y1 = rng.uniform(-10, h, n)
        boxes = np.stack([x1, y1, x1 + rng.uniform(-5, 60, n),
                          y1 + rng.uniform(-5, 60, n)], 1).astype(np.float32)
        out.append(boxes)
    return out


def proposal_roidbs(cls, load, path):
    """Landscape and portrait synthetic gt roidbs with the cache's
    proposals attached, then flipped and filtered (attach-then-flip)."""
    out = []
    for kw in (dict(num_images=3, height=64, width=96, seed=0),
               dict(num_images=2, height=100, width=70, seed=1)):
        ds = cls(num_classes=21, max_objects=3, **kw)
        roidb = load(ds.gt_roidb(), path[kw["seed"]])
        out += ds.filter_roidb(ds.append_flipped_images(roidb))
    return out


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    root = tmp_path_factory.mktemp("props")
    paths = {}
    for seed, n in ((0, 3), (1, 2)):
        ds = SyntheticDataset(num_images=n, num_classes=21, max_objects=3,
                              height=64 if seed == 0 else 100,
                              width=96 if seed == 0 else 70, seed=seed)
        paths[seed] = str(root / f"cache{seed}.pkl")
        with open(paths[seed], "wb") as f:
            pickle.dump(proposal_cache(ds.gt_roidb(), seed), f)
    return paths


def test_load_proposals_then_flip_matches_jax(caches):
    got = proposal_roidbs(SyntheticDataset, load_proposals, caches)
    want = proposal_roidbs(JSynthetic, j_load_proposals, caches)
    assert_roidbs_equal(got, want)
    flipped = [r for r in got if r["flipped"]]
    assert flipped and all("proposals" in r for r in got)
    for rec in got:
        p = rec["proposals"]
        assert p.dtype == np.float32 and p.shape[1:] == (4,)
        assert (p[:, 2] >= p[:, 0]).all() and (p[:, 3] >= p[:, 1]).all()
        assert (p >= 0).all() and (p[:, 2] <= rec["width"] - 1).all()
    with pytest.raises(ValueError, match="entries"):
        load_proposals(SyntheticDataset(num_images=4).gt_roidb(), caches[0])


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered",
                                                        "shuffled"])
def test_roi_iter_matches_jax_device_prep_loader(caches, caplog, shuffle):
    """Two epochs: the same plan, staged bytes, sidecars, gt, and the
    proposals scaled into the resized frame, padded or cut to the cap."""
    kw = dict(TRAIN__RPN_POST_NMS_TOP_N=CAP)
    roidb = proposal_roidbs(SyntheticDataset, load_proposals, caches)
    with caplog.at_level(logging.WARNING, logger="mx_rcnn_tpu_torch"):
        port = ROIIter(roidb, loader_cfg(generate_config, **kw), 2,
                       shuffle=shuffle, seed=3)
    warned = [r for r in caplog.records if r.name == "mx_rcnn_tpu_torch"
              and "keeps the FIRST" in r.getMessage()]
    assert len(warned) == 1 and warned[0].getMessage().startswith("2/10 ")
    ref = JROIIter(proposal_roidbs(JSynthetic, j_load_proposals, caches),
                   loader_cfg(j_generate_config, tpu__DEVICE_PREP=True, **kw),
                   2, shuffle=shuffle, seed=3)
    assert port.steps_per_epoch == ref.steps_per_epoch == 5
    counts = set()
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a["rois"].shape == (2, CAP, 4)
            counts.update(a["roi_valid"].sum(1).tolist())
    assert {0, 3, 5, CAP} <= counts
    assert any(b["flip"].any() for b in got)


@pytest.fixture(scope="module")
def rpn_side():
    cfg = tiny(j_generate_config)
    return jax.device_get(init_params(j_build_model(cfg), cfg,
                                      jax.random.PRNGKey(0), batch_size=1,
                                      image_hw=(128, 192)))


def synthetic_flipped(cls):
    ds = cls(num_images=3, num_classes=21, max_objects=3, height=128,
             width=192, seed=4)
    return ds, ds.append_flipped_images(ds.gt_roidb())


def predictors(params):
    """The JAX ``Predictor`` on its device-prep route and the port's, on
    the same weights."""
    jcfg = tiny(j_generate_config)
    jcfg = jcfg.replace(tpu=dataclasses.replace(jcfg.tpu, DEVICE_PREP=True))
    cfg = tiny(generate_config)
    return (JPredictor(j_build_model(jcfg), params, jcfg), jcfg,
            Predictor(build_model(cfg), flatten(params), cfg, device="cpu"),
            cfg)


def test_predict_rpn_on_a_flipped_record_matches_jax(rpn_side):
    """A flipped record through the port's ``TestLoader`` →
    ``Predictor.batch_put`` is mirrored on the device as the JAX device
    prep mirrors it, and ``predict_rpn`` gives the JAX proposals."""
    jpred, jcfg, pred, cfg = predictors(rpn_side)
    _, jroidb = synthetic_flipped(JSynthetic)
    _, roidb = synthetic_flipped(SyntheticDataset)
    i = 4
    assert roidb[i]["flipped"]
    want = jpred.batch_put(next(iter(JTestLoader(jroidb[i:i + 1], jcfg,
                                                 device_prep=True))))
    got = pred.batch_put(next(iter(TestLoader(roidb[i:i + 1], cfg))))
    assert "flip" not in got
    np.testing.assert_allclose(got["images"].numpy(),
                               np.asarray(want["images"]), rtol=0, atol=1e-5)
    unflipped = pred.batch_put(next(iter(TestLoader(
        [dict(roidb[i], flipped=False)], cfg))))
    assert np.abs(unflipped["images"].numpy()
                  - np.asarray(want["images"])).max() > 0.1
    j_rois, j_scores, j_valid = jax.device_get(jpred.predict_rpn(
        want["images"], want["im_info"]))
    rois, scores, valid = (t.numpy() for t in pred.predict_rpn(
        got["images"], got["im_info"]))
    np.testing.assert_array_equal(valid, j_valid)
    assert valid.sum() > 0
    np.testing.assert_allclose(scores[valid], j_scores[j_valid], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(rois[valid], j_rois[j_valid], rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("batch", [1, 2])
def test_generate_proposals_matches_jax(rpn_side, tmp_path, batch):
    """Over a roidb with flipped records: per record the same proposals in
    the original frame, in the same (score-descending) order, and the
    same pickle layout."""
    jpred, jcfg, pred, cfg = predictors(rpn_side)
    jds, jroidb = synthetic_flipped(JSynthetic)
    _, roidb = synthetic_flipped(SyntheticDataset)
    jloader = JTestLoader(jroidb, jcfg, batch_size=batch, device_prep=True)
    jloader.put = jpred.batch_put
    jpath, path = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    want = j_generate_proposals(jpred, jloader, jds, jroidb, cache_path=jpath)
    got = generate_proposals(pred, TestLoader(roidb, cfg, batch_size=batch),
                             roidb, cache_path=path)
    assert got is roidb and len(got) == len(want) == 6
    for i, (a, b) in enumerate(zip(got, want)):
        pa, pb = a["proposals"], b["proposals"]
        assert pa.dtype == np.float32 and pa.shape == pb.shape, i
        assert 0 < len(pa) <= cfg.TEST.RPN_POST_NMS_TOP_N
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-3,
                                   err_msg=f"record {i}")
    with open(path, "rb") as f:
        cached = pickle.load(f)
    assert len(cached) == 6
    for c, rec in zip(cached, got):
        np.testing.assert_array_equal(c, rec["proposals"])


def test_combine_model_matches_jax():
    cfg = tiny(generate_config)
    model = build_model(cfg)
    from mx_rcnn_tpu_torch.utils.convert_jax import random_params

    rpn, rcnn = random_params(model, 1), random_params(model, 2)

    def tree(flat):
        out = {}
        for k, v in flat.items():
            node = out
            *path, leaf = k.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
        return out

    got = combine_model(rpn, rcnn)
    want = flatten(j_combine_model(tree(rpn), tree(rcnn)))
    assert got.keys() == want.keys() == rpn.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        src = rpn if k.startswith(("backbone/", "rpn/")) else rcnn
        assert got[k] is src[k], k
    with pytest.raises(KeyError, match="head_body"):
        combine_model(rpn, {k: v for k, v in rcnn.items()
                            if not k.startswith("head_body/")})
    with pytest.raises(KeyError, match="rpn"):
        combine_model({k: v for k, v in rpn.items()
                       if not k.startswith("rpn/")}, rcnn)
