"""FPN and Mask R-CNN training in the PyTorch port against the JAX package,
on the CPU.

The tiny FPN of ``tests/test_torch_fpn_model.py`` (64×96, ``NETWORK=
"resnet50"``, ``FPN_ANCHOR_SCALES=(4,)``, ``MAX_GT=4``, TRAIN 500 → 64 with
16 sampled RoIs), float32, B = 2, JAX ``init_params`` carried across with
the weight bridge.  The port's sampling ops get the uniforms the JAX graphs
draw from their step keys (``mx_rcnn_tpu/models/fpn.py``: ``split(key,
(B, 2))`` end to end, ``split(key, B)`` in the stage graphs).

* The mask model's train step against the JAX ``_loss_fn`` with the same
  gt masks: every loss (``mask_loss`` included) to rtol 1e-4, and the
  clipped gradients of every trainable leaf under
  ``tests/test_torch_train_step.py:check_leaves`` (1e-3 of the norm, at
  most one leaf off by one ReLU-flipped channel); ``MaskLoss`` in the
  metrics.  Without ``gt_masks`` no mask loss, as in JAX.
* ``rpn_train`` and ``rcnn_train`` of the tiny ``resnet50_fpn`` held the
  same way, under ``FIXED_PARAMS_SHARED`` (the neck frozen) and
  ``FIXED_PARAMS``; ``rcnn_train`` of the mask model raises the JAX
  message.
* ``combine_model`` equals the JAX one on FPN and mask key sets.
* The weight bridge, the momentum export and ``CheckpointManager`` cover
  the neck and the mask head; a step checkpoint of an FPN mask run,
  preempted and auto-resumed, ends bitwise at the uninterrupted run.
* The drivers on the CPU: ``train_end2end --network resnet101_fpn_mask``
  (the tiny overrides) 2 steps, then ``test`` on its checkpoint;
  ``train_alternate --network resnet101_fpn`` 1 step a stage, its combined
  model with stage 4's neck; ``train_alternate`` of a mask network raises
  the JAX message before any stage; the serve driver builds an engine for
  an FPN network.
"""

import dataclasses
import signal

import jax
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.models import init_params
from mx_rcnn_tpu.train import fixed_param_mask as j_fixed_param_mask
from mx_rcnn_tpu.train.train_step import _loss_fn as j_loss_fn
from mx_rcnn_tpu.utils.combine_model import combine_model as j_combine_model

from mx_rcnn_tpu_torch import test as test_driver
from mx_rcnn_tpu_torch import train_alternate, train_end2end
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data import loader as t_loader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.models.fpn import NO_MASK_ALTERNATE
from mx_rcnn_tpu_torch.train import trainer
from mx_rcnn_tpu_torch.train.checkpoint import (CheckpointManager, epoch_path,
                                                load_params_npz)
from mx_rcnn_tpu_torch.train.optim import export_momentum
from mx_rcnn_tpu_torch.train.resilience import ResilienceOptions
from mx_rcnn_tpu_torch.train.train_step import (create_train_state,
                                                make_train_step)
from mx_rcnn_tpu_torch.utils import convert_jax
from mx_rcnn_tpu_torch.utils.combine_model import combine_model
from tests.test_torch_train_step import check_leaves, flatten

torch.set_num_threads(2)

B, H, W = 2, 64, 96
OVERRIDES = dict(TRAIN__RPN_PRE_NMS_TOP_N=500, TRAIN__RPN_POST_NMS_TOP_N=64,
                 TRAIN__BATCH_ROIS=16, TEST__RPN_PRE_NMS_TOP_N=250,
                 TEST__RPN_POST_NMS_TOP_N=32)
LOSSES = {"rpn_cls_loss": "RPNLogLoss", "rpn_bbox_loss": "RPNL1Loss",
          "rcnn_cls_loss": "RCNNLogLoss", "rcnn_bbox_loss": "RCNNL1Loss",
          "mask_loss": "MaskLoss"}
# the driver flags of the same tiny FPN
TINY_FLAGS = ["--cfg", "tpu__SCALES=((64,96),)",
              "--cfg", "network__NETWORK='resnet50'",
              "--cfg", "network__FPN_ANCHOR_SCALES=(4,)",
              "--cfg", "tpu__MAX_GT=4", "--cfg", "tpu__ASSIGN_FUSED=True"] + [
    x for k, v in OVERRIDES.items() for x in ("--cfg", f"{k}={v}")] + [
    "--cfg", "TRAIN__BATCH_ROIS=16", "--cfg", "TEST__MAX_PER_IMAGE=20"]


def fpn_cfg(gen, network="resnet101_fpn_mask"):
    cfg = gen(network, "PascalVOC", **OVERRIDES)
    net = dataclasses.replace(cfg.network, FPN_ANCHOR_SCALES=(4,),
                              NETWORK="resnet50",
                              PIXEL_STDS=(127.0, 127.0, 127.0))
    tpu = dataclasses.replace(cfg.tpu, SCALES=((H, W),), MAX_GT=4,
                              COMPUTE_DTYPE="float32")
    return cfg.replace(network=net, tpu=tpu)


def n_anchors(cfg):
    """The concatenated P2–P6 anchors of the tiny bucket."""
    cells = sum(-(-H // s) * -(-W // s) for s in (4, 8, 16, 32))
    cells += -(-H // 64) * -(-W // 64)
    return cells * cfg.network.NUM_ANCHORS


def make_batch(seed=0, masks=True):
    """Normalised-scale images, 3 gt boxes an image of 4, blob masks."""
    rng = np.random.RandomState(seed)
    g = 4
    gtb = np.zeros((B, g, 4), np.float32)
    gtc = np.zeros((B, g), np.int32)
    gtv = np.zeros((B, g), bool)
    gtm = np.zeros((B, g, 112, 112), np.uint8)
    for b in range(B):
        for i in range(3):
            x1, y1 = rng.randint(0, W - 40), rng.randint(0, H - 36)
            gtb[b, i] = (x1, y1, x1 + rng.randint(12, 39),
                         y1 + rng.randint(12, 35))
            gtc[b, i] = rng.randint(1, 21)
            gtv[b, i] = True
            y, x = rng.randint(0, 60, 2)
            gtm[b, i, y:y + rng.randint(30, 80), x:x + rng.randint(30, 80)] = 1
    info = np.asarray([[H, W, 1.0], [H - 16, W - 32, 1.0]], np.float32)
    out = dict(images=rng.randn(B, H, W, 3).astype(np.float32), im_info=info,
               gt_boxes=gtb, gt_classes=gtc, gt_valid=gtv)
    if masks:
        out["gt_masks"] = gtm
    return out


def uniforms(keys, n):
    """(fg, bg) uniforms of (n,) from each image's key, as assign_anchor and
    sample_rois draw them."""
    pairs = [jax.random.split(k) for k in keys]
    return tuple(torch.from_numpy(np.stack(
        [np.asarray(jax.random.uniform(p[i], (n,))) for p in pairs]))
        for i in range(2))


def end2end_draws(key, cfg):
    keys = jax.random.split(key, (B, 2))
    return {"rpn": uniforms(keys[:, 0], n_anchors(cfg)),
            "rcnn": uniforms(keys[:, 1], cfg.TRAIN.RPN_POST_NMS_TOP_N
                             + cfg.tpu.MAX_GT)}


def stage_draws(key, name, n):
    return {name: uniforms(jax.random.split(key, B), n)}


def rcnn_batch(seed=0):
    """``make_batch`` (no masks) plus 64 proposals an image: jittered gt,
    random boxes, the last rows invalid."""
    batch = make_batch(seed, masks=False)
    rng = np.random.RandomState(seed + 1)
    p = OVERRIDES["TRAIN__RPN_POST_NMS_TOP_N"]
    rois = np.zeros((B, p, 4), np.float32)
    valid = np.zeros((B, p), bool)
    for b in range(B):
        jit = batch["gt_boxes"][b, :3] + rng.uniform(-3, 3, (3, 4))
        xy = rng.uniform(0, 70, (p - 13, 2))
        rand = np.concatenate([xy, xy + rng.uniform(6, 30, (p - 13, 2))], 1)
        rois[b, :p - 10] = np.concatenate([jit, rand])
        valid[b, :p - 10] = True
    batch.update(rois=rois, roi_valid=valid)
    return batch


@pytest.fixture(scope="module")
def jax_models():
    """JAX init_params of the tiny mask model (its non-mask leaves feed the
    box-only model too)."""
    out = {}
    for net in ("resnet101_fpn_mask", "resnet50_fpn"):
        cfg = fpn_cfg(j_generate_config, net)
        model = j_build_model(cfg)
        if not out:
            params = jax.device_get(init_params(
                model, cfg, jax.random.PRNGKey(0), B, (H, W)))
        else:
            params = {k: v for k, v in out["resnet101_fpn_mask"][2].items()
                      if k != "mask_head"}
        out[net] = (cfg, model, params)
    return out


def port_grads(model):
    """``{JAX key: gradient}`` of every leaf with one, in the JAX layout."""
    return {key: convert_jax._to_jax(tag, t.grad)
            for key, tag, t in convert_jax._tensors(model)
            if isinstance(t, torch.nn.Parameter) and t.grad is not None}


def hold_step(net, jax_side, graph, batch, draws, key, fixed, losses):
    """One port train step of ``graph`` against the JAX loss and clipped
    gradients on the same weights, batch and uniforms."""
    jcfg, jmodel, params = jax_side
    mask = j_fixed_param_mask(params, fixed)

    @jax.jit
    def jgrads(p, b, k):
        def loss(q):
            q = jax.tree.map(lambda v, t: v if t else jax.lax.stop_gradient(v),
                             q, mask)
            return j_loss_fn(q, jmodel, b, k, graph)
        return jax.value_and_grad(loss, has_aux=True)(p)

    jbatch = {k: (v.astype(np.float32) if k == "gt_masks" else v)
              for k, v in batch.items()}
    (_, aux), grads = jax.device_get(jgrads(params, jbatch, key))
    grads = flatten(grads)

    cfg = fpn_cfg(generate_config, net)
    model = build_model(cfg)
    convert_jax.load_jax_params(model, flatten(params))
    state = create_train_state(cfg, model, steps_per_epoch=10,
                               fixed_prefixes=fixed)
    assert state.mask == {k: bool(v) for k, v in flatten(mask).items()}
    _, metrics = make_train_step(cfg, graph)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        draws=draws)
    for k in losses:
        np.testing.assert_allclose(float(metrics[LOSSES[k]]), float(aux[k]),
                                   rtol=1e-4, err_msg=k)
        assert float(aux[k]) > 0, k
    trained = [k for k, t in state.mask.items() if t]
    clip = jcfg.TRAIN.CLIP_GRADIENT
    got = port_grads(model)
    assert set(got) == set(trained)
    check_leaves(got, {k: np.clip(grads[k], -clip, clip) for k in trained},
                 trained, f"{graph} gradient")
    return model, state, metrics, trained


def test_mask_step_matches_jax(jax_models):
    jax_side = jax_models["resnet101_fpn_mask"]
    cfg = jax_side[0]
    key = jax.random.PRNGKey(7)
    batch = make_batch()
    model, state, metrics, trained = hold_step(
        "resnet101_fpn_mask", jax_side, "end2end", batch, end2end_draws(key, cfg), key,
        cfg.network.FIXED_PARAMS, list(LOSSES))
    assert set(metrics) >= set(LOSSES.values())
    for group in ("mask_head/", "neck/", "rpn/", "head_body/"):
        assert any(k.startswith(group) for k in trained), group
    # without masks there is no mask loss (the JAX graph's contract)
    nomask = {k: torch.from_numpy(v) for k, v in batch.items()
              if k != "gt_masks"}
    with torch.no_grad():
        _, aux = model(nomask["images"], nomask["im_info"],
                       nomask["gt_boxes"], nomask["gt_classes"],
                       nomask["gt_valid"], draws=end2end_draws(key, cfg))
    assert "mask_loss" not in aux


@pytest.mark.parametrize("graph", ["rpn", "rcnn"])
def test_stage_graphs_match_jax(jax_models, graph):
    jax_side = jax_models["resnet50_fpn"]
    cfg = jax_side[0]
    key = jax.random.PRNGKey(11)
    if graph == "rpn":
        batch = make_batch(masks=False)
        draws = stage_draws(key, "rpn", n_anchors(cfg))
        fixed = cfg.network.FIXED_PARAMS_SHARED
        losses = ["rpn_cls_loss", "rpn_bbox_loss"]
    else:
        batch = rcnn_batch()
        draws = stage_draws(key, "rcnn", batch["rois"].shape[1]
                            + cfg.tpu.MAX_GT)
        fixed = cfg.network.FIXED_PARAMS
        losses = ["rcnn_cls_loss", "rcnn_bbox_loss"]
    _, state, _, trained = hold_step("resnet50_fpn", jax_side, graph, batch,
                                     draws, key, fixed, losses)
    neck = [k for k in state.mask if k.startswith("neck/")]
    assert neck and all(state.mask[k] != (graph == "rpn") for k in neck)


def test_rcnn_train_of_a_mask_network_raises_the_jax_message(jax_models):
    model = build_model(fpn_cfg(generate_config))
    b = rcnn_batch()
    args = [torch.from_numpy(b[k]) for k in (
        "images", "im_info", "rois", "roi_valid", "gt_boxes", "gt_classes",
        "gt_valid")]
    with pytest.raises(NotImplementedError) as got:
        model.rcnn_train(*args)
    jcfg, jmodel, params = jax_models["resnet101_fpn_mask"]
    with pytest.raises(NotImplementedError) as want:
        jmodel.apply({"params": params}, *(b[k] for k in (
            "images", "im_info", "rois", "roi_valid", "gt_boxes",
            "gt_classes", "gt_valid")), jax.random.PRNGKey(0),
            method=type(jmodel).rcnn_train)
    assert str(got.value) == str(want.value) == NO_MASK_ALTERNATE


def tree(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


@pytest.mark.parametrize("net", ["resnet50_fpn", "resnet101_fpn_mask"])
def test_combine_model_matches_jax_on_fpn_keys(net):
    model = build_model(fpn_cfg(generate_config, net))
    rpn = convert_jax.random_params(model, seed=1)
    rcnn = convert_jax.random_params(model, seed=2)
    got = combine_model(rpn, rcnn)
    want = flatten(j_combine_model(tree(rpn), tree(rcnn)))
    assert got.keys() == want.keys() == rpn.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert any(k.startswith("neck/") for k in got)
    assert (net == "resnet101_fpn_mask") == any(k.startswith("mask_head/")
                                                for k in got)
    for k in got:
        src = rcnn if k.split("/")[0] in ("head_body", "rcnn_out",
                                          "mask_head") else rpn
        np.testing.assert_array_equal(got[k], src[k], err_msg=k)
    with pytest.raises(KeyError, match="backbone"):
        combine_model({k: v for k, v in rpn.items()
                       if not k.startswith("backbone/")}, rcnn)


# ---- checkpoints and resume ------------------------------------------------

def mask_roidb():
    """A synthetic record at the tiny bucket with polygon masks, and its
    mirror."""
    ds = SyntheticDataset(num_images=1, num_classes=21, height=H, width=W,
                          max_objects=3)
    roidb = []
    for rec in ds.gt_roidb():
        segs = [[[x1, y1, x2, (y1 + y2) / 2, (x1 + x2) / 2, y2]]
                for x1, y1, x2, y2 in rec["boxes"].tolist()]
        roidb.append(dict(rec, segmentation=segs))
    return ds.filter_roidb(ds.append_flipped_images(roidb))


def state_of(st):
    return (convert_jax.export_jax_params(st.model),
            export_momentum(st.model, st.optimizer))


def test_fpn_mask_resume_is_bitwise_and_the_state_covers_every_leaf(
        tmp_path):
    cfg = fpn_cfg(generate_config)
    cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, ASSIGN_FUSED=True))
    model = build_model(cfg)
    params = convert_jax.random_params(model, seed=3)
    res = ResilienceOptions(save_every_n_steps=1, nan_policy="skip")

    def loader():
        return t_loader.AnchorLoader(mask_roidb(), cfg, 1, seed=2)

    want = trainer.fit(cfg, model, params, loader(), end_epoch=1,
                       device="cpu", frequent=1, resilience=res)
    want_params, want_mom = state_of(want)
    assert want.step == 2
    # every trainable leaf has momentum, the neck's and the mask head's too
    trained = {k for k, t in want.mask.items() if t}
    assert set(want_mom) == trained
    for group in ("neck/", "mask_head/"):
        assert any(k.startswith(group) for k in trained), group

    prefix = str(tmp_path / "e2e")

    def preempt(epoch, step, metrics):
        if step == 1:
            signal.raise_signal(signal.SIGTERM)

    st = trainer.fit(cfg, model, params, loader(), end_epoch=1, prefix=prefix,
                     device="cpu", frequent=1, resilience=res,
                     batch_end_callback=preempt)
    assert st.step == 1
    mgr = CheckpointManager(prefix)
    assert mgr.latest_resume_point() == ("step", 0, 1)
    saved = mgr.load_step_checkpoint(0, 1)
    assert set(saved["params"]) == set(params)
    assert set(saved["momentum"]) == trained
    st = trainer.fit(cfg, model, params, loader(), end_epoch=1, prefix=prefix,
                     device="cpu", frequent=1,
                     resilience=dataclasses.replace(res, auto_resume=True))
    assert st.step == 2
    got_params, got_mom = state_of(st)
    for got, ref in ((got_params, want_params), (got_mom, want_mom)):
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert set(load_params_npz(epoch_path(prefix, 1))) == set(params)


# ---- the drivers --------------------------------------------------------------

def test_train_end2end_mask_network_then_test(tmp_path):
    argv = ["--synthetic", "--synthetic_images", "2", "--device", "cpu",
            "--network", "resnet101_fpn_mask", "--root_path",
            str(tmp_path / "data")] + TINY_FLAGS
    prefix = str(tmp_path / "mask")
    seen = []
    fit = train_end2end.fit

    def recording(*a, **k):
        st = fit(*a, batch_end_callback=lambda e, s, m: seen.append(m), **k)
        seen.append(st)
        return st

    train_end2end.fit = recording
    try:
        train_end2end.train_net(train_end2end.parse_args(
            argv + ["--prefix", prefix, "--num-steps", "2", "--end_epoch",
                    "1", "--batch_images", "2", "--frequent", "1"]))
    finally:
        train_end2end.fit = fit
    *metrics, st = seen
    assert len(metrics) == 2 and st.step == 2
    for m in metrics:
        assert np.isfinite(m["MaskLoss"]) and m["MaskLoss"] > 0
    out = test_driver.test_rcnn(test_driver.parse_args(
        argv + ["--prefix", prefix, "--epoch", "1", "--batch_images", "2"]))
    assert np.isfinite(out["mAP"])


def test_train_alternate_fpn_then_test(tmp_path, monkeypatch):
    argv = ["--synthetic", "--synthetic_images", "2", "--device", "cpu",
            "--network", "resnet101_fpn", "--root_path",
            str(tmp_path / "data")] + TINY_FLAGS
    monkeypatch.chdir(tmp_path)
    combined = []

    def recording(rpn, rcnn):
        combined.append((rpn, rcnn))
        return combine_model(rpn, rcnn)

    monkeypatch.setattr(train_alternate, "combine_model", recording)
    prefix = str(tmp_path / "alt")
    final = train_alternate.alternate_train(train_alternate.parse_args(
        argv + ["--prefix", prefix, "--num-steps", "1", "--end_epoch", "1",
                "--batch_images", "2"]))
    (s4, s6), = combined
    neck = [k for k in final if k.startswith("neck/")]
    assert neck and not any(k.startswith("mask_head/") for k in final)
    for k in final:
        src = s6 if k.split("/")[0] in ("head_body", "rcnn_out") else s4
        np.testing.assert_array_equal(final[k], src[k], err_msg=k)
    # stage 6 froze the neck: its neck is stage 4's
    for k in neck:
        np.testing.assert_array_equal(s6[k], s4[k], err_msg=k)
    out = test_driver.test_rcnn(test_driver.parse_args(
        argv + ["--prefix", prefix, "--epoch", "1", "--batch_images", "2"]))
    assert np.isfinite(out["mAP"])


def test_drivers_refuse_mask_alternate_and_fpn_serving(tmp_path, monkeypatch):
    from mx_rcnn_tpu_torch.serve import driver
    from mx_rcnn_tpu_torch.tools import train_rpn
    from mx_rcnn_tpu_torch.tools.common import config_from_args

    monkeypatch.setattr(train_rpn, "fit", lambda *a, **k: pytest.fail(
        "a stage ran"))
    argv = ["--synthetic", "--device", "cpu", "--prefix",
            str(tmp_path / "e2e"), "--root_path", str(tmp_path / "data")]
    with pytest.raises(NotImplementedError) as got:
        train_alternate.alternate_train(train_alternate.parse_args(
            argv + ["--network", "resnet101_fpn_mask"]))
    assert str(got.value) == NO_MASK_ALTERNATE
    # FPN serving is no longer refused: the serve driver builds an engine
    # for both networks (their serving parity: tests/test_torch_serve_fpn.py)
    for net in ("resnet101_fpn", "resnet101_fpn_mask"):
        args = driver.parse_args(["--synthetic", "--device", "cpu",
                                  "--network", net, "--cfg",
                                  "network__NETWORK='resnet50'",
                                  "--unix-socket", str(tmp_path / "s.sock")])
        predictor, engine = driver.build_engine(
            args, config_from_args(args, train=False))
        engine.stop()
        assert predictor.model.has_mask == net.endswith("_mask")
    assert not list(tmp_path.iterdir())
