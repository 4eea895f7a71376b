"""VGG-16 Faster R-CNN training of the port against the JAX package, on the
CPU: the trainable masks, the three training graphs (``forward``,
``rpn_train``, ``rcnn_train``) with the JAX graph's own uniforms and
dropout masks, and the drivers at ``--network vgg16``: ``train_end2end``
from a converted torchvision ``vgg16``, ``test`` on its checkpoint, an
epoch ``--resume`` bitwise equal to the uninterrupted run (dropout
included), one served request in each mode, and ``train_alternate``.

The model is at VGG-16's full width; the rest is tiny: B = 2 of 128×192,
``ANCHOR_SCALES=(2, 4)``, ``PIXEL_STDS=127``, TRAIN 300 → 50 proposals and
``BATCH_ROIS`` 8, ``MAX_GT`` 8, float32.  The JAX masks are read by
intercepting flax's ``Dropout`` calls (``flax.linen.intercept_methods``)
inside the jitted loss: ``keep = out != 0`` (a ReLU zero reads as dropped,
which changes neither output nor gradient).  Tolerances as
``tests/test_torch_train_step.py``: losses rtol 1e-4; the gradients
within 1e-3 of their norm over all trainable leaves and per leaf, at most
one leaf a step off by one ReLU-flipped output channel.
"""

import dataclasses
import os
import shutil

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.models import init_params
from mx_rcnn_tpu.train import fixed_param_mask as j_fixed_param_mask
from mx_rcnn_tpu.train.train_step import _loss_fn as j_loss_fn

from mx_rcnn_tpu_torch import test as test_driver
from mx_rcnn_tpu_torch import train_alternate, train_end2end
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data.image import stage_raw_to_bucket
from mx_rcnn_tpu_torch.eval.tester import im_detect
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.ops import postprocess as post
from mx_rcnn_tpu_torch.serve import ServeEngine
from mx_rcnn_tpu_torch.serve import driver as serve_driver
from mx_rcnn_tpu_torch.tools.common import config_from_args
from mx_rcnn_tpu_torch.train import optim
from mx_rcnn_tpu_torch.train.checkpoint import epoch_path, load_params_npz
from mx_rcnn_tpu_torch.utils import convert_jax, convert_torch
from tests.test_torch_alt_train import graph_draws, rcnn_batch
from tests.test_torch_train_step import (B, H, W, flatten, jax_draws,
                                         make_batch, rel_err)
from tests.test_torch_vgg_model import caught_dropout, keep_masks

torch.set_num_threads(2)

OVERRIDES = dict(TRAIN__RPN_PRE_NMS_TOP_N=300, TRAIN__RPN_POST_NMS_TOP_N=50,
                 TRAIN__BATCH_ROIS=8)
LOSSES = {"end2end": ("rpn_cls_loss", "rpn_bbox_loss", "rcnn_cls_loss",
                      "rcnn_bbox_loss"),
          "rpn": ("rpn_cls_loss", "rpn_bbox_loss"),
          "rcnn": ("rcnn_cls_loss", "rcnn_bbox_loss")}
P = 50  # the proposals a record of tests/test_torch_alt_train.py's batch
# the drivers' tiny settings (the synthetic set's PIXEL_STDS=127 stated
# for the serve driver, which reads a checkpoint)
TINY_CFG = [f"--cfg={c}" for c in (
    f"tpu__SCALES=(({H},{W}),)", "network__ANCHOR_SCALES=(2,4)",
    "network__PIXEL_STDS=(127.0,127.0,127.0)", "tpu__MAX_GT=8",
    "tpu__COMPUTE_DTYPE='float32'", "TRAIN__RPN_PRE_NMS_TOP_N=300",
    "TRAIN__RPN_POST_NMS_TOP_N=50", "TRAIN__BATCH_ROIS=8",
    "TEST__RPN_PRE_NMS_TOP_N=300", "TEST__RPN_POST_NMS_TOP_N=50",
    "TEST__THRESH=0.01")]
TINY = ["--network", "vgg16", "--device", "cpu"] + TINY_CFG
SYNTHETIC = TINY + ["--synthetic", "--synthetic_images", "2"]


def tiny(gen):
    cfg = gen("vgg16", "PascalVOC", **OVERRIDES)
    net = dataclasses.replace(cfg.network, ANCHOR_SCALES=(2, 4),
                              PIXEL_STDS=(127.0, 127.0, 127.0))
    tpu = dataclasses.replace(cfg.tpu, SCALES=((H, W),), MAX_GT=8,
                              COMPUTE_DTYPE="float32")
    return cfg.replace(network=net, tpu=tpu)


@pytest.fixture(scope="module")
def jax_side():
    cfg = tiny(j_generate_config)
    model = j_build_model(cfg)
    params = jax.device_get(init_params(model, cfg, jax.random.PRNGKey(0),
                                        batch_size=1, image_hw=(H, W)))
    return cfg, model, params


@pytest.fixture(scope="module")
def port_model(jax_side):
    model = build_model(tiny(generate_config))
    convert_jax.load_jax_params(model, flatten(jax_side[2]))
    return model


@pytest.mark.parametrize("shared", [False, True], ids=["fixed", "shared"])
def test_trainable_mask_matches_jax(jax_side, port_model, shared):
    """``FIXED_PARAMS`` (conv1, conv2) and ``FIXED_PARAMS_SHARED``
    (conv1 … conv5) on the VGG keys: ``conv1_1_kernel`` matches the
    prefix ``conv1``; no FrozenBN leaf, so nothing is refused."""
    cfg, _, params = jax_side
    net = cfg.network
    fixed = net.FIXED_PARAMS_SHARED if shared else net.FIXED_PARAMS
    want = flatten(j_fixed_param_mask(params, fixed))
    got = optim.apply_param_mask(port_model, fixed)
    assert got == {k: bool(v) for k, v in want.items()}
    frozen = sorted(k for k, t in got.items() if not t)
    blocks = 5 if shared else 2
    assert frozen == sorted(k for k in got if k.startswith("backbone/conv")
                            and int(k[len("backbone/conv")]) <= blocks)
    names = convert_jax.jax_names(port_model)
    for name, p in port_model.named_parameters():
        assert p.requires_grad == got[names[name]], name
    assert got["head_body/fc6/kernel"] and got["rpn/rpn_conv_3x3/kernel"]


def depth(key: str) -> tuple:
    """A leaf's height in the network, for the backward's order: the
    output layer, fc7, fc6, the RPN, then conv5_3 down to conv1_1."""
    group, name = key.split("/")[:2]
    if group == "backbone":
        return (0, int(name[4]), int(name[6]))
    return (1, {"rpn": 0, "head_body": 1 if name == "fc6" else 2,
                "rcnn_out": 3}[group], 0)


def check_vgg_leaves(got, want, what):
    """``tests/test_torch_train_step.py``'s rule, with what a ReLU flip
    does in a plain conv stack.  All leaves within 1e-3 of their norm
    together, and each alone but for one flipped layer (the highest leaf
    off by 1e-4 or more) and the leaves below it: the two libraries' activations differ by ~1e-6, so an
    activation that close to 0 takes the other ReLU branch in one of
    them.  That moves the flipped layer's kernel and bias gradients in one
    output channel (1e-3 without it, 1e-2 with it), and every leaf that
    the gradient reaches through that element afterwards, as a whole
    (each within 5e-3).  Measured at this seed: one flip in conv4_2's
    channel 299 (1.6e-3 of that leaf), 0.7–1.8e-3 in conv3_1 … conv4_1,
    all leaves above it within 2e-6."""
    keys = sorted(got, key=depth, reverse=True)
    assert got.keys() == want.keys()
    assert rel_err(np.concatenate([got[k].ravel() for k in keys]),
                   np.concatenate([want[k].ravel() for k in keys])) < 1e-3
    moved = [k for k in keys if rel_err(got[k], want[k]) >= 1e-4]
    if not moved:
        return
    flipped = depth(moved[0])  # the highest leaf off by more than 1e-4
    for k in moved:
        err = rel_err(got[k], want[k])
        if depth(k) < flipped:
            assert err < 5e-3, (what, k, err)
            continue
        g = got[k].reshape(-1, got[k].shape[-1])
        w = want[k].reshape(-1, want[k].shape[-1])
        ch = int(np.argmax(np.linalg.norm(g - w, axis=0)))
        rest = np.arange(w.shape[1]) != ch
        assert err < 1e-2 and rel_err(g[:, rest], w[:, rest]) < 1e-3, \
            (what, k, err)


def graph_inputs(graph, cfg):
    """(method, batch, keys of its arguments, its draws but dropout)."""
    n_anchors = (H // 16) * (W // 16) * cfg.network.NUM_ANCHORS
    if graph == "end2end":
        batch = make_batch()
        return (None, batch, ("images", "im_info", "gt_boxes", "gt_classes",
                              "gt_valid"),
                lambda key: jax_draws(key, n_anchors,
                                      cfg.TRAIN.RPN_POST_NMS_TOP_N
                                      + cfg.tpu.MAX_GT))
    if graph == "rpn":
        batch = {k: v for k, v in make_batch().items() if k != "gt_classes"}
        return ("rpn_train", batch, ("images", "im_info", "gt_boxes",
                                     "gt_valid"),
                lambda key: graph_draws(key, "rpn", n_anchors))
    return ("rcnn_train", rcnn_batch(), ("images", "im_info", "rois",
                                         "roi_valid", "gt_boxes",
                                         "gt_classes", "gt_valid"),
            lambda key: graph_draws(key, "rcnn", P + cfg.tpu.MAX_GT))


@pytest.mark.parametrize("graph", ["end2end", "rpn", "rcnn"])
def test_graph_matches_jax_with_its_dropout_masks(jax_side, port_model,
                                                  graph):
    """One step of each training graph against the JAX ``_loss_fn`` on the
    same weights, batch, uniforms and (for the graphs with the R-CNN
    head) dropout masks: the total and every loss, the labels, and the
    gradients of the trainable leaves (``FIXED_PARAMS`` frozen)."""
    jcfg, jmodel, params = jax_side
    cfg = tiny(generate_config)
    mask = j_fixed_param_mask(params, jcfg.network.FIXED_PARAMS)
    method, batch, keys, draws_of = graph_inputs(graph, cfg)

    @jax.jit
    def jgrads(p, b, key):
        def loss(q):
            q = jax.tree.map(lambda v, t: v if t else jax.lax.stop_gradient(v),
                             q, mask)
            icpt, caught = caught_dropout()
            with fnn.intercept_methods(icpt):
                total, aux = j_loss_fn(q, jmodel, b, key, graph)
            return total, (aux, caught)
        return jax.value_and_grad(loss, has_aux=True)(p)

    key = jax.random.PRNGKey(7)
    (total, (aux, caught)), grads = jax.device_get(jgrads(params, batch, key))
    grads = flatten(grads)
    draws = draws_of(key)
    if graph == "rpn":
        assert not caught
    else:
        keep = keep_masks(caught)
        assert [tuple(k.shape) for k in keep] == [(B, 8, 4096)] * 2
        draws["dropout"] = keep

    model = port_model
    convert_jax.load_jax_params(model, flatten(params))
    trained = optim.apply_param_mask(model, cfg.network.FIXED_PARAMS)
    model.zero_grad(set_to_none=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    fn = model if method is None else getattr(model, method)
    got_total, got = fn(*[tb[k] for k in keys], draws=draws)
    got_total.backward()
    assert set(got) == set(aux)
    for k in LOSSES[graph]:
        np.testing.assert_allclose(float(got[k].detach()), float(aux[k]),
                                   rtol=1e-4)
        assert float(aux[k]) > 0, k
    np.testing.assert_allclose(float(got_total.detach()), float(total),
                               rtol=1e-4)
    for k in ("rpn_label", "rcnn_label"):
        if k in aux:
            np.testing.assert_array_equal(got[k].numpy(), aux[k])
    names = convert_jax.jax_names(model)
    g_port, g_jax = {}, {}
    for pname, p in model.named_parameters():
        k = names[pname]
        if not trained[k]:
            assert p.grad is None, k
            continue
        if p.grad is None:  # a leaf the graph does not reach
            assert not grads[k].any(), k
            continue
        g_port[k] = convert_jax._to_jax("kernel" if p.dim() > 1 else "bias",
                                        p.grad)
        g_jax[k] = grads[k]
    if graph != "rpn":
        assert {"head_body/fc6/kernel", "head_body/fc7/kernel"} <= set(g_port)
    check_vgg_leaves(g_port, g_jax, f"gradient, {graph}")
    model.zero_grad(set_to_none=True)


def test_dropout_draws_follow_the_generator(port_model):
    """Without ``draws["dropout"]`` the masks come from the step's
    generator: the same seed gives the same losses, another seed other
    ones, and an injected pair decides the head alone."""
    cfg = tiny(generate_config)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    args = [batch[k] for k in ("images", "im_info", "gt_boxes", "gt_classes",
                               "gt_valid")]
    n_anchors = (H // 16) * (W // 16) * cfg.network.NUM_ANCHORS
    base = jax_draws(jax.random.PRNGKey(1), n_anchors,
                     cfg.TRAIN.RPN_POST_NMS_TOP_N + cfg.tpu.MAX_GT)

    def run(seed, keep=None):
        draws = dict(base, **({"dropout": keep} if keep is not None else {}))
        with torch.no_grad():
            return port_model(*args, draws=draws,
                              generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert float(a[0]) == float(b[0]) and float(a[0]) != float(c[0])
    ones = tuple(torch.ones(B, 8, 4096, dtype=torch.bool) for _ in range(2))
    d, e = run(0, ones), run(1, ones)
    assert float(d[0]) == float(e[0])


# ---- the drivers -------------------------------------------------------------

def torchvision_vgg16(seed=0):
    """A torchvision-layout ``vgg16`` state dict of torch tensors, each
    weight uniform with variance 1/fan_in (so that 13 layers neither
    vanish nor blow up), biases 0.01."""
    rng = np.random.default_rng(seed)
    chans = [(64, 3), (64, 64), (128, 64), (128, 128), (256, 128),
             (256, 256), (256, 256), (512, 256), (512, 512), (512, 512),
             (512, 512), (512, 512), (512, 512)]
    shapes = {f"features.{i}": (o, c, 3, 3)
              for i, (o, c) in zip(convert_torch._VGG_CONV_IDX, chans)}
    shapes.update({"classifier.0": (4096, 25088), "classifier.3": (4096, 4096),
                   "classifier.6": (1000, 4096)})
    sd = {}
    for name, shape in shapes.items():
        bound = np.sqrt(3.0 / np.prod(shape[1:]))
        sd[f"{name}.weight"] = torch.from_numpy(
            ((rng.random(shape) * 2 - 1) * bound).astype(np.float32))
        sd[f"{name}.bias"] = torch.full((shape[0],), 0.01)
    return sd


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train_end2end --network vgg16`` two epochs of one step from a
    converted torchvision ``vgg16`` (``--pretrained``); the module's
    checkpoints are removed after its last test."""
    tmp = tmp_path_factory.mktemp("vgg")
    pth = tmp / "vgg16.pth"
    torch.save(torchvision_vgg16(), pth)
    npz = str(tmp / "vgg16.npz")
    convert_torch.convert_file(str(pth), "vgg16", npz)
    pth.unlink()
    prefix = str(tmp / "run" / "e2e")
    # without shuffle: an epoch --resume does not advance the loader past
    # the epochs before it (the reference's --resume), so only an unshuffled
    # epoch plan gives the resumed epoch the uninterrupted run's batch
    flags = SYNTHETIC + ["--num-steps", "1", "--batch_images", "2",
                         "--no_shuffle", "--pretrained", npz]
    state = train_end2end.train_net(train_end2end.parse_args(
        flags + ["--end_epoch", "2", "--prefix", prefix]))
    yield {"tmp": tmp, "npz": npz, "prefix": prefix, "flags": flags,
           "state": state, "mask": dict(state.mask)}
    shutil.rmtree(tmp)  # ~5 GB of checkpoints at VGG's width


def test_end2end_from_torchvision_weights(trained):
    """Every converted key is a key of the model, every ``backbone`` and
    ``head_body`` key is converted; the epoch checkpoints keep the
    ``FIXED_PARAMS`` leaves (conv1_*, conv2_*) at the converted values
    and move conv3–conv5, fc6, fc7, the RPN and the output layer."""
    conv = load_params_npz(trained["npz"])
    model_keys = convert_jax.param_shapes(trained["state"].model)
    assert set(conv) <= set(model_keys)
    assert {k for k in model_keys if k.split("/")[0] in ("backbone",
                                                         "head_body")} \
        == set(conv)
    for k, v in conv.items():
        assert v.shape == model_keys[k], k
    assert trained["state"].step == 2
    e1 = load_params_npz(epoch_path(trained["prefix"], 1))
    e2 = load_params_npz(epoch_path(trained["prefix"], 2))
    for k in conv:
        frozen = k.startswith(("backbone/conv1_", "backbone/conv2_"))
        assert trained["mask"][k] is not frozen, k
        if frozen:
            np.testing.assert_array_equal(e2[k], conv[k], err_msg=k)
        else:
            assert not np.array_equal(e1[k], conv[k]), k
    for k in ("rpn/rpn_conv_3x3/kernel", "rcnn_out/cls_score/kernel",
              "head_body/fc6/kernel", "head_body/fc7/bias"):
        assert not np.array_equal(e1[k], e2[k]), k
        assert np.isfinite(e2[k]).all(), k


def test_test_driver_on_the_vgg_checkpoint(trained):
    args = test_driver.parse_args(SYNTHETIC + [
        "--prefix", trained["prefix"], "--epoch", "2", "--batch_images",
        "2", "--eval-inflight", "0"])
    out = test_driver.test_rcnn(args)
    assert np.isfinite(out["mAP"]) and 0.0 <= out["mAP"] <= 1.0


def test_epoch_resume_is_bitwise(trained):
    """``--resume --begin_epoch 1`` from the run's epoch-1 checkpoint
    repeats epoch 2 bitwise: the generator's state in the checkpoint
    redraws the same anchor, RoI and dropout draws."""
    prefix = str(trained["tmp"] / "resumed" / "e2e")
    os.makedirs(os.path.dirname(prefix))
    src = epoch_path(trained["prefix"], 1)
    for a, b in ((src, epoch_path(prefix, 1)),
                 (src.replace(".npz", ".state.npz"),
                  epoch_path(prefix, 1).replace(".npz", ".state.npz"))):
        shutil.copy(a, b)
    st = train_end2end.train_net(train_end2end.parse_args(
        trained["flags"] + ["--end_epoch", "2", "--prefix", prefix,
                            "--resume", "--begin_epoch", "1"]))
    assert st.step == 2
    want = load_params_npz(epoch_path(trained["prefix"], 2))
    got = load_params_npz(epoch_path(prefix, 2))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("e2e", [False, True], ids=["host_nms", "e2e"])
def test_serve_answers_a_request(trained, e2e):
    """``serve.driver.build_engine`` at ``--network vgg16`` (warmup at
    stride 16), one request in host-NMS and in e2e mode, each reply equal
    to the offline records of the same image."""
    args = serve_driver.parse_args(TINY + [
        "--prefix", trained["prefix"], "--epoch", "2", "--serve-batch", "1",
        "--unix-socket", "unused"] + (["--serve-e2e"] if e2e else []))
    cfg = config_from_args(args, train=False)
    img = np.random.RandomState(5).randint(0, 256, (100, 150, 3), np.uint8)
    pred, engine = serve_driver.build_engine(args, cfg)
    try:
        assert isinstance(engine, ServeEngine)
        reply = engine.submit(img, deadline_ms=0).result(timeout=300)
    finally:
        engine.stop()
    te = cfg.TEST
    staged = stage_raw_to_bucket(img, cfg.tpu.SCALES[0], 16)
    batch = pred.batch_put({k: staged[i][None] for i, k in enumerate(
        ("images", "raw_hw", "prep_ratio", "im_info"))})
    if e2e:
        dets, valid = pred.predict_detections(batch["images"],
                                              batch["im_info"],
                                              te.MAX_PER_IMAGE, te.THRESH)
        per_cls = post.device_dets_to_per_class(dets.numpy()[0],
                                                valid.numpy()[0],
                                                cfg.NUM_CLASSES)
    else:
        (sc, bx, va), = im_detect(pred, batch)
        per_cls = post.per_class_nms(sc, bx, va, cfg.NUM_CLASSES, te.THRESH,
                                     te.NMS, te.MAX_PER_IMAGE)
    want = post.detections_to_records(per_cls)
    assert reply and len(reply) == len(want)
    for d, e in zip(reply, want):
        assert d["cls"] == e["cls"]
        assert abs(d["score"] - e["score"]) <= 1e-6
        np.testing.assert_allclose(d["bbox"], e["bbox"], rtol=0, atol=1e-3)


def test_train_alternate_at_vgg16(trained):
    """``train_alternate --network vgg16``, one step a training stage:
    the final model has every VGG key, finite, and its backbone is the
    stage-4 RPN's (FIXED_PARAMS_SHARED freezes it in stage 6)."""
    stages = {}
    saved = {n: getattr(train_alternate, n) for n in ("train_rpn",
                                                      "train_rcnn")}

    def keep(name):
        def run(*a, **k):  # stages 4 and 6 keep their weights
            st = saved[name](*a, **k)
            calls = stages.setdefault(name, [])
            calls.append(convert_jax.export_jax_params(st.model)
                         if calls else None)
            return st
        return run

    prefix = str(trained["tmp"] / "alt" / "alt")
    for n in saved:
        setattr(train_alternate, n, keep(n))
    try:
        final = train_alternate.alternate_train(train_alternate.parse_args(
            trained["flags"] + ["--end_epoch", "1", "--prefix", prefix,
                                "--root_path", str(trained["tmp"] / "data")]))
    finally:
        for n, f in saved.items():
            setattr(train_alternate, n, f)
    assert [len(stages[n]) for n in ("train_rpn", "train_rcnn")] == [2, 2]
    s4, s6 = stages["train_rpn"][1], stages["train_rcnn"][1]
    want = convert_jax.param_shapes(build_model(tiny(generate_config)))
    assert {k: v.shape for k, v in final.items()} == want
    for k, v in final.items():
        assert np.isfinite(v).all(), k
        src = s6 if k.split("/")[0] in ("head_body", "rcnn_out") else s4
        np.testing.assert_array_equal(v, src[k], err_msg=k)
        if k.startswith("backbone/"):
            np.testing.assert_array_equal(s6[k], s4[k], err_msg=k)
    saved_final = load_params_npz(epoch_path(prefix, 1))
    assert saved_final.keys() == final.keys()
