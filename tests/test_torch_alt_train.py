"""The alternate-training graphs and their steps against the JAX package,
on the CPU: ``rpn_train``/``rcnn_train`` losses, two SGD steps of each
graph against ``make_train_step(graph=…)`` with the stage's frozen
prefixes, the LR schedule from ``begin_epoch``, the training flags of
``config_from_args`` and ``init_or_load_params``' overlay.

The tiny detector of ``tests/test_torch_train_step.py`` (resnet50 preset,
128×192, ``ANCHOR_SCALES=(2, 4)``, ``MAX_GT=8``, float32, B = 2, TRAIN
300 → 50 and 32 RoIs).  Each graph splits its step key per image
(``jax.random.split(key, B)``, ``detector.py:225-281``), and the port's
sampling ops get the uniforms drawn from those keys.  Tolerances: losses
rtol 1e-4; gradients and updates by ``test_torch_train_step``'s rule
(1e-3 of the norm, at most one leaf a step off by one ReLU-flipped
channel).  The leaves the step's graph does not reach (the R-CNN head in
an ``rpn`` step, the RPN head in an ``rcnn`` step) are still decayed and
moved by their momentum in optax's chain: their updates must equal JAX's
to 1e-5 of their norm.
"""

import argparse
import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.models import init_params
from mx_rcnn_tpu.tools import common as j_common
from mx_rcnn_tpu.train import create_train_state as j_create_train_state
from mx_rcnn_tpu.train import make_lr_schedule as j_make_lr_schedule
from mx_rcnn_tpu.train import make_train_step as j_make_train_step
from mx_rcnn_tpu.train.train_step import _loss_fn as j_loss_fn

from mx_rcnn_tpu_torch import train_end2end
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.tools import common
from mx_rcnn_tpu_torch.train import optim
from mx_rcnn_tpu_torch.train.checkpoint import save_params_npz
from mx_rcnn_tpu_torch.train.train_step import (create_train_state,
                                                make_train_step)
from mx_rcnn_tpu_torch.utils import convert_jax
from tests.test_torch_train_step import (B, H, W, check_leaves, flatten,
                                         make_batch, rel_err, tiny)

torch.set_num_threads(2)

P = 50  # TRAIN.RPN_POST_NMS_TOP_N of the tiny config: proposals a record
HEADS = {"rpn": ("head_body/", "rcnn_out/"), "rcnn": ("rpn/",)}


@pytest.fixture(scope="module")
def jax_side():
    cfg = tiny(j_generate_config)
    model = j_build_model(cfg)
    params = jax.device_get(init_params(model, cfg, jax.random.PRNGKey(0),
                                        batch_size=1, image_hw=(H, W)))
    return cfg, model, params


def graph_draws(key, name, n):
    """The uniforms a JAX alternate graph draws from its step key: one key
    per image, split into the fg and the bg key of its sampling op."""
    keys = jax.random.split(key, B)
    pairs = [jax.random.split(keys[b]) for b in range(B)]
    return {name: tuple(
        torch.from_numpy(np.stack([np.asarray(jax.random.uniform(p[i], (n,)))
                                   for p in pairs])) for i in range(2))}


def rcnn_batch(seed=0):
    """``make_batch`` plus ``P`` proposals an image in the scaled frame:
    jittered copies of its gt, random boxes, and the last rows invalid."""
    batch = make_batch(seed)
    rng = np.random.RandomState(seed + 1)
    rois = np.zeros((B, P, 4), np.float32)
    valid = np.zeros((B, P), bool)
    for b in range(B):
        gt = batch["gt_boxes"][b][batch["gt_valid"][b]]
        n = P - 7
        jit = gt[rng.randint(len(gt), size=n // 2)] + rng.randn(n // 2, 4) * 4
        x1 = rng.uniform(0, W - 40, n - n // 2)
        y1 = rng.uniform(0, H - 40, n - n // 2)
        rnd = np.stack([x1, y1, x1 + rng.uniform(8, 40, len(x1)),
                        y1 + rng.uniform(8, 40, len(x1))], 1)
        boxes = np.concatenate([jit, rnd])
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, W - 1)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, H - 1)
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2])
        rois[b, :n] = boxes
        valid[b, :n] = True
    batch["rois"], batch["roi_valid"] = rois, valid
    return batch


def n_anchors(cfg):
    return (H // 16) * (W // 16) * cfg.network.NUM_ANCHORS


def graph_args(graph, cfg):
    if graph == "rpn":
        return ("rpn_train", "rpn", n_anchors(cfg),
                ("images", "im_info", "gt_boxes", "gt_valid"),
                ("rpn_cls_loss", "rpn_bbox_loss"))
    return ("rcnn_train", "rcnn", P + cfg.tpu.MAX_GT,
            ("images", "im_info", "rois", "roi_valid", "gt_boxes",
             "gt_classes", "gt_valid"), ("rcnn_cls_loss", "rcnn_bbox_loss"))


@pytest.mark.parametrize("graph", ["rpn", "rcnn"])
def test_graph_losses_match_jax(jax_side, graph):
    """``rpn_train``/``rcnn_train`` against ``model.apply(..., method=…)``
    on carried weights and the JAX graph's own uniforms."""
    jcfg, jmodel, params = jax_side
    method, name, n, keys, losses = graph_args(graph, jcfg)
    batch = rcnn_batch()
    key = jax.random.PRNGKey(7)
    total, aux = jax.device_get(jmodel.apply(
        {"params": params}, *[batch[k] for k in keys], key,
        method=getattr(type(jmodel), method)))

    cfg = tiny(generate_config)
    model = build_model(cfg)
    convert_jax.load_jax_params(model, flatten(params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got_total, got = getattr(model, method)(
            *[tb[k] for k in keys], draws=graph_draws(key, name, n))
    assert set(got) == set(aux)
    for k in losses:
        np.testing.assert_allclose(float(got[k]), float(aux[k]), rtol=1e-4)
        assert float(aux[k]) > 0, k
    np.testing.assert_allclose(float(got_total), float(total), rtol=1e-4)
    label = "rpn_label" if graph == "rpn" else "rcnn_label"
    np.testing.assert_array_equal(got[label].numpy(), aux[label])


@pytest.mark.parametrize("graph,shared", [("rpn", True), ("rcnn", False)],
                         ids=["rpn-shared", "rcnn"])
def test_two_steps_match_make_train_step(jax_side, graph, shared):
    """Losses, clipped gradients and updates of two SGD steps (momentum
    carried) against the JAX step of the same graph and frozen prefixes;
    the untouched head's updates (decay and momentum only) to 1e-5."""
    jcfg, jmodel, params = jax_side
    fixed = (jcfg.network.FIXED_PARAMS_SHARED if shared
             else jcfg.network.FIXED_PARAMS)
    method, name, n, keys, losses = graph_args(graph, jcfg)
    state, tx, mask = j_create_train_state(jcfg, params, steps_per_epoch=10,
                                           fixed_prefixes=fixed)
    jstep = j_make_train_step(jmodel, tx, graph=graph, trainable_mask=mask,
                              donate=False)

    @jax.jit
    def jgrads(p, batch, key):
        def loss(q):
            q = jax.tree.map(lambda v, t: v if t else jax.lax.stop_gradient(v),
                             q, mask)
            return j_loss_fn(q, jmodel, batch, key, graph)
        return jax.value_and_grad(loss, has_aux=True)(p)

    cfg = tiny(generate_config)
    model = build_model(cfg)
    convert_jax.load_jax_params(model, flatten(params))
    tstate = create_train_state(cfg, model, steps_per_epoch=10,
                                fixed_prefixes=fixed)
    assert tstate.mask == {k: bool(v) for k, v in flatten(mask).items()}
    tstep = make_train_step(cfg, graph)
    batch = {k: v for k, v in rcnn_batch().items()
             if graph == "rcnn" or k not in ("rois", "roi_valid")}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    trained = [k for k, t in tstate.mask.items() if t]
    heads = [k for k in trained if k.startswith(HEADS[graph])]
    assert heads
    for i in range(2):
        key = jax.random.PRNGKey(100 + i)
        before = flatten(jax.device_get(state.params))
        (_, aux), grads = jax.device_get(jgrads(state.params, batch, key))
        state, _ = jstep(state, batch, key)
        after = flatten(jax.device_get(state.params))
        grads = flatten(grads)

        _, metrics = tstep(tstate, tbatch, draws=graph_draws(key, name, n))
        for k, mk in zip(losses, (("RPNLogLoss", "RPNL1Loss") if graph == "rpn"
                                  else ("RCNNLogLoss", "RCNNL1Loss"))):
            np.testing.assert_allclose(float(metrics[mk]), float(aux[k]),
                                       rtol=1e-4)
        now = convert_jax.export_jax_params(model)
        names = convert_jax.jax_names(model)
        g_port, g_jax = {}, {}
        for pname, p in model.named_parameters():
            k = names[pname]
            if not tstate.mask[k]:
                assert p.grad is None
                np.testing.assert_array_equal(now[k], before[k])
                np.testing.assert_array_equal(after[k], before[k])
                continue
            g_jax[k] = np.clip(grads[k], -jcfg.TRAIN.CLIP_GRADIENT,
                               jcfg.TRAIN.CLIP_GRADIENT)
            g_port[k] = convert_jax._to_jax(
                "kernel" if p.dim() > 1 else "bias", p.grad)
        d_port = {k: now[k] - before[k] for k in trained}
        d_jax = {k: after[k] - before[k] for k in trained}
        check_leaves(g_port, g_jax, trained, f"gradient, step {i}")
        check_leaves(d_port, d_jax, trained, f"update, step {i}")
        for k in heads:
            assert not g_jax[k].any() and not g_port[k].any(), k
            # a leaf at 0 (the biases at init) has nothing to decay
            assert np.abs(d_jax[k]).max() > 0 or not before[k].any(), k
            assert rel_err(d_port[k], d_jax[k]) < 1e-5, (k, i)
        convert_jax.load_jax_params(model, after)


def test_rpn_step_decays_the_untouched_head(jax_side):
    """``torch.optim.SGD`` skips a leaf without a gradient; optax decays
    it.  After the first ``rpn`` step each R-CNN head leaf has a zero
    gradient and the momentum ``wd · w``, and has moved; an unknown graph
    raises."""
    _, _, params = jax_side
    cfg = tiny(generate_config)
    model = build_model(cfg)
    convert_jax.load_jax_params(model, flatten(params))
    tstate = create_train_state(cfg, model, steps_per_epoch=10)
    tbatch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    make_train_step(cfg, "rpn")(tstate, tbatch,
                                generator=torch.Generator().manual_seed(0))
    heads = [(n, p) for n, p in model.named_parameters()
             if n.startswith(("head_body.", "rcnn_out.")) and p.requires_grad]
    assert heads
    for n, p in heads:
        assert not p.grad.any(), n
        buf = tstate.optimizer.state[p]["momentum_buffer"]
        torch.testing.assert_close(buf, cfg.TRAIN.WD * before[n], rtol=1e-6,
                                   atol=0)
    p = model.rcnn_out.cls_score.weight
    assert not torch.equal(p, before["rcnn_out.cls_score.weight"])
    with pytest.raises(ValueError, match="graph"):
        make_train_step(cfg, "mask")


@pytest.mark.parametrize("begin_epoch", [0, 1, 3])
@pytest.mark.parametrize("warmup", [False, True], ids=["plain", "warmup"])
def test_lr_schedule_from_begin_epoch_matches_jax(begin_epoch, warmup):
    kw = dict(LR=0.01, LR_STEP=(2, 4, 5), LR_FACTOR=0.1)
    if warmup:
        kw.update(WARMUP=True, WARMUP_LR=1e-4, WARMUP_STEP=5)
    mine_cfg, ref_cfg = (c.replace(TRAIN=dataclasses.replace(c.TRAIN, **kw))
                         for c in (tiny(generate_config),
                                   tiny(j_generate_config)))
    mine = optim.make_lr_schedule(mine_cfg, 10, begin_epoch)
    ref = j_make_lr_schedule(ref_cfg, 10, begin_epoch)
    for step in range(60):
        np.testing.assert_allclose(mine(step), float(ref(step)), rtol=1e-5,
                                   err_msg=f"step {step}")


def jax_args(argv):
    parser = argparse.ArgumentParser()
    j_common.add_common_args(parser, train=True)
    return parser.parse_args(argv)


@pytest.mark.parametrize("flags", [
    [], ["--lr", "0.02"], ["--lr_step", "3,5"], ["--no_flip"],
    ["--no_shuffle"],
    ["--lr", "0.003", "--lr_step", "3,5", "--no_flip", "--no_shuffle"]],
    ids=["none", "lr", "lr_step", "no_flip", "no_shuffle", "all"])
def test_config_from_args_matches_jax(flags):
    argv = ["--network", "resnet50", "--synthetic"] + flags
    got = common.config_from_args(train_end2end.parse_args(argv), train=True)
    want = j_common.config_from_args(jax_args(argv), train=True)
    # the one default the port sets apart on purpose (config.py: PREFETCH)
    assert got.tpu.PREFETCH == 0 and want.tpu.PREFETCH == 2
    want = want.replace(tpu=dataclasses.replace(want.tpu, PREFETCH=0))
    for section in ("TRAIN", "TEST", "network", "tpu", "dataset"):
        assert (dataclasses.asdict(getattr(got, section))
                == dataclasses.asdict(getattr(want, section))), section
    args = train_end2end.parse_args(argv + ["--pretrained_epoch", "3",
                                            "--batch_images", "4",
                                            "--begin_epoch", "2"])
    assert (args.pretrained_epoch, args.batch_images, args.begin_epoch) == \
        (3, 4, 2)


@pytest.mark.parametrize("kind", ["full", "backbone", "mismatch"])
def test_init_or_load_params_overlays_as_jax(jax_side, tmp_path, caplog,
                                             kind):
    """A full checkpoint, a backbone-only one and one with a misshapen
    leaf: the port takes a file's leaf exactly where the JAX ``_overlay``
    does, keeps its own seeded init elsewhere, and warns on the shape
    mismatch."""
    jcfg, jmodel, jparams = jax_side
    cfg = tiny(generate_config)
    model = build_model(cfg)
    ckpt = convert_jax.random_params(model, seed=7)
    if kind == "backbone":
        ckpt = {k: v for k, v in ckpt.items() if k.startswith("backbone/")}
    bad = "rcnn_out/cls_score/kernel"
    if kind == "mismatch":
        ckpt[bad] = np.zeros((2048, 20), np.float32)
    path = str(tmp_path / "pre.npz")
    save_params_npz(path, ckpt)

    want = flatten(jax.device_get(j_common.init_or_load_params(
        argparse.Namespace(pretrained=path), jcfg, jmodel, 1)))
    base = flatten(jparams)
    args = train_end2end.parse_args(["--pretrained", path, "--seed", "3"])
    with caplog.at_level(logging.WARNING, logger="mx_rcnn_tpu_torch"):
        got = common.init_or_load_params(args, model)
    init = convert_jax.random_params(model, seed=3)
    assert got.keys() == want.keys() == init.keys()
    taken = 0
    for k in got:
        from_file = k in ckpt and ckpt[k].shape == init[k].shape
        if from_file:
            np.testing.assert_array_equal(want[k], ckpt[k])
            np.testing.assert_array_equal(got[k], ckpt[k])
            taken += 1
        else:
            np.testing.assert_array_equal(want[k], base[k])
            np.testing.assert_array_equal(got[k], init[k])
    assert taken == {"full": len(init), "mismatch": len(init) - 1,
                     "backbone": sum(k.startswith("backbone/")
                                     for k in init)}[kind]
    warned = [r for r in caplog.records if r.name == "mx_rcnn_tpu_torch"
              and "shape mismatch" in r.getMessage()]
    assert len(warned) == (kind == "mismatch") and \
        (not warned or bad in warned[0].getMessage())
    with pytest.raises(FileNotFoundError):
        common.init_or_load_params(train_end2end.parse_args(
            ["--pretrained", str(tmp_path / "none.npz")]), model)
    np.testing.assert_array_equal(
        common.init_or_load_params(train_end2end.parse_args([]),
                                   model)["rpn/rpn_conv_3x3/kernel"],
        convert_jax.random_params(model, 0)["rpn/rpn_conv_3x3/kernel"])


def test_export_owns_its_memory():
    """An export taken before a train step on the CPU is unchanged by it:
    the exported arrays do not alias the model's tensors."""
    cfg = tiny(generate_config)
    model = build_model(cfg)
    convert_jax.load_jax_params(model, convert_jax.random_params(model, 1))
    before = convert_jax.export_jax_params(model)
    kept = {k: v.copy() for k, v in before.items()}
    tstate = create_train_state(cfg, model, steps_per_epoch=10)
    tbatch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    make_train_step(cfg)(tstate, tbatch,
                         generator=torch.Generator().manual_seed(0))
    after = convert_jax.export_jax_params(model)
    assert any(not np.array_equal(after[k], kept[k]) for k in kept
               if k.endswith("/bias"))
    for k, v in kept.items():
        np.testing.assert_array_equal(before[k], v, err_msg=k)


CHECKPOINT_FLAGS = [(["--resume"], "--resume", {"resume": True}),
                    (["--auto-resume"], "--auto-resume",
                     {"auto_resume": True}),
                    (["--save-every-n-steps", "2"], "--save-every-n-steps",
                     {"save_every_n_steps": 2}),
                    (["--nan-policy", "rollback"], "--nan-policy rollback",
                     {"nan_policy": "rollback"})]


@pytest.mark.parametrize("flags,name,attrs", CHECKPOINT_FLAGS,
                         ids=[c[1] for c in CHECKPOINT_FLAGS])
def test_alternate_refuses_checkpoint_flags(capsys, flags, name, attrs):
    """The alternate stages write no checkpoints: each flag that needs one
    is refused by the parser, naming it, and by ``alternate_train`` before
    any data is read."""
    from mx_rcnn_tpu_torch import train_alternate

    with pytest.raises(SystemExit):
        train_alternate.parse_args(["--synthetic"] + flags)
    assert name in capsys.readouterr().err
    args = train_alternate.parse_args(["--synthetic", "--device", "cpu",
                                       "--root_path", "/nonexistent"])
    vars(args).update(attrs)
    with pytest.raises(ValueError, match=name):
        train_alternate.alternate_train(args)


@pytest.mark.parametrize("policy", ["off", "halt", "skip"])
def test_alternate_accepts_the_other_nan_policies(policy):
    from mx_rcnn_tpu_torch import train_alternate
    from mx_rcnn_tpu_torch.train.resilience import ResilienceOptions

    args = train_alternate.parse_args(["--synthetic", "--nan-policy",
                                       policy])
    assert ResilienceOptions.from_args(args).nan_policy == policy
