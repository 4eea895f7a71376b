"""The port's training slice against the JAX package, on the CPU: the
trainable mask, the weight bridge both ways, two whole train steps
against ``make_train_step`` (so that momentum counts), and ``fit`` end to
end with an epoch checkpoint that ``Predictor`` serves.

The tiny detector of ``tests/test_torch_port_model.py`` (resnet50 preset,
128×192, ``ANCHOR_SCALES=(2, 4)``, ``MAX_GT=8``) in float32 with B = 2,
the TRAIN proposal settings cut to 300 → 50 and 32 sampled RoIs.  The
port's sampling ops get the uniforms the JAX step draws from its key
(``detector.py:117``, ``assign_anchor.py:151``, ``sample_rois.py:84``).
Tolerances: losses rtol 1e-4.  The (clipped) gradients and each step's
parameter updates within 1e-3 of their norm over all trainable leaves,
and within 1e-3 per leaf, with one exception of a known cause: the two
libraries' activations differ by ~1e-6, so a ReLU input that close to 0
takes the other branch in one of them and moves one output channel of
one leaf's gradient (a rank-one error, 2.6e-3 of that leaf's norm at step
1 here, in ``backbone/stage2/unit1/conv1/kernel``).  So at most one leaf
per step may miss 1e-3, and only by one output channel: without that
channel it holds 1e-3, with it 1e-2.  The update is not held to 1e-4 per
leaf: one of ~1e-5 of its weight loses ~1e-4 of itself to the float32
rounding of ``w + Δ``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.models import init_params
from mx_rcnn_tpu.train import create_train_state as j_create_train_state
from mx_rcnn_tpu.train import fixed_param_mask as j_fixed_param_mask
from mx_rcnn_tpu.train import make_train_step as j_make_train_step
from mx_rcnn_tpu.train.train_step import _loss_fn as j_loss_fn

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data.loader import AnchorLoader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.eval.tester import Predictor, im_detect
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.train import optim
from mx_rcnn_tpu_torch.train.checkpoint import (epoch_path, load_params_npz,
                                                normalize_for_train)
from mx_rcnn_tpu_torch.train.trainer import batch_put, fit
from mx_rcnn_tpu_torch.train.train_step import (create_train_state,
                                                make_train_step)
from mx_rcnn_tpu_torch.utils import convert_jax

torch.set_num_threads(2)

B, H, W = 2, 128, 192
OVERRIDES = dict(TRAIN__RPN_PRE_NMS_TOP_N=300, TRAIN__RPN_POST_NMS_TOP_N=50,
                 TRAIN__BATCH_ROIS=32)
LOSSES = ("rpn_cls_loss", "rpn_bbox_loss", "rcnn_cls_loss", "rcnn_bbox_loss")


def tiny(gen):
    cfg = gen("resnet50", "PascalVOC", **OVERRIDES)
    net = dataclasses.replace(cfg.network, ANCHOR_SCALES=(2, 4),
                              PIXEL_STDS=(127.0, 127.0, 127.0))
    tpu = dataclasses.replace(cfg.tpu, SCALES=((H, W),), MAX_GT=8,
                              COMPUTE_DTYPE="float32")
    return cfg.replace(network=net, tpu=tpu)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def make_batch(seed=0, g=8):
    """Normalised-scale images and 3 gt boxes per image (padded to g)."""
    rng = np.random.RandomState(seed)
    gtb = np.zeros((B, g, 4), np.float32)
    gtc = np.zeros((B, g), np.int32)
    gtv = np.zeros((B, g), bool)
    for b in range(B):
        for i in range(3):
            x1, y1 = rng.randint(0, W - 70), rng.randint(0, H - 70)
            gtb[b, i] = (x1, y1, x1 + rng.randint(30, 69),
                         y1 + rng.randint(30, 69))
            gtc[b, i] = rng.randint(1, 21)
            gtv[b, i] = True
    info = np.asarray([[H, W, 1.0], [H - 16, W - 32, 1.0]], np.float32)
    return dict(images=rng.randn(B, H, W, 3).astype(np.float32), im_info=info,
                gt_boxes=gtb, gt_classes=gtc, gt_valid=gtv)


def jax_draws(key, n_anchors, n_rois):
    """The uniforms the JAX train graph draws from its step key."""
    keys = jax.random.split(key, (B, 2))
    out = {}
    for name, col, n in (("rpn", 0, n_anchors), ("rcnn", 1, n_rois)):
        per = []
        for b in range(B):
            kf, kb = jax.random.split(keys[b, col])
            per.append([np.asarray(jax.random.uniform(k, (n,)))
                        for k in (kf, kb)])
        out[name] = tuple(torch.from_numpy(np.stack([p[i] for p in per]))
                          for i in range(2))
    return out


@pytest.fixture(scope="module")
def jax_side():
    cfg = tiny(j_generate_config)
    model = j_build_model(cfg)
    params = jax.device_get(init_params(model, cfg, jax.random.PRNGKey(0),
                                        batch_size=1, image_hw=(H, W)))
    return cfg, model, params


def test_trainable_mask_matches_jax(jax_side):
    cfg, _, params = jax_side
    want = flatten(j_fixed_param_mask(params, cfg.network.FIXED_PARAMS))
    model = build_model(tiny(generate_config))
    got = optim.apply_param_mask(model, cfg.network.FIXED_PARAMS)
    assert got == {k: bool(v) for k, v in want.items()}
    names = convert_jax.jax_names(model)
    for name, p in model.named_parameters():
        assert p.requires_grad == got[names[name]], name
    assert not model.backbone.conv1.kernel.requires_grad
    assert model.backbone.stage2.unit1.conv1.kernel.requires_grad
    with pytest.raises(NotImplementedError, match="gamma"):
        optim.apply_param_mask(model, ("conv1", "stage1"))


def test_export_inverts_load_bit_exactly(jax_side):
    _, _, params = jax_side
    flat = flatten(params)
    model = build_model(tiny(generate_config))
    convert_jax.load_jax_params(model, flat)
    back = convert_jax.export_jax_params(model)
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        assert back[k].dtype == np.float32 and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v)


def test_lr_schedule_matches_jax():
    from mx_rcnn_tpu.train import make_lr_schedule as j_make_lr_schedule

    for kw in (dict(LR=0.01, LR_STEP=(2, 4), LR_FACTOR=0.1),
               dict(LR=0.01, LR_STEP=(2, 4), LR_FACTOR=0.1, WARMUP=True,
                    WARMUP_LR=1e-4, WARMUP_STEP=5)):
        cfgs = [c.replace(TRAIN=dataclasses.replace(c.TRAIN, **kw))
                for c in (tiny(generate_config), tiny(j_generate_config))]
        mine = optim.make_lr_schedule(cfgs[0], steps_per_epoch=10)
        ref = j_make_lr_schedule(cfgs[1], steps_per_epoch=10)
        # optax evaluates in float32, the port in Python floats
        for step in (0, 3, 5, 19, 20, 21, 39, 40, 60):
            np.testing.assert_allclose(mine(step), float(ref(step)), rtol=1e-5)


def rel_err(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def check_leaves(got, want, trained, what):
    """All leaves within 1e-3 of their norm together and each alone, but
    for at most one leaf whose error sits in one output channel (a ReLU
    branch flipped by float32 noise): 1e-3 without it, 1e-2 with it."""
    assert got.keys() == set(trained)
    assert rel_err(np.concatenate([got[k].ravel() for k in trained]),
                   np.concatenate([want[k].ravel() for k in trained])) < 1e-3
    flipped = []
    for k in trained:
        err = rel_err(got[k], want[k])
        if err < 1e-3:
            continue
        g = got[k].reshape(-1, got[k].shape[-1])
        w = want[k].reshape(-1, want[k].shape[-1])
        ch = int(np.argmax(np.linalg.norm(g - w, axis=0)))
        rest = np.arange(w.shape[1]) != ch
        assert err < 1e-2 and rel_err(g[:, rest], w[:, rest]) < 1e-3, \
            (what, k, err)
        flipped.append(k)
    assert len(flipped) <= 1, (what, flipped)


def test_two_train_steps_match_make_train_step(jax_side):
    """Losses, clipped gradients and parameter updates of two SGD steps
    (momentum carried) against the JAX package's jitted step on the same
    weights, batch and uniforms."""
    jcfg, jmodel, params = jax_side
    state, tx, mask = j_create_train_state(jcfg, params, steps_per_epoch=10)
    jstep = j_make_train_step(jmodel, tx, trainable_mask=mask, donate=False)

    @jax.jit
    def jgrads(p, batch, key):
        def loss(q):
            q = jax.tree.map(lambda v, t: v if t else jax.lax.stop_gradient(v),
                             q, mask)
            return j_loss_fn(q, jmodel, batch, key, "end2end")
        return jax.value_and_grad(loss, has_aux=True)(p)

    cfg = tiny(generate_config)
    model = build_model(cfg)
    convert_jax.load_jax_params(model, flatten(params))
    tstate = create_train_state(cfg, model, steps_per_epoch=10)
    tstep = make_train_step(cfg)
    names = convert_jax.jax_names(model)
    n_anchors = (H // 16) * (W // 16) * cfg.network.NUM_ANCHORS
    n_rois = cfg.TRAIN.RPN_POST_NMS_TOP_N + cfg.tpu.MAX_GT

    batch = make_batch()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    trained = [k for k, t in tstate.mask.items() if t]
    for i in range(2):
        key = jax.random.PRNGKey(100 + i)
        before = flatten(jax.device_get(state.params))
        (_, aux), grads = jax.device_get(jgrads(state.params, batch, key))
        state, _ = jstep(state, batch, key)
        after = flatten(jax.device_get(state.params))
        grads = flatten(grads)

        _, metrics = tstep(tstate, tbatch, draws=jax_draws(key, n_anchors,
                                                           n_rois))
        for k, mk in zip(LOSSES, ("RPNLogLoss", "RPNL1Loss", "RCNNLogLoss",
                                  "RCNNL1Loss")):
            np.testing.assert_allclose(float(metrics[mk]), float(aux[k]),
                                       rtol=1e-4)
        assert float(aux["rcnn_bbox_loss"]) > 0 and float(aux["rpn_bbox_loss"]) > 0
        now = convert_jax.export_jax_params(model)
        g_port, g_jax = {}, {}
        for name, p in model.named_parameters():
            key_ = names[name]
            if not tstate.mask[key_]:
                assert p.grad is None
                np.testing.assert_array_equal(now[key_], before[key_])
                np.testing.assert_array_equal(after[key_], before[key_])
                continue
            g_jax[key_] = np.clip(grads[key_], -jcfg.TRAIN.CLIP_GRADIENT,
                                  jcfg.TRAIN.CLIP_GRADIENT)
            g_port[key_] = convert_jax._to_jax(
                "kernel" if p.dim() > 1 else "bias", p.grad)
        d_port = {k: now[k] - before[k] for k in trained}
        d_jax = {k: after[k] - before[k] for k in trained}
        check_leaves(g_port, g_jax, trained, f"gradient, step {i}")
        check_leaves(d_port, d_jax, trained, f"update, step {i}")
        # the next step starts both from the JAX parameters, so drift
        # cannot accumulate across steps; the momentum buffers carry over
        convert_jax.load_jax_params(model, after)


def test_fit_saves_a_checkpoint_predictor_serves(tmp_path):
    """AnchorLoader → fit on the CPU for an epoch of 3 steps with flipped
    records; frozen leaves stay bitwise, trainable ones move; the epoch
    checkpoint (de-normalized) loads into Predictor and detects."""
    cfg = tiny(generate_config)
    ds = SyntheticDataset(num_images=3, num_classes=cfg.NUM_CLASSES,
                          height=H, width=W, max_objects=3)
    roidb = ds.filter_roidb(ds.append_flipped_images(ds.gt_roidb()))
    loader = AnchorLoader(roidb, cfg, 2, seed=0)
    model = build_model(cfg)
    params = convert_jax.random_params(model, seed=1)
    seen = []
    fit(cfg, model, params, loader, end_epoch=1, prefix=str(tmp_path / "e2e"),
        device="cpu", frequent=1,
        batch_end_callback=lambda ep, step, m: seen.append(m))
    assert len(seen) == loader.steps_per_epoch == 3
    assert all(np.isfinite(m["total_loss"]) for m in seen)
    saved = load_params_npz(epoch_path(str(tmp_path / "e2e"), 1))
    trained = normalize_for_train(saved, cfg)
    mask = optim.fixed_param_mask(params, cfg.network.FIXED_PARAMS)
    for k, v in params.items():
        if mask[k]:
            continue
        np.testing.assert_array_equal(trained[k], v)
    assert np.abs(trained["rpn/rpn_conv_3x3/kernel"]
                  - params["rpn/rpn_conv_3x3/kernel"]).max() > 0
    assert np.abs(trained["backbone/stage3/unit1/conv2/kernel"]
                  - params["backbone/stage3/unit1/conv2/kernel"]).max() > 0

    pred = Predictor(build_model(cfg), epoch_path(str(tmp_path / "e2e"), 1),
                     cfg, device="cpu")
    batch = next(iter(AnchorLoader(roidb, cfg, 2, shuffle=False)))
    put = batch_put(batch, cfg, torch.device("cpu"))
    dets = im_detect(pred, {"images": put["images"],
                            "im_info": batch["im_info"]})
    assert len(dets) == 2
    for scores, boxes, valid in dets:
        assert valid.any() and np.isfinite(scores).all() and \
            np.isfinite(boxes).all()
