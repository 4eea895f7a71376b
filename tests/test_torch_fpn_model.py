"""FPN and Mask R-CNN inference modules of the PyTorch port against the JAX
package, on the CPU.

Config: ``tests/test_fpn_mask.py``'s tiny FPN (64×96, ``NETWORK=
"resnet50"``, ``FPN_ANCHOR_SCALES=(4,)``, ``MAX_GT=4``, TEST 250 → 32,
``PIXEL_STDS=127``) on the ``resnet101_fpn_mask`` preset, float32 compute.
One JAX ``init_params`` feeds the model tests, carried across with the
port's weight bridge (``utils/convert_jax.py``); the module tests draw
their own seeded weights.  Tolerances (float32 on both sides, different
libraries): features and logits within 1e-4 of the output's largest
magnitude, probabilities within 1e-5, boxes within 1e-3 px; integer
outputs (levels, valid flags, kept proposals) exact; ``propose_fpn``'s
RoIs within 1e-4 px and scores within 1e-6, as ``propose``'s test holds
them.

* the weight bridge: every JAX key consumed, export ∘ load bitwise;
* the neck on odd sizes (C5 3×5 → P6 2×3), ``upsample2`` exact;
* ``MaskHead`` with an asymmetric 2×2 transpose kernel (flax applies it
  unflipped: the bridge must flip it), and alone on a one-hot input;
* ``FPNBoxHead``: ``fc6`` takes the (h, w, c) flatten;
* ``assign_level`` at √area 56, 112, 224, 448, 896 and one float32 step
  each side: the same level as the JAX ``_assign_level``;
* ``propose_fpn`` against the JAX one on ``nms_padded``: tied scores, a
  level with fewer valid boxes than its cut, P6 with fewer anchors;
* ``predict``, ``predict_with_feats``, ``masks_from_feats``,
  ``predict_masks`` and ``predict_rpn`` of the whole model;
* ``build_model``'s dispatch; the training forward runs (its parity is
  ``tests/test_torch_fpn_train.py``'s); the serve driver builds an engine
  for the full-width FPN networks (their serving parity is
  ``tests/test_torch_serve_fpn.py``'s); alternate training of a mask
  network raises the JAX message.
  ``chip_smoke.py``'s phase 12 holds ``propose_fpn``'s kernels to the
  plain NMS on the card.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.models import init_params
from mx_rcnn_tpu.models.fpn import FPNBoxHead as JFPNBoxHead
from mx_rcnn_tpu.models.fpn import FPNNeck as JFPNNeck
from mx_rcnn_tpu.models.fpn import _upsample2 as j_upsample2
from mx_rcnn_tpu.models.heads import MaskHead as JMaskHead
from mx_rcnn_tpu.ops.proposal import propose_fpn as j_propose_fpn

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.models.fpn import (FPNBoxHead, FPNFasterRCNN, FPNNeck,
                                          assign_level, upsample2)
from mx_rcnn_tpu_torch.models.heads import MaskHead
from mx_rcnn_tpu_torch.ops.proposal import propose_fpn
from mx_rcnn_tpu_torch.utils.convert_jax import (export_jax_params,
                                                 load_jax_params,
                                                 param_shapes)

torch.set_num_threads(2)

H, W = 64, 96
REL = 1e-4
PROB_ATOL, BOX_ATOL = 1e-5, 1e-3


def fpn_cfg(gen, **kw):
    """tests/test_fpn_mask.py:fpn_cfg(mask=True), in float32."""
    cfg = gen("resnet101_fpn_mask", "PascalVOC",
              TRAIN__RPN_PRE_NMS_TOP_N=500, TRAIN__RPN_POST_NMS_TOP_N=64,
              TRAIN__BATCH_ROIS=16, TEST__RPN_PRE_NMS_TOP_N=250,
              TEST__RPN_POST_NMS_TOP_N=32, **kw)
    net = dataclasses.replace(cfg.network, FPN_ANCHOR_SCALES=(4,),
                              NETWORK="resnet50",
                              PIXEL_STDS=(127.0, 127.0, 127.0))
    tpu = dataclasses.replace(cfg.tpu, SCALES=((H, W),), MAX_GT=4,
                              COMPUTE_DTYPE="float32")
    return cfg.replace(network=net, tpu=tpu)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rel * scale, (err, scale)


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


@pytest.fixture(scope="module")
def model_pair():
    jcfg = fpn_cfg(j_generate_config)
    jm = j_build_model(jcfg)
    params = init_params(jm, jcfg, jax.random.PRNGKey(0), 2, (H, W))
    flat = flatten(params)
    cfg = fpn_cfg(generate_config)
    m = build_model(cfg).eval()
    load_jax_params(m, flat)
    rng = np.random.RandomState(0)
    images = rng.randn(2, H, W, 3).astype(np.float32)
    info = np.asarray([[H, W, 1.0], [H - 16, W - 32, 1.0]], np.float32)
    apply = lambda method: jax.jit(  # noqa: E731
        lambda p, *a: jm.apply({"params": p}, *a, method=method))
    jout, jfeats = apply(jm.predict_with_feats)(params, images, info)
    with torch.inference_mode():
        out, feats = m.predict_with_feats(t(images), t(info))
    return dict(jm=jm, params=params, flat=flat, m=m, cfg=cfg, images=images,
                info=info, jout=jout, jfeats=jfeats, out=out, feats=feats,
                apply=apply)


def test_weight_bridge_covers_the_fpn_mask_leaves(model_pair):
    flat, m = model_pair["flat"], model_pair["m"]
    want = {k: v.shape for k, v in flat.items()}
    assert param_shapes(m) == want
    for key in ("neck/lateral2/kernel", "neck/post5/bias",
                "head_body/fc6/kernel", "mask_head/mask_deconv/kernel",
                "mask_head/mask_out/kernel", "backbone/stage4/unit3/conv3/"
                "kernel", "rpn/rpn_conv_3x3/kernel"):
        assert key in want
    assert want["head_body/fc6/kernel"] == (7 * 7 * 256, 1024)
    out = export_jax_params(m)
    assert set(out) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(out[k], v, err_msg=k)


def test_neck_on_odd_sizes_and_upsample():
    rng = np.random.RandomState(1)
    sizes = ((24, 40), (12, 20), (6, 10), (3, 5))
    chans = (256, 512, 1024, 2048)
    cs = [rng.randn(2, h, w, c).astype(np.float32) * 0.5
          for (h, w), c in zip(sizes, chans)]
    jneck = JFPNNeck(dtype=jnp.float32)
    params = jneck.init(jax.random.PRNGKey(3), *cs)["params"]
    jps = jax.jit(lambda p: jneck.apply({"params": p}, *cs))(params)
    neck = FPNNeck()
    load_jax_params(neck, flatten(params))
    with torch.inference_mode():
        ps = neck(*(t(c) for c in cs))
    assert [tuple(p.shape[1:3]) for p in ps] == [*sizes, (2, 3)]
    for got, want in zip(ps, jps):
        close(got, want)
    x = rng.randn(2, 3, 5, 4).astype(np.float32)
    np.testing.assert_array_equal(upsample2(t(x)).numpy(),
                                  np.asarray(j_upsample2(x)))


def test_mask_head_asymmetric_transpose_kernel():
    rng = np.random.RandomState(2)
    k = 5
    x = rng.randn(3, 14, 14, 256).astype(np.float32)
    jhead = JMaskHead(num_classes=k, dtype=jnp.float32)
    params = flatten(jhead.init(jax.random.PRNGKey(4), x)["params"])
    # a 2×2 kernel whose four taps differ: a spatial flip shows
    taps = np.asarray([[1.0, 2.0], [3.0, 5.0]], np.float32)
    params["mask_deconv/kernel"] = (taps[:, :, None, None]
                                    * rng.randn(1, 1, 256, 256) * 0.05
                                    ).astype(np.float32)
    nested = {}
    for key, v in params.items():
        mod, leaf = key.split("/")
        nested.setdefault(mod, {})[leaf] = v
    want = jhead.apply({"params": nested}, x)
    head = MaskHead(256, k)
    load_jax_params(head, params)
    with torch.inference_mode():
        got = head(t(x))
    assert got.shape == (3, 28, 28, k)
    close(got, want)

    # the transpose conv alone on a one-hot pixel: output pixel (2i + dy,
    # 2j + dx) holds flax's tap [1 − dy, 1 − dx]
    from flax import linen as fnn
    deconv = fnn.ConvTranspose(1, (2, 2), strides=(2, 2), use_bias=False)
    kern = taps[:, :, None, None]
    one = np.zeros((1, 2, 2, 1), np.float32)
    one[0, 1, 0, 0] = 1.0
    flax_out = np.asarray(deconv.apply({"params": {"kernel": kern}}, one))
    tconv = torch.nn.ConvTranspose2d(1, 1, 2, stride=2, bias=False)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kern[::-1, ::-1].transpose(2, 3, 0, 1))))
        port_out = tconv(t(one).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(port_out.numpy(), flax_out)
    np.testing.assert_array_equal(flax_out[0, 2:4, 0:2, 0], taps[::-1, ::-1])


def test_box_head_fc6_takes_the_hwc_flatten():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 7, 7, 256).astype(np.float32)
    jhead = JFPNBoxHead(dtype=jnp.float32)
    params = jhead.init(jax.random.PRNGKey(6), x)["params"]
    want = jhead.apply({"params": params}, x)
    head = FPNBoxHead()
    load_jax_params(head, flatten(params))
    with torch.inference_mode():
        close(head(t(x)), want)
        # a (c, h, w) flatten would be another function
        other = head(t(x.transpose(0, 1, 4, 2, 3).reshape(2, 3, 7, 7, 256)))
    assert float(np.abs(other.numpy() - np.asarray(want)).max()) > 1e-2


def test_assign_level_at_powers_of_two(model_pair):
    jm, params = model_pair["jm"], model_pair["params"]
    sides = []
    for s in (56.0, 112.0, 224.0, 448.0, 896.0):
        for side in (np.nextafter(np.float32(s), np.float32(0)),
                     np.float32(s),
                     np.nextafter(np.float32(s), np.float32(1e9))):
            sides.append(side)
    sides = np.asarray(sides, np.float32)
    rois = np.zeros((1, len(sides), 4), np.float32)
    rois[0, :, 0] = rois[0, :, 1] = 10.0
    rois[0, :, 2] = rois[0, :, 3] = 10.0 + sides - 1.0
    want = np.asarray(jax.jit(lambda p, r: jm.apply(
        {"params": p}, r, method=jm._assign_level))(params, rois))
    got = assign_level(t(rois)).numpy()
    np.testing.assert_array_equal(got, want)
    # at the exact powers: 56 → P2, 112 → P3, 224 → P4, 448 → P5, 896 → P5
    np.testing.assert_array_equal(got[0, 1::3], [0, 1, 2, 3, 3])


def level_inputs(rng, sizes, tie_levels=()):
    """Per level: (scores (B, N), deltas (B, N, 4), anchors (N, 4)); scores
    on a coarse grid (ties) at the levels named in ``tie_levels``."""
    out = []
    for li, (n, size) in enumerate(sizes):
        ctr = rng.uniform(0, [W, H], (n, 2))
        wh = rng.uniform(size / 2, size * 2, (n, 2))
        anchors = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)
        scores = rng.rand(2, n)
        if li in tie_levels:
            scores = np.round(scores * 8) / 8
        deltas = rng.randn(2, n, 4) * 0.2
        out.append(tuple(a.astype(np.float32)
                         for a in (scores, deltas, anchors)))
    return out


@pytest.mark.parametrize("case", ["random", "ties", "filtered", "small"])
def test_propose_fpn_matches_jax(case):
    rng = np.random.RandomState({"random": 7, "ties": 8, "filtered": 9,
                                 "small": 10}[case])
    # five levels; P6 has fewer anchors than the per-level cut of 60
    sizes = [(600, 16), (300, 32), (150, 64), (80, 128), (24, 256)]
    kw = dict(pre_nms_top_n=300, post_nms_top_n=40, nms_thresh=0.7,
              min_size=4)
    if case == "ties":
        levels = level_inputs(rng, sizes, tie_levels=(0, 1, 2, 3, 4))
    elif case == "filtered":
        # most P2 boxes fall under min_size: fewer valid than its cut
        levels = level_inputs(rng, [(600, 3)] + sizes[1:])
        kw["min_size"] = 6
    elif case == "small":
        levels = level_inputs(rng, [(40, 16), (30, 32), (20, 64), (10, 128),
                                    (3, 256)], tie_levels=(4,))
    else:
        levels = level_inputs(rng, sizes)
    info = np.asarray([[H, W, 1.0], [H - 8, W - 24, 1.5]], np.float32)
    ss, ds, anc = ([lv[i] for lv in levels] for i in range(3))
    wants = jax.device_get(jax.jit(jax.vmap(
        lambda s, d, i: j_propose_fpn(list(s), list(d), anc, i[0], i[1],
                                      i[2], use_pallas=False, **kw)))(
        tuple(ss), tuple(ds), info))
    for use_kernel in (False, True):    # both take the plain NMS on the CPU
        got = propose_fpn([t(s) for s in ss], [t(d) for d in ds],
                          [t(a) for a in anc], t(info),
                          use_kernel=use_kernel, **kw)
        for b in range(2):
            want = [w[b] for w in wants]
            msg = f"{case} image {b}"
            np.testing.assert_array_equal(got[2][b].numpy(),
                                          np.asarray(want[2]), err_msg=msg)
            # the decode's float32 rounding differs by a step between the
            # libraries; the kept rows are the same
            np.testing.assert_allclose(got[0][b].numpy(), want[0], rtol=0,
                                       atol=1e-4, err_msg=msg)
            np.testing.assert_allclose(got[1][b].numpy(), want[1], rtol=0,
                                       atol=1e-6, err_msg=msg)
    assert got[2].sum() > 0


def test_predict_paths_match_jax(model_pair):
    jout, out = model_pair["jout"], model_pair["out"]
    rois, valid, cls_prob, deltas, scores = out
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jout[1]))
    np.testing.assert_allclose(rois.numpy(), jout[0], rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(cls_prob.numpy(), jout[2], rtol=0,
                               atol=PROB_ATOL)
    close(deltas, jout[3])
    np.testing.assert_allclose(scores.numpy(), jout[4], rtol=0,
                               atol=PROB_ATOL)
    assert int(valid.sum()) > 10
    feats = model_pair["feats"]
    assert len(feats) == 5
    for got, want in zip(feats, model_pair["jfeats"]):
        close(got, want)
    m, jm, params = model_pair["m"], model_pair["jm"], model_pair["params"]
    with torch.inference_mode():
        again = m.predict(t(model_pair["images"]), t(model_pair["info"]))
    for a, b in zip(again, out):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    # the mask branch over the pyramid and from the images, on the JAX
    # boxes, every label of the class range
    boxes = np.asarray(jout[0])
    labels = np.random.RandomState(11).randint(
        0, model_pair["cfg"].NUM_CLASSES, boxes.shape[:2]).astype(np.int32)
    apply = model_pair["apply"]
    want = apply(jm.masks_from_feats)(params, model_pair["jfeats"], boxes,
                                      labels)
    with torch.inference_mode():
        got = m.masks_from_feats(feats, t(boxes), t(labels, torch.int64))
        again = m.predict_masks(t(model_pair["images"]), None, t(boxes),
                                t(labels, torch.int64))
    assert got.shape == (2, 32, 28, 28)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROB_ATOL)
    np.testing.assert_array_equal(again.numpy(), got.numpy())

    jrpn = apply(jm.predict_rpn)(params, model_pair["images"],
                                 model_pair["info"])
    with torch.inference_mode():
        rpn = m.predict_rpn(t(model_pair["images"]), t(model_pair["info"]))
    np.testing.assert_allclose(rpn[0].numpy(), jrpn[0], rtol=0,
                               atol=BOX_ATOL)
    np.testing.assert_allclose(rpn[1].numpy(), jrpn[1], rtol=0,
                               atol=PROB_ATOL)
    np.testing.assert_array_equal(rpn[2].numpy(), np.asarray(jrpn[2]))


def test_build_model_dispatch_training_runs_serve_driver_builds_fpn(
        model_pair, tmp_path):
    """``build_model`` gives every FPN preset an ``FPNFasterRCNN``; the
    tiny mask model's training forward runs, with a mask loss given masks;
    the serve driver builds an engine for ``resnet101_fpn`` and
    ``resnet101_fpn_mask`` at full width (COCO's 800×1344 bucket, stride
    32), and alternate training of a mask network raises the JAX
    package's message."""
    for net in ("resnet50_fpn", "resnet101_fpn", "resnet101_fpn_mask"):
        cfg = generate_config(net, "coco")
        assert cfg.tpu.ROI_SAMPLING_RATIO == 2
        m = build_model(cfg)
        assert isinstance(m, FPNFasterRCNN)
        assert m.has_mask == (net == "resnet101_fpn_mask")
    assert not isinstance(build_model(generate_config("resnet50", "coco")),
                          FPNFasterRCNN)

    m = model_pair["m"]
    gt = torch.tensor([[[4.0, 6.0, 40.0, 30.0], [30.0, 20.0, 80.0, 60.0]]] * 2)
    masks = torch.zeros((2, 2, 112, 112), dtype=torch.uint8)
    masks[..., 20:90, 10:70] = 1
    with torch.no_grad():
        total, aux = m(t(model_pair["images"]), t(model_pair["info"]), gt,
                       torch.tensor([[3, 7]] * 2), torch.ones(2, 2, dtype=bool),
                       masks, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(total)) and float(aux["mask_loss"]) > 0

    from mx_rcnn_tpu_torch import train_alternate
    from mx_rcnn_tpu_torch.models.fpn import NO_MASK_ALTERNATE
    from mx_rcnn_tpu_torch.serve import driver
    from mx_rcnn_tpu_torch.tools.common import config_from_args
    argv = ["--synthetic", "--device", "cpu", "--prefix",
            str(tmp_path / "e2e"), "--root_path", str(tmp_path / "data")]
    for net in ("resnet101_fpn", "resnet101_fpn_mask"):
        args = driver.parse_args(["--synthetic", "--device", "cpu",
                                  "--network", net, "--dataset", "coco",
                                  "--serve-batch", "2", "--unix-socket",
                                  str(tmp_path / "s.sock")])
        cfg = config_from_args(args, train=False)
        predictor, engine = driver.build_engine(args, cfg)
        try:
            assert isinstance(predictor.model, FPNFasterRCNN)
            assert predictor.model.has_mask == (net == "resnet101_fpn_mask")
            assert engine.bucket_key(480, 640) == (800, 1344)
            assert engine.bucket_key(640, 480) == (1344, 800)
            assert engine.readiness()["warmed"] is False
        finally:
            engine.stop()
    with pytest.raises(NotImplementedError, match=re.escape(NO_MASK_ALTERNATE)):
        train_alternate.alternate_train(train_alternate.parse_args(
            argv + ["--network", "resnet101_fpn_mask"]))
    assert not list(tmp_path.iterdir())
