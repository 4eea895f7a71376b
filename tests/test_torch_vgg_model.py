"""VGG-16 Faster R-CNN of the port against the JAX package, on the CPU:
the modules (``VGGConv``, ``VGGFC`` with and without dropout, the
512-channel RPN and the 4 096-wide ``RCNNOutput``), max-pool ties, the
weight bridge on the VGG keys, and the inference slice in float32 and in
bfloat16.

VGG-16's widths are fixed, so the model is at full width (137 M
parameters); everything else is tiny, as ``tests/test_detector.py``'s
``vgg16`` case: 128×192 images, ``ANCHOR_SCALES=(2, 4)``,
``PIXEL_STDS=127``, TEST 300 → 50, ``MAX_GT`` 8.  One JAX ``init_params``
in float32 feeds every test.  Tolerances: the modules as
``tests/test_torch_port_model.py`` (relative error ≤ 1e-4 of the output's
max magnitude), the float32 slice as its slice (rois 1e-3, ``cls_prob``
1e-5, deltas 1e-4, records' boxes 1e-2); the bfloat16 slice by
:data:`BF16_REL` (see :func:`test_bf16_slice_matches_jax`).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data.device_prep import _prep_one
from mx_rcnn_tpu.eval import Predictor as JPredictor
from mx_rcnn_tpu.eval import im_detect as j_im_detect
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.models import init_params
from mx_rcnn_tpu.models.backbones import VGGConv as JVGGConv
from mx_rcnn_tpu.models.backbones import VGGFC as JVGGFC
from mx_rcnn_tpu.models.heads import RCNNOutput as JRCNNOutput
from mx_rcnn_tpu.models.heads import RPNHead as JRPNHead
from mx_rcnn_tpu.ops import postprocess as jpost

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.eval.tester import Predictor, im_detect
from mx_rcnn_tpu_torch.models.backbones import VGGFC, VGGConv, dropout_keep
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.models.heads import RCNNOutput, RPNHead
from mx_rcnn_tpu_torch.ops import postprocess as tpost
from mx_rcnn_tpu_torch.utils import convert_jax
from tests.test_torch_port_model import (assert_close_rel, flatten,
                                         staged_batch)

torch.set_num_threads(2)

H, W = 128, 192
OVERRIDES = dict(TEST__RPN_PRE_NMS_TOP_N=300, TEST__RPN_POST_NMS_TOP_N=50)
# detections are scored above this class probability; the random-init
# head's probabilities sit near 1/21, under the usual 0.05
THRESH = 0.045
# the bfloat16 slice: relative error of the two packages' bf16 outputs,
# each over its max magnitude.  Measured on the CPU at these seeds: VGG-16
# features 9.4e-3, RPN logits / deltas 7.8e-3 / 8.4e-3, the head's
# cls_prob 7.6e-5 and deltas 6.7e-3; ResNet-50 1.5e-2, 1.2e-2 / 1.9e-2,
# 3.7e-3 and 5.8e-3.  One bf16 step is 2^-8 = 3.9e-3 of a value and the
# packages accumulate in other orders, so a few steps: 3e-2, 1.6× the
# largest.  The proposals: 100% (VGG) and 98% (ResNet-50) of the JAX
# package's found among the port's.
BF16_REL = 3e-2


def tiny(gen, network="vgg16", dtype="float32"):
    cfg = gen(network, "PascalVOC", **OVERRIDES)
    net = dataclasses.replace(cfg.network, ANCHOR_SCALES=(2, 4),
                              PIXEL_STDS=(127.0, 127.0, 127.0))
    tpu = dataclasses.replace(cfg.tpu, SCALES=((H, W),), MAX_GT=8,
                              COMPUTE_DTYPE=dtype)
    return cfg.replace(network=net, tpu=tpu)


def jax_params(network):
    cfg = tiny(j_generate_config, network)
    model = j_build_model(cfg)
    return cfg, model, jax.device_get(init_params(
        model, cfg, jax.random.PRNGKey(0), batch_size=1, image_hw=(H, W)))


@pytest.fixture(scope="module")
def jax_side():
    return jax_params("vgg16")


@pytest.fixture(scope="module")
def port_model(jax_side):
    """The port's float32 VGG model with the JAX weights."""
    model = build_model(tiny(generate_config))
    convert_jax.load_jax_params(model, flatten(jax_side[2]))
    return model


# ---- modules ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 96), (61, 93)], ids=["even", "odd"])
def test_vgg_conv_matches_jax(jax_side, port_model, shape):
    """Odd sides floor at every pool (VALID), as ``nn.max_pool``."""
    params = jax_side[2]
    x = np.random.RandomState(shape[0]).randn(2, *shape, 3).astype(np.float32)
    ref = JVGGConv(dtype=jnp.float32).apply({"params": params["backbone"]}, x)
    with torch.no_grad():
        out = port_model.backbone(torch.from_numpy(x))
    assert out.shape == ref.shape == (2, shape[0] // 16, shape[1] // 16, 512)
    assert_close_rel(out.numpy(), ref)


def test_vgg_fc_matches_jax(jax_side, port_model):
    """``deterministic=True``: no dropout, fc6 on the (h, w, c) flatten."""
    params = jax_side[2]
    x = np.random.RandomState(8).randn(2, 3, 7, 7, 512).astype(np.float32)
    ref = JVGGFC(dtype=jnp.float32).apply({"params": params["head_body"]}, x)
    with torch.no_grad():
        out = port_model.head_body(torch.from_numpy(x))
    assert out.shape == (2, 3, 4096)
    assert_close_rel(out.numpy(), ref)


def caught_dropout():
    """An interceptor of flax ``Dropout`` calls and the list it fills
    with each call's ``(input, output)``."""
    caught = []

    def icpt(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout):
            caught.append((args[0], out))
        return out
    return icpt, caught


def keep_masks(caught):
    """The keep masks of intercepted dropout calls: ``out != 0`` where the
    input is nonzero.  Where the input is a ReLU zero, either value gives
    the same output and the same gradient (relu's gradient at 0 is 0 in
    both packages); this reads it as dropped."""
    return tuple(torch.from_numpy(np.asarray(out) != 0) for _, out in caught)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vgg_fc_dropout_matches_flax(jax_side, dtype):
    """``VGGFC(deterministic=False)`` with flax's masks injected equals
    flax's output and its gradient (input and fc6/fc7 leaves); kept values
    are doubled exactly (÷ 0.5) in both dtypes."""
    params = jax_side[2]["head_body"]
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    x = np.random.RandomState(9).randn(2, 6, 7, 7, 512).astype(np.float32)
    g = np.random.RandomState(10).randn(2, 6, 4096).astype(np.float32)
    mod = JVGGFC(dtype=jd)
    rng = {"dropout": jax.random.PRNGKey(3)}

    def loss(p, xx):
        out = mod.apply({"params": p}, xx, deterministic=False, rngs=rng)
        return jnp.sum(out.astype(jnp.float32) * g), out

    icpt, caught = caught_dropout()
    with fnn.intercept_methods(icpt):
        mod.apply({"params": params}, x, deterministic=False, rngs=rng)
    keep = keep_masks(caught)
    assert len(keep) == 2 and all(k.shape == (2, 6, 4096) for k in keep)
    for (inp, _), k in zip(caught, keep):  # half the live entries kept
        live = torch.from_numpy(np.asarray(inp) != 0)
        assert 0.45 < float(k[live].float().mean()) < 0.55
    (_, ref), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(params, x)

    fc = VGGFC(td)
    convert_jax.load_jax_params(fc, flatten(params))
    xt = torch.from_numpy(x).requires_grad_()
    out = fc(xt, deterministic=False, keep=keep)
    (out.float() * torch.from_numpy(g)).sum().backward()
    rel = 1e-4 if dtype == "float32" else BF16_REL
    assert out.dtype == td
    assert_close_rel(out.detach().float().numpy(), np.asarray(ref, np.float32),
                     rel)
    assert_close_rel(xt.grad.numpy(), np.asarray(gx), rel)
    names = convert_jax.jax_names(fc)
    for name, p in fc.named_parameters():
        want = flatten(gp)[names[name]]
        got = convert_jax._to_jax("weight" if p.dim() > 1 else "bias", p.grad)
        assert_close_rel(got, want, rel)
    with torch.no_grad():
        same = fc(torch.from_numpy(x), deterministic=False, keep=keep)
    assert torch.equal(same, out.detach())
    with pytest.raises(ValueError, match="fc6"):
        fc(xt, deterministic=False, keep=(keep[0][:1], keep[1]))


def test_vgg_fc_draws_half_its_masks_from_the_generator():
    """Absent masks are drawn from the generator, half kept, repeatable;
    deterministic mode ignores it."""
    fc = VGGFC()
    x = torch.randn(2, 64, 7, 7, 512, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = fc(x, deterministic=False, generator=torch.Generator().manual_seed(1))
        b = fc(x, deterministic=False, generator=torch.Generator().manual_seed(1))
        c = fc(x, deterministic=False, generator=torch.Generator().manual_seed(2))
        d = fc(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = dropout_keep((2, 64, 4096), "cpu",
                        torch.Generator().manual_seed(1))
    assert kept.dtype == torch.bool
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert torch.equal(d, fc(x, deterministic=True))


def test_rpn_head_512_matches_jax(jax_side, port_model):
    cfg, _, params = jax_side
    a = cfg.network.NUM_ANCHORS
    x = np.random.RandomState(6).randn(2, 8, 12, 512).astype(np.float32)
    ref_cls, ref_bbox = JRPNHead(num_anchors=a, dtype=jnp.float32).apply(
        {"params": params["rpn"]}, x)
    assert isinstance(port_model.rpn, RPNHead)
    assert port_model.rpn.rpn_conv_3x3.in_channels == 512
    with torch.no_grad():
        cls, bbox = port_model.rpn(torch.from_numpy(x))
    assert_close_rel(cls.numpy(), ref_cls)
    assert_close_rel(bbox.numpy(), ref_bbox)


def test_rcnn_output_4096_matches_jax(jax_side, port_model):
    cfg, _, params = jax_side
    x = np.random.RandomState(7).randn(2, 5, 4096).astype(np.float32)
    ref_cls, ref_bbox = JRCNNOutput(num_classes=cfg.NUM_CLASSES,
                                    dtype=jnp.float32).apply(
        {"params": params["rcnn_out"]}, x)
    assert isinstance(port_model.rcnn_out, RCNNOutput)
    with torch.no_grad():
        cls, bbox = port_model.rcnn_out(torch.from_numpy(x))
    assert_close_rel(cls.numpy(), ref_cls)
    assert_close_rel(bbox.numpy(), ref_bbox)


def test_unknown_backbone_raises():
    cfg = tiny(generate_config)
    cfg = cfg.replace(network=dataclasses.replace(cfg.network,
                                                  NETWORK="vgg19"))
    with pytest.raises(ValueError, match="unknown backbone vgg19"):
        build_model(cfg)


# ---- max-pool ties ---------------------------------------------------------

def tied_input(dtype):
    """(1, 4, 6, 1) positive values with every 2×2 window tied: each
    window holds its maximum twice or more (positions set per window)."""
    x = np.full((1, 4, 6, 1), 0.25, np.float32)
    for (i, j), cells in {(0, 0): [(0, 0), (1, 1)], (0, 1): [(0, 1), (0, 0)],
                          (0, 2): [(1, 0), (1, 1)],
                          (1, 0): [(0, 0), (0, 1), (1, 0), (1, 1)],
                          (1, 1): [(0, 1), (1, 0)],
                          (1, 2): [(1, 1), (0, 1)]}.items():
        for di, dj in cells:
            x[0, 2 * i + di, 2 * j + dj, 0] = 1.5 + i + j
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_ties_route_to_the_first_maximum(dtype):
    """torch's ``max_pool2d`` backward, NCHW and channels-last, sends a
    tied window's gradient to its first maximum in row-major order, as
    flax's ``nn.max_pool`` (select-and-scatter) does."""
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    x = tied_input(dtype)
    gy = np.arange(1, 7, dtype=np.float32).reshape(1, 2, 3, 1)
    ref = jax.grad(lambda v: jnp.sum(fnn.max_pool(
        v, (2, 2), strides=(2, 2)).astype(jnp.float32) * gy))(
        jnp.asarray(x, jd))
    want = np.zeros_like(x)
    for i in range(2):
        for j in range(3):
            win = x[0, 2 * i:2 * i + 2, 2 * j:2 * j + 2, 0]
            di, dj = np.unravel_index(np.argmax(win), (2, 2))  # first max
            want[0, 2 * i + di, 2 * j + dj, 0] = gy[0, i, j, 0]
    np.testing.assert_array_equal(np.asarray(ref, np.float32), want)
    for layout in ("nchw", "channels_last"):
        xt = torch.from_numpy(x).to(td).permute(0, 3, 1, 2)
        if layout == "nchw":
            xt = xt.contiguous()
        xt.requires_grad_()
        y = torch.nn.functional.max_pool2d(xt, 2, 2)
        (y.float() * torch.from_numpy(gy).permute(0, 3, 1, 2)).sum().backward()
        np.testing.assert_array_equal(
            xt.grad.float().permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vgg_conv_gradient_through_tied_windows_matches_jax(jax_side, dtype):
    """``VGGConv``'s input gradient through tied positive windows at all
    four pools, equal to JAX's bit for bit.  The convs are set to carry
    the input through exactly: conv1_1 copies input channel 0 plus 1 into
    its 64 channels (ties at every pool: the pattern of
    :func:`tied_input`, and equal channels), each later conv passes
    channel c to channel c (its channels past 64 are ReLU zeros).  The
    cotangent is small integers, so every product and sum of the backward
    is exact in bf16 as in float32: the gradients agree only if every
    window routes to the same input pixel."""
    params = {}
    for name, v in jax_side[2]["backbone"].items():
        k = np.zeros_like(v["kernel"])
        if name == "conv1_1":
            k[1, 1, 0, :] = 1.0
        else:
            c = min(k.shape[2:])
            k[1, 1, np.arange(c), np.arange(c)] = 1.0
        params[name] = {"kernel": k, "bias": np.full_like(
            v["bias"], 1.0 if name == "conv1_1" else 0.0)}
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    x = np.zeros((1, 32, 48, 3), np.float32)
    x[..., 0] = np.tile(tied_input(dtype)[0, :, :, 0], (8, 8))
    g = np.random.RandomState(11).randint(-3, 4, (1, 2, 3, 512)).astype(
        np.float32)
    ref = jax.grad(lambda v: jnp.sum(JVGGConv(dtype=jd).apply(
        {"params": params}, v).astype(jnp.float32) * g))(x)
    mod = VGGConv(td)
    convert_jax.load_jax_params(mod, flatten(params))
    xt = torch.from_numpy(x).requires_grad_()
    (mod(xt).float() * torch.from_numpy(g)).sum().backward()
    ref = np.asarray(ref, np.float32)
    assert np.count_nonzero(ref[..., 0]) == 6  # one pixel per output cell
    np.testing.assert_array_equal(xt.grad.numpy(), ref)


# ---- the weight bridge -----------------------------------------------------

def test_bridge_on_vgg_keys(jax_side, port_model):
    """Every VGG key consumed once; missing, extra and misshapen keys
    raise; ``export ∘ load`` is bitwise."""
    flat = flatten(jax_side[2])
    consumed = [k for _, _, keys in convert_jax._leaves(port_model)
                for k, _ in keys]
    assert len(consumed) == len(set(consumed)) == len(flat)
    assert set(consumed) == set(flat)
    assert flat["backbone/conv1_1/kernel"].shape == (3, 3, 3, 64)
    assert flat["head_body/fc6/kernel"].shape == (25088, 4096)
    # 137 078 239 at the preset's 9 anchors; the tiny config has 6
    assert sum(v.size for v in flat.values()) == 137_069_005
    back = convert_jax.export_jax_params(port_model)
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    model = VGGConv()
    sub = {k.split("/", 1)[1]: v for k, v in flat.items()
           if k.startswith("backbone/")}
    with pytest.raises(KeyError, match="conv5_3/bias"):
        convert_jax.load_jax_params(model, {k: v for k, v in sub.items()
                                            if k != "conv5_3/bias"})
    with pytest.raises(KeyError, match="conv5_4/kernel"):
        convert_jax.load_jax_params(model, dict(sub, **{
            "conv5_4/kernel": sub["conv5_3/kernel"]}))
    with pytest.raises(ValueError, match="conv3_2/kernel"):
        convert_jax.load_jax_params(model, dict(sub, **{
            "conv3_2/kernel": sub["conv3_1/kernel"]}))


# ---- the slice -------------------------------------------------------------

def jax_prepped(jcfg, batch):
    net = jcfg.network
    mean = jnp.asarray(net.PIXEL_MEANS, jnp.float32)
    std = jnp.asarray(net.PIXEL_STDS, jnp.float32)
    return jax.vmap(lambda r, hw, rt, ii: _prep_one(
        r, hw, rt, ii, False, mean, std, net.HOST_S2D, jnp.float32))(
        batch["images"], batch["raw_hw"], batch["prep_ratio"],
        batch["im_info"])


def records(post, det, cfg):
    te = cfg.TEST
    return [post.detections_to_records(post.per_class_nms(
        s, b, v, cfg.NUM_CLASSES, THRESH, te.NMS, te.MAX_PER_IMAGE))
        for s, b, v in det]


def test_inference_slice_matches_jax(jax_side, port_model):
    """Staged raw uint8 → device prep → ``Predictor.predict`` →
    ``im_detect`` → records, float32, on the 608-style bucket of the tiny
    scale (stride 16, no ``HOST_S2D``)."""
    jcfg, jmodel, params = jax_side
    cfg = tiny(generate_config)
    assert not cfg.network.HOST_S2D and cfg.network.IMAGE_STRIDE == 0
    batch = staged_batch(jcfg)
    images = jax_prepped(jcfg, batch)
    jpred = JPredictor(jmodel, params, jcfg)
    j_out = jax.device_get(jpred.predict(images, batch["im_info"]))
    j_det = j_im_detect(jpred, {"images": images, "im_info": batch["im_info"]})

    pred = Predictor(port_model, flatten(params), cfg, device="cpu")
    put = pred.batch_put(batch)
    assert put["images"].shape[-1] == 3
    np.testing.assert_allclose(put["images"].numpy(), np.asarray(images),
                               atol=1e-4, rtol=0)
    rois, roi_valid, cls_prob, deltas, _ = [
        x.numpy() for x in pred.predict(put["images"], put["im_info"])]
    det = im_detect(pred, put)
    assert roi_valid.any()
    np.testing.assert_array_equal(roi_valid, j_out[1])
    np.testing.assert_allclose(rois, j_out[0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(cls_prob, j_out[2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(deltas, j_out[3], atol=1e-4, rtol=0)
    # predict runs no dropout: twice is bitwise the same
    again = pred.predict(put["images"], put["im_info"])[2].numpy()
    np.testing.assert_array_equal(again, cls_prob)
    for (s_t, b_t, v_t), (s_j, b_j, v_j) in zip(det, j_det, strict=True):
        np.testing.assert_array_equal(v_t, v_j)
        np.testing.assert_allclose(b_t, b_j, atol=1e-2, rtol=0)
    rec_t, rec_j = records(tpost, det, jcfg), records(jpost, j_det, jcfg)
    assert any(rec_j), "the tiny model must produce detections to compare"
    for a, b in zip(rec_t, rec_j, strict=True):
        assert [r["cls"] for r in a] == [r["cls"] for r in b]
        np.testing.assert_allclose([r["score"] for r in a],
                                   [r["score"] for r in b], atol=1e-6)
        np.testing.assert_allclose([r["bbox"] for r in a],
                                   [r["bbox"] for r in b], atol=1e-2)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("network", ["vgg16", "resnet50"])
def test_bf16_slice_matches_jax(jax_side, network):
    """``COMPUTE_DTYPE="bfloat16"`` on both sides, the same float32 weights
    and prepped images.  bf16 rounding decides the RPN's ranking wherever
    two scores lie within a step, so the proposals of the two packages are
    held by their overlap, and the head is held on the JAX package's own
    RoIs: the backbone features, the RPN outputs and the head's
    ``cls_prob`` and deltas each within ``BF16_REL`` of their max
    magnitude; at least 90% of the JAX proposals found among the port's
    (IoU ≥ 0.95)."""
    if network == "vgg16":
        params = jax_side[2]
    else:
        params = jax_params(network)[2]
    jcfg = tiny(j_generate_config, network, "bfloat16")
    cfg = tiny(generate_config, network, "bfloat16")
    jmodel = j_build_model(jcfg)
    batch = staged_batch(jcfg)
    images = jax_prepped(jcfg, batch)
    info = batch["im_info"]

    def jfeat(p, im):
        return jmodel.apply({"params": p}, im,
                            method=lambda m, x: m.backbone(x))

    def jrpn(p, f):
        return jmodel.apply({"params": p}, f, method=lambda m, x: m.rpn(x))

    def jhead(p, f, r):
        cls, box = jmodel.apply({"params": p}, f, r,
                                method=lambda m, a, b: m._rcnn_head(a, b))
        return jax.nn.softmax(cls, axis=-1), box

    j_feat = jax.jit(jfeat)(params, images)
    j_cls, j_box = jax.jit(jrpn)(params, j_feat)
    jp = jax.device_get(JPredictor(jmodel, params, jcfg).predict(images, info))
    j_rois, j_valid = jp[0], jp[1]
    j_prob, j_delta = jax.device_get(jax.jit(jhead)(params, j_feat, j_rois))

    model = build_model(cfg)
    convert_jax.load_jax_params(model, flatten(params))
    pred = Predictor(model, flatten(params), cfg, device="cpu")
    put = pred.batch_put(batch)
    with torch.inference_mode():
        feat = pred.model.backbone(put["images"])
        cls, box = pred.model.rpn(feat)
        cls_head, delta_head = pred.model._rcnn_head(
            feat, torch.from_numpy(np.array(j_rois)))
        prob_head = torch.softmax(cls_head, dim=-1)
        rois, valid = [x.numpy() for x in pred.predict(
            put["images"], put["im_info"])[:2]]
    assert feat.dtype == torch.bfloat16
    errs = {"features": rel(feat.float().numpy(), np.asarray(j_feat,
                                                             np.float32)),
            "rpn_cls": rel(cls.numpy(), j_cls), "rpn_bbox": rel(box.numpy(),
                                                                j_box),
            "cls_prob": rel(prob_head.numpy(), j_prob),
            "deltas": rel(delta_head.numpy(), j_delta)}
    assert all(e <= BF16_REL for e in errs.values()), errs
    for b in range(rois.shape[0]):
        mine, theirs = rois[b][valid[b]], j_rois[b][j_valid[b]]
        assert len(theirs) and abs(len(mine) - len(theirs)) <= \
            0.1 * len(theirs)
        found = iou(theirs, mine).max(1) >= 0.95
        assert found.mean() >= 0.9, (b, found.mean())


def iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt + 1, 0, None), -1)
    area = lambda x: np.prod(x[:, 2:] - x[:, :2] + 1, -1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)
