"""Op-level parity of the port's training path (``mx_rcnn_tpu_torch``)
against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages.  The JAX fused
assign kernel runs as its own tests run it (Pallas interpret mode); the
sampling ops get the JAX package's own uniforms, re-derived from the keys
its detector splits (``detector.py:117``, ``assign_anchor.py:151``,
``sample_rois.py:84``).  Tolerances: IoU reductions to ~2 f32 ulp with
discrete outputs exact except at ulp-marginal anchors
(``tests/test_assign_fused.py``'s rules); labels exact; targets and losses
rtol 1e-5; device-prep pixels 1e-5; staging, roidbs and loader batches
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data import image as jimage
from mx_rcnn_tpu.data.device_prep import _prep_one
from mx_rcnn_tpu.data.loader import AnchorLoader as JAnchorLoader
from mx_rcnn_tpu.data.synthetic import SyntheticDataset as JSynthetic
from mx_rcnn_tpu.kernels.assign_pallas import assign_reduce_pallas
from mx_rcnn_tpu.models import losses as jlosses
from mx_rcnn_tpu.ops.anchors import all_anchors, generate_anchors
from mx_rcnn_tpu.ops.assign_anchor import assign_anchor as j_assign_anchor
from mx_rcnn_tpu.ops.boxes import bbox_overlaps as j_bbox_overlaps
from mx_rcnn_tpu.ops.sample_rois import sample_rois as j_sample_rois
from mx_rcnn_tpu.train.checkpoint import denormalize_for_save as j_denormalize

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data import image as timage
from mx_rcnn_tpu_torch.data.loader import AnchorLoader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.kernels import assign_cuda
from mx_rcnn_tpu_torch.models import losses as tlosses
from mx_rcnn_tpu_torch.ops.assign_anchor import assign_anchor
from mx_rcnn_tpu_torch.ops.sample_rois import sample_rois
from mx_rcnn_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(2)

MAX_GT = 16
ULP = 3e-7  # ~2 f32 ulp at IoU scale (≤ 1)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def j_uniforms(key, n):
    """The (fg, bg) uniforms a JAX sampling op draws from ``key``."""
    kf, kb = jax.random.split(key)
    return tuple(np.asarray(jax.random.uniform(k, (n,))) for k in (kf, kb))


# ---- the fused assign reductions --------------------------------------------

def assign_case(seed, n_gt, fh=10, fw=12, stride=16):
    """tests/test_assign_fused.py's case: anchors of a 10×12 map, n_gt
    random gt boxes padded to MAX_GT, the inside mask of a 160×192 image."""
    rng = np.random.RandomState(seed)
    anchors = all_anchors(fh, fw, stride, generate_anchors(scales=(1, 2, 4)))
    im_h, im_w = fh * stride, fw * stride
    gt = np.zeros((MAX_GT, 4), np.float32)
    for i in range(n_gt):
        x1, y1 = rng.rand(2) * np.array([im_w - 80, im_h - 80])
        gt[i] = [x1, y1, x1 + 20 + rng.rand() * 60, y1 + 20 + rng.rand() * 60]
    valid = np.arange(MAX_GT) < n_gt
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < im_w) & (anchors[:, 3] < im_h))
    return anchors, gt, valid, inside


def check_discrete(ov, gm, valid, ref, got, name):
    """Equal except where the deciding comparison sits within ~1 ulp of a
    column tie or of a per-gt max (test_assign_fused.py's rule)."""
    ovv, gmv = ov[:, valid], gm[valid]
    near_tie = (np.abs(ovv - ov.max(1, keepdims=True)) < ULP).sum(1) > 1
    near_gtmax = (np.abs(ovv - gmv[None, :]) < ULP).any(1) if valid.any() \
        else np.zeros(ov.shape[0], bool)
    bad = (ref != got) & ~(near_tie | near_gtmax)
    assert not bad.any(), f"{name}: {bad.sum()} non-marginal mismatches"


def jax_reduce(anchors, gt, valid, inside):
    return [np.asarray(x) for x in assign_reduce_pallas(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid),
        jnp.asarray(inside), interpret=True)]


def port_reduce(anchors, gt, valid, inside):
    """The batched CPU route of the kernel wrapper and the chain of the
    two kernels' plain versions, which must agree bitwise."""
    args = (t(anchors), t(gt[None]), t(valid[None]), t(inside[None]))
    out = [x[0].numpy() for x in assign_cuda.assign_reduce(*args)]
    phase1 = assign_cuda.assign_gtmax(*args)
    parts = phase1[3]
    assert parts.shape == (1, assign_cuda.n_tiles(len(anchors)), MAX_GT)
    tie = assign_cuda.assign_rows(*args, *phase1[2:])
    chained = [x[0].numpy() for x in phase1[:3] + (tie,)]
    for a, b in zip(out, chained, strict=True):
        np.testing.assert_array_equal(a, b)
    return out


@pytest.mark.parametrize("n_gt", [0, 1, 5, MAX_GT])
def test_assign_reduce_matches_pallas_kernel(n_gt):
    anchors, gt, valid, inside = assign_case(n_gt, n_gt)
    j_mx, j_am, j_gm, j_tie = jax_reduce(anchors, gt, valid, inside)
    mx, am, gm, tie = port_reduce(anchors, gt, valid, inside)
    ov = np.where(valid[None, :], np.asarray(j_bbox_overlaps(
        jnp.asarray(anchors), jnp.asarray(gt))), -1.0)
    np.testing.assert_allclose(mx, j_mx, rtol=0, atol=ULP)
    np.testing.assert_allclose(gm, j_gm, rtol=0, atol=ULP)
    check_discrete(ov, j_gm, valid, j_am, am, "argmax")
    check_discrete(ov, j_gm, valid, j_tie, tie, "tie")
    assert am.dtype == np.int64 and tie.dtype == bool


def test_assign_duplicate_gt_and_all_outside():
    """Exact ties (two identical gt) go to the lower index and both
    columns fire the tie predicate; with every anchor outside, gt_max is
    −1 and nothing ties."""
    anchors, gt, valid, inside = assign_case(7, 3)
    gt[1] = gt[0]
    j_mx, j_am, j_gm, j_tie = jax_reduce(anchors, gt, valid, inside)
    mx, am, gm, tie = port_reduce(anchors, gt, valid, inside)
    np.testing.assert_array_equal(am, j_am.astype(np.int64))
    np.testing.assert_array_equal(tie, j_tie)
    assert tie.any()
    outside = np.zeros_like(inside)
    j_out = jax_reduce(anchors, gt, valid, outside)
    mx, am, gm, tie = port_reduce(anchors, gt, valid, outside)
    np.testing.assert_array_equal(gm, j_out[2])
    assert (gm == -1).all() and not tie.any()


def test_assign_batched_route_matches_per_image():
    """B = 3 images with different valid holes in one call equal three
    single-image calls of the JAX kernel."""
    cases = [assign_case(20 + b, n) for b, n in enumerate((3, 9, 6))]
    anchors = cases[0][0]
    gt = np.stack([c[1] for c in cases])
    valid = np.stack([c[2] for c in cases])
    valid[1, 2] = False                      # a hole inside the valid run
    inside = np.stack([c[3] for c in cases])
    out = [x.numpy() for x in assign_cuda.assign_reduce(
        t(anchors), t(gt), t(valid), t(inside))]
    for b in range(3):
        j_mx, j_am, j_gm, j_tie = jax_reduce(anchors, gt[b], valid[b],
                                             inside[b])
        ov = np.where(valid[b][None, :], np.asarray(j_bbox_overlaps(
            jnp.asarray(anchors), jnp.asarray(gt[b]))), -1.0)
        np.testing.assert_allclose(out[0][b], j_mx, rtol=0, atol=ULP)
        np.testing.assert_allclose(out[2][b], j_gm, rtol=0, atol=ULP)
        check_discrete(ov, j_gm, valid[b], j_am, out[1][b], f"argmax[{b}]")
        check_discrete(ov, j_gm, valid[b], j_tie, out[3][b], f"tie[{b}]")


def test_assign_wrappers_reject_bad_inputs():
    anchors = torch.zeros(10, 4)
    gt = torch.zeros(1, 4, 4)
    valid = torch.ones(1, 4, dtype=torch.bool)
    inside = torch.ones(1, 10, dtype=torch.bool)
    with pytest.raises(ValueError, match="128"):
        assign_cuda.assign_reduce(anchors, torch.zeros(1, 129, 4),
                                  torch.ones(1, 129, dtype=torch.bool), inside)
    with pytest.raises(TypeError):
        assign_cuda.assign_reduce(anchors.double(), gt, valid, inside)
    with pytest.raises(ValueError):
        assign_cuda.assign_reduce(anchors, gt, valid, inside[:, :5])
    with pytest.raises(ValueError, match="partials"):
        assign_cuda.assign_rows(anchors, gt, valid, inside,
                                torch.zeros(1, 4), torch.zeros(1, 2, 4))
    with pytest.raises(ValueError, match="gt_max"):
        assign_cuda.assign_rows(anchors, gt, valid, inside,
                                torch.zeros(1, 3), torch.zeros(1, 1, 4))
    # a device that is neither the CPU nor the card: raise, never the
    # plain version
    with pytest.raises(ValueError, match="no assign kernel"):
        assign_cuda.assign_reduce(anchors.to("meta"), gt.to("meta"),
                                  valid.to("meta"), inside.to("meta"))


@pytest.mark.cuda
def test_assign_kernels_never_reach_the_plain_versions_on_the_card(
        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the assign kernels have no CPU "
                    "mode")

    def refuse(*a, **k):
        raise AssertionError("plain version reached on a CUDA tensor")

    anchors, gt, valid, inside = assign_case(3, 5)
    args = (t(anchors).cuda(), t(gt[None]).cuda(), t(valid[None]).cuda(),
            t(inside[None]).cuda())
    want = [x.cuda() for x in assign_cuda.assign_reduce_plain(*args)]
    for name in ("assign_reduce_plain", "gtmax_partials_plain", "rows_plain"):
        monkeypatch.setattr(assign_cuda, name, refuse)
    n0 = (assign_cuda.assign_gtmax.launches, assign_cuda.assign_rows.launches)
    got = assign_cuda.assign_reduce(*args)
    assert (assign_cuda.assign_gtmax.launches,
            assign_cuda.assign_rows.launches) == (n0[0] + 1, n0[1] + 1)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


# ---- assign_anchor and sample_rois with the JAX package's draws ------------

ASSIGN_KW = dict(batch_size=256, fg_fraction=0.5, pos_overlap=0.7,
                 neg_overlap=0.3, allowed_border=0, clobber_positives=False)


@pytest.mark.parametrize("iou_bf16", [False, True])
def test_assign_anchor_matches_jax(iou_bf16):
    """Two images (one with no gt), subsampling active: labels equal,
    targets rtol 1e-5, through the port's dense path and its fused route
    (the CPU route of the kernel wrapper); the fused route refuses the
    bfloat16 IoU instead of taking the dense path."""
    anchors, gt0, valid0, _ = assign_case(11, 6)
    gt = np.stack([gt0, np.zeros_like(gt0)])
    valid = np.stack([valid0, np.zeros_like(valid0)])
    im_info = np.asarray([[160, 192, 1.0], [150, 180, 1.0]], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    refs, draws = [], []
    for b in range(2):
        ref = j_assign_anchor(jnp.asarray(anchors), jnp.asarray(gt[b]),
                              jnp.asarray(valid[b]), jnp.float32(im_info[b, 0]),
                              jnp.float32(im_info[b, 1]), keys[b],
                              iou_bf16=iou_bf16, fused=False, **ASSIGN_KW)
        refs.append({k: np.asarray(v) for k, v in ref.items()})
        draws.append(j_uniforms(keys[b], len(anchors)))
    d = tuple(t(np.stack([dr[i] for dr in draws])) for i in range(2))
    if iou_bf16:
        with pytest.raises(ValueError, match="RPN_ASSIGN_IOU_BF16"):
            assign_anchor(t(anchors), t(gt), t(valid), t(im_info),
                          iou_bf16=True, fused=True, draws=d, **ASSIGN_KW)
    for fused in (False,) if iou_bf16 else (False, True):
        out = assign_anchor(t(anchors), t(gt), t(valid), t(im_info),
                            iou_bf16=iou_bf16, fused=fused, draws=d,
                            **ASSIGN_KW)
        for b in range(2):
            np.testing.assert_array_equal(out["label"][b].numpy(),
                                          refs[b]["label"])
            for k in ("bbox_target", "bbox_weight"):
                np.testing.assert_allclose(out[k][b].numpy(), refs[b][k],
                                           rtol=1e-5, atol=1e-6)
    assert (refs[0]["label"] == 1).sum() > 0
    assert (refs[1]["label"] == 0).sum() == 256   # no gt: all-bg quota


def test_fused_assign_anchor_refuses_more_than_128_gt():
    """With ``fused`` set, gt padded beyond the kernel's 128 slots raise
    (as the TPU kernel's wrapper does) instead of taking the dense path;
    unset, the dense path takes them."""
    anchors, _, _, _ = assign_case(12, 0)
    gt = np.tile(np.asarray([[10, 10, 60, 70]], np.float32), (1, 129, 1))
    valid = np.zeros((1, 129), bool)
    valid[0, :3] = True
    im_info = np.asarray([[160, 192, 1.0]], np.float32)
    d = tuple(torch.rand(1, len(anchors), generator=torch.Generator()
                         .manual_seed(s)) for s in (0, 1))
    with pytest.raises(ValueError, match="128"):
        assign_anchor(t(anchors), t(gt), t(valid), t(im_info), fused=True,
                      draws=d, **ASSIGN_KW)
    out = assign_anchor(t(anchors), t(gt), t(valid), t(im_info), fused=False,
                        draws=d, **ASSIGN_KW)
    assert (out["label"] == 1).any()


def roi_case(seed, r=60, g=5, n_gt=3, im=(160, 192)):
    rng = np.random.RandomState(seed)
    gt = np.zeros((g, 4), np.float32)
    for i in range(n_gt):
        x1, y1 = rng.rand(2) * np.array([im[1] - 70, im[0] - 70])
        gt[i] = [x1, y1, x1 + 20 + rng.rand() * 45, y1 + 20 + rng.rand() * 45]
    jitter = rng.randn(r, 4).astype(np.float32) * 12
    rois = np.concatenate([gt[rng.randint(0, max(n_gt, 1), r)] + jitter, gt])
    rois[:, 2:] = np.maximum(rois[:, 2:], rois[:, :2] + 1)
    roi_valid = np.concatenate([rng.rand(r) > 0.1, np.arange(g) < n_gt])
    classes = rng.randint(1, 21, g).astype(np.int32)
    return rois.astype(np.float32), roi_valid, gt, classes, np.arange(g) < n_gt


SAMPLE_KW = dict(num_classes=21, batch_rois=32, fg_fraction=0.25,
                 fg_thresh=0.5, bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                 bbox_means=(0.0, 0.0, 0.0, 0.0), bbox_stds=(0.1, 0.1, 0.2, 0.2))


def test_sample_rois_matches_jax():
    """Three images: an ordinary one, one with no valid RoI at all (the
    degenerate zero-weight batch) and one with no bg candidate (the fg
    cycle): rois and labels equal, targets rtol 1e-5."""
    cases = [roi_case(1), roi_case(2), roi_case(3, n_gt=2)]
    cases[1] = (cases[1][0], np.zeros_like(cases[1][1])) + cases[1][2:4] + \
        (np.zeros_like(cases[1][4]),)
    rois3, valid3, gt3, cls3, gtv3 = cases[2]
    rois3 = np.tile(gt3[:1], (len(rois3), 1))      # every RoI is fg
    cases[2] = (rois3, valid3, gt3, cls3, gtv3)
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    refs, draws = [], []
    for b, (rois, rv, gt, cls, gv) in enumerate(cases):
        ref = j_sample_rois(jnp.asarray(rois), jnp.asarray(rv),
                            jnp.asarray(gt), jnp.asarray(cls), jnp.asarray(gv),
                            keys[b], **SAMPLE_KW)
        refs.append({k: np.asarray(v) for k, v in ref.items()})
        draws.append(j_uniforms(keys[b], len(rois)))
    stack = [t(np.stack([c[i] for c in cases])) for i in range(5)]
    d = tuple(t(np.stack([dr[i] for dr in draws])) for i in range(2))
    out = sample_rois(*stack, draws=d, **SAMPLE_KW)
    for b in range(3):
        for k in ("rois", "label", "label_weight"):
            np.testing.assert_array_equal(out[k][b].numpy(), refs[b][k])
        for k in ("bbox_target", "bbox_weight"):
            np.testing.assert_allclose(out[k][b].numpy(), refs[b][k],
                                       rtol=1e-5, atol=1e-6)
    assert (refs[0]["label"] > 0).any() and (refs[0]["label"] == 0).any()
    assert (refs[1]["label_weight"] == 0).all()
    assert (refs[2]["label"] > 0).all()


# ---- losses -------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.RandomState(3)
    rpn = (rng.randn(2, 300, 2) * 8).astype(np.float32)   # |z| past 20 too
    rpn[0, :4] = [[30, -30], [-25, 25], [0, 0], [40, 41]]
    rpn_label = rng.randint(-1, 2, (2, 300)).astype(np.int32)
    cls = rng.randn(2, 16, 21).astype(np.float32) * 3
    cls_label = rng.randint(0, 21, (2, 16)).astype(np.int32)
    weight = np.ones((2, 16), np.float32)
    weight[1] = 0.0
    pred = rng.randn(2, 16, 84).astype(np.float32)
    target = rng.randn(2, 16, 84).astype(np.float32)
    bw = (rng.rand(2, 16, 84) > 0.7).astype(np.float32)
    pairs = [
        (tlosses.softmax_ce_ignore(t(rpn), t(rpn_label)),
         jlosses.softmax_ce_ignore(rpn, rpn_label)),
        (tlosses.softmax_ce_weighted(t(cls), t(cls_label), t(weight)),
         jlosses.softmax_ce_weighted(cls, cls_label, weight)),
        (tlosses.smooth_l1(t(pred), t(target), t(bw), 3.0, 512.0),
         jlosses.smooth_l1(pred, target, bw, 3.0, 512.0)),
        (tlosses.smooth_l1(t(pred), t(target), t(bw), 1.0, 32.0),
         jlosses.smooth_l1(pred, target, bw, 1.0, 32.0)),
        (tlosses._ce_rows(t(rpn), t(np.maximum(rpn_label, 0))),
         jlosses._ce_rows(rpn, np.maximum(rpn_label, 0))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=0)


# ---- device-prep flip and the oversized-raw pre-shrink ---------------------

_prep_jit = jax.jit(_prep_one, static_argnums=(7, 8))


def test_prep_images_flip_matches_jax():
    net = generate_config("resnet50", "PascalVOC").network
    mean = jnp.asarray(net.PIXEL_MEANS, jnp.float32)
    std = jnp.asarray((127.0,) * 3, jnp.float32)
    raws = [np.random.RandomState(k).randint(0, 256, hw + (3,), np.uint8)
            for k, hw in enumerate([(50, 75), (64, 96), (33, 47)])]
    staged = [timage.stage_raw_to_bucket(r, (64, 96), 16) for r in raws]
    batch = [t(np.stack([s[i] for s in staged])) for i in range(4)]
    flip = torch.tensor([True, False, True])
    out = timage.prep_images(*batch, pixel_means=net.PIXEL_MEANS,
                             pixel_stds=(127.0,) * 3, s2d=True,
                             flip=flip).numpy()
    for b, (st, hw, ratio, info) in enumerate(staged):
        ref = np.asarray(_prep_jit(jnp.asarray(st), jnp.asarray(hw),
                                   jnp.float32(ratio), jnp.asarray(info),
                                   bool(flip[b]), mean, std, True,
                                   jnp.float32))
        np.testing.assert_allclose(out[b], ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [(1200, 1700), (700, 1100), (1203, 2001),
                                (1777, 1000), (1100, 2000)],
                         ids=["exact-2x", "0.857x", "odd-edges", "portrait",
                              "2x-long-side"])
def test_oversized_raw_preshrink_is_byte_identical(hw):
    """The port's numpy pre-shrink against the JAX package's cv2 uint8
    INTER_LINEAR (exact 2× takes cv2's INTER_AREA path)."""
    raw = np.random.RandomState(sum(hw)).randint(0, 256, hw + (3,), np.uint8)
    got = timage.stage_raw_to_bucket(raw, (600, 1000), 32)
    want = jimage.stage_raw_to_bucket(raw, (600, 1000), 32)
    assert got[1][0] < hw[0]                 # it was shrunk on the host
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


# ---- roidb, loader, checkpoint fold ----------------------------------------

def synthetic_roidbs(cls):
    """Landscape and portrait images of two sizes (the portrait one is
    larger than its bucket), flipped and filtered."""
    out = []
    for kw in (dict(num_images=3, height=64, width=96, seed=0),
               dict(num_images=2, height=100, width=70, seed=1)):
        ds = cls(num_classes=21, max_objects=3, **kw)
        out += ds.filter_roidb(ds.append_flipped_images(ds.gt_roidb()))
    return out


def assert_roidbs_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            np.testing.assert_array_equal(np.asarray(ra[k]), np.asarray(rb[k]))


def test_synthetic_roidb_matches_jax():
    assert_roidbs_equal(synthetic_roidbs(SyntheticDataset),
                        synthetic_roidbs(JSynthetic))


def loader_cfg(gen, **kw):
    cfg = gen("resnet50", "PascalVOC", tpu__SCALES=((64, 96),), tpu__MAX_GT=4,
              **kw)
    return cfg.replace(network=dataclasses.replace(
        cfg.network, ANCHOR_SCALES=(2, 4), PIXEL_STDS=(127.0, 127.0, 127.0)))


def test_anchor_loader_matches_jax_device_prep_loader():
    """Two epochs of batches: same plan (shuffle, wrap, aspect groups),
    same staged bytes (pre-shrink included), sidecars and gt."""
    roidb = synthetic_roidbs(SyntheticDataset)
    port = AnchorLoader(roidb, loader_cfg(generate_config), 2, seed=3)
    ref = JAnchorLoader(synthetic_roidbs(JSynthetic),
                        loader_cfg(j_generate_config, tpu__DEVICE_PREP=True),
                        2, seed=3)
    assert port.steps_per_epoch == ref.steps_per_epoch == 5
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
    assert any(b["flip"].any() for b in got)


def test_bbox_fold_roundtrip_matches_jax():
    rng = np.random.RandomState(0)
    cfg = generate_config("resnet50", "PascalVOC")
    params = {"rcnn_out/bbox_pred/kernel": rng.randn(16, 84).astype(np.float32),
              "rcnn_out/bbox_pred/bias": rng.randn(84).astype(np.float32),
              "rcnn_out/cls_score/bias": rng.randn(21).astype(np.float32)}
    saved = tckpt.denormalize_for_save(params, cfg)
    tree = {"rcnn_out": {"bbox_pred": {"kernel": params["rcnn_out/bbox_pred/kernel"],
                                       "bias": params["rcnn_out/bbox_pred/bias"]},
                         "cls_score": {"bias": params["rcnn_out/cls_score/bias"]}}}
    ref = j_denormalize(tree, j_generate_config("resnet50", "PascalVOC"))
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(saved[f"rcnn_out/bbox_pred/{k}"],
                                      np.asarray(ref["rcnn_out"]["bbox_pred"][k]))
    np.testing.assert_array_equal(saved["rcnn_out/cls_score/bias"],
                                  params["rcnn_out/cls_score/bias"])
    back = tckpt.normalize_for_train(saved, cfg)
    for k, v in params.items():
        np.testing.assert_allclose(back[k], v, rtol=1e-6, atol=1e-7)
