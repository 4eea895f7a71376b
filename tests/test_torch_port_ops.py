"""Op-level parity of the PyTorch port (``mx_rcnn_tpu_torch.ops``,
``data.image`` and the NMS kernels' plain versions) against the JAX
package, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.  The
JAX NMS runs as the JAX package's own CPU tests run it: ``nms_pallas``
delegates to ``nms_padded`` off the TPU.  Tolerances: box codecs 1e-4
(exp/log in two libraries), ROIAlign 1e-5 (two einsums, different
summation order), image prep 1e-4 (normalized pixels; cv2's float
resample vs the port's float32 bilinear); NMS kept indices are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config
from mx_rcnn_tpu.data import image as jimage
from mx_rcnn_tpu.data.device_prep import _prep_one
from mx_rcnn_tpu.kernels.nms_pallas import nms_pallas
from mx_rcnn_tpu.ops import anchors as janchors
from mx_rcnn_tpu.ops import boxes as jboxes
from mx_rcnn_tpu.ops import postprocess as jpost
from mx_rcnn_tpu.ops.proposal import propose as jpropose
from mx_rcnn_tpu.ops.roi_align import roi_align as jroi_align

from mx_rcnn_tpu_torch.data import image as timage
from mx_rcnn_tpu_torch.kernels import nms_cuda
from mx_rcnn_tpu_torch.ops import anchors as tanchors
from mx_rcnn_tpu_torch.ops import boxes as tboxes
from mx_rcnn_tpu_torch.ops import postprocess as tpost
from mx_rcnn_tpu_torch.ops.nms import nms as tnms, nms_padded
from mx_rcnn_tpu_torch.ops.proposal import propose as tpropose
from mx_rcnn_tpu_torch.ops.roi_align import roi_align as troi_align

torch.set_num_threads(2)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def rand_boxes(rng, n, spread=200.0, size=60.0):
    ctr = rng.rand(n, 2) * spread
    wh = rng.rand(n, 2) * size + 2
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


# ---- boxes and anchors -----------------------------------------------------

def test_box_ops_match_jax():
    rng = np.random.RandomState(0)
    boxes = rand_boxes(rng, 64)
    deltas = (rng.randn(64, 12) * 0.5).astype(np.float32)   # K = 3 classes
    np.testing.assert_allclose(
        tboxes.bbox_pred(t(boxes), t(deltas)).numpy(),
        np.asarray(jboxes.bbox_pred(boxes, deltas)), atol=1e-4, rtol=0)
    wide = (rng.randn(64, 12) * 150).astype(np.float32)
    np.testing.assert_allclose(
        tboxes.clip_boxes(t(wide), 90.0, 130.0).numpy(),
        np.asarray(jboxes.clip_boxes(wide, 90.0, 130.0)), atol=1e-4, rtol=0)
    q = rand_boxes(rng, 17)
    np.testing.assert_allclose(
        tboxes.bbox_overlaps(t(boxes), t(q)).numpy(),
        np.asarray(jboxes.bbox_overlaps(boxes, q)), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        tboxes.bbox_transform(t(boxes), t(boxes[::-1])).numpy(),
        np.asarray(jboxes.bbox_transform(boxes, boxes[::-1])), atol=1e-4,
        rtol=0)


@pytest.mark.parametrize("stride,scales", [(16, (8, 16, 32)), (16, (2, 4)),
                                           (8, (1, 3))])
def test_anchors_match_jax(stride, scales):
    base_t = tanchors.generate_anchors(base_size=stride, scales=scales)
    base_j = janchors.generate_anchors(base_size=stride, scales=scales)
    np.testing.assert_array_equal(base_t, base_j)
    np.testing.assert_array_equal(tanchors.all_anchors(5, 7, stride, base_t),
                                  janchors.all_anchors(5, 7, stride, base_j))


# ---- NMS: plain version of the kernel vs the JAX package ---------------------

def gen(n, seed, spread=800.0, size=150.0):
    """``scripts/check_pallas.py``'s generator: score-sorted boxes, ~2%
    invalid rows."""
    rng = np.random.RandomState(seed)
    ctr = rng.rand(n, 2) * spread
    wh = rng.rand(n, 2) * size + 10
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)
    scores = np.sort(rng.rand(n).astype(np.float32))[::-1].copy()
    valid = np.random.RandomState(seed).rand(n) > 0.02
    return boxes, scores, valid


def jax_keep(boxes, scores, max_out, thresh, valid):
    ki, km = jax.device_get(nms_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), max_out=max_out,
        iou_thresh=thresh, valid=None if valid is None else jnp.asarray(valid)))
    return ki[km]


def port_keep(boxes, scores, max_out, thresh, valid):
    ki, km = nms_padded(t(boxes), t(scores), max_out, thresh,
                        valid=None if valid is None else t(valid))
    return ki.numpy()[km.numpy()]


# check_pallas.py's (n, max_out, thresh) matrix, cut to n <= 4097
NMS_CASES = [(2048, 300, 0.7), (4000, 100, 0.3), (100, 300, 0.5),
             (4097, 300, 0.7), (4000, 300, 0.99), (4000, 300, 0.01)]


@pytest.mark.parametrize("n,max_out,thresh", NMS_CASES)
def test_nms_padded_matches_jax(n, max_out, thresh):
    for seed in range(2):
        boxes, scores, valid = gen(n, seed)
        ref = jax_keep(boxes, scores, max_out, thresh, valid)
        np.testing.assert_array_equal(
            port_keep(boxes, scores, max_out, thresh, valid), ref)


def _adversarial():
    box1 = np.tile(np.asarray([[10., 10., 60., 60.]], np.float32), (512, 1))
    sc1 = np.sort(np.random.RandomState(0).rand(512).astype(np.float32))[::-1]
    sc1 = sc1.copy()
    rng = np.random.RandomState(3)
    tied_boxes = rand_boxes(rng, 300, spread=300.0)
    tied_scores = np.repeat(np.float32([0.9, 0.5, 0.1]), 100)  # exact ties
    return {
        "identical-boxes": (box1, sc1, 300, 0.7, None),
        "all-invalid": (box1, sc1, 300, 0.7, np.zeros(512, bool)),
        "single-box": (box1[:1], sc1[:1], 300, 0.7, None),
        "score-ties": (tied_boxes, tied_scores, 200, 0.5, None),
    }


@pytest.mark.parametrize("name", sorted(_adversarial()))
def test_nms_padded_adversarial_matches_jax(name):
    boxes, scores, max_out, thresh, valid = _adversarial()[name]
    np.testing.assert_array_equal(
        port_keep(boxes, scores, max_out, thresh, valid),
        jax_keep(boxes, scores, max_out, thresh, valid))


def test_kernel_plain_versions_match_jax():
    """The CPU stand-ins of the two CUDA kernels (phase A's word mask,
    phase B's sweep), chained, and the batched wrapper's CPU route, give
    the JAX package's kept indices per image, with a different invalid
    hole in each image and a ragged n (not a multiple of 64)."""
    n, max_out, thresh = 1000, 300, 0.7
    per = [gen(n, s) for s in range(3)]
    boxes = t(np.stack([p[0] for p in per]))
    valid = t(np.stack([np.random.RandomState(100 + s).rand(n) > 0.05
                        for s in range(3)]))
    words = nms_cuda.nms_mask(boxes, thresh)
    assert words.shape == (3, n, nms_cuda.col_blocks(n))
    assert words.dtype == torch.int64
    sweep = nms_cuda.nms_sweep(words, valid, max_out)
    wrapped = nms_cuda.nms_bitmask(boxes, valid, max_out, thresh)
    for b in range(3):
        ref = jax_keep(per[b][0], per[b][1], max_out, thresh,
                       valid[b].numpy())
        for ki, km in (sweep, wrapped):
            np.testing.assert_array_equal(ki[b].numpy()[km[b].numpy()], ref)
            assert not ki[b][~km[b]].any()        # padded slots hold 0


def test_nms_wrappers_reject_bad_inputs():
    boxes = torch.zeros(1, 8, 4)
    valid = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(TypeError):
        nms_cuda.nms_bitmask(boxes.double(), valid, 4, 0.5)
    with pytest.raises(ValueError):
        nms_cuda.nms_bitmask(boxes[0], valid, 4, 0.5)
    with pytest.raises(TypeError):
        nms_cuda.nms_bitmask(boxes, valid.int(), 4, 0.5)
    with pytest.raises(ValueError):
        nms_cuda.nms_bitmask(boxes, valid[:, :5], 4, 0.5)
    with pytest.raises(ValueError):
        nms_cuda.nms_bitmask(boxes.to("meta"), valid.to("meta"), 4, 0.5)


# ---- propose --------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
def test_propose_matches_jax(use_kernel):
    rng = np.random.RandomState(1)
    fh, fw, b = 8, 12, 2
    base = janchors.generate_anchors(base_size=16, scales=(2, 4))
    anchors = janchors.all_anchors(fh, fw, 16, base)
    n = anchors.shape[0]
    # scores on a 1/64 grid: many exact ties, which must go to the lower
    # anchor index as in jax.lax.top_k
    scores = (rng.randint(0, 64, (b, n)) / 64.0).astype(np.float32)
    deltas = (rng.randn(b, n, 4) * 0.3).astype(np.float32)
    im_info = np.asarray([[128, 192, 1.0], [100, 150, 0.78]], np.float32)
    kw = dict(pre_nms_top_n=300, post_nms_top_n=50, nms_thresh=0.7,
              min_size=16)
    j_rois, j_scores, j_valid = jax.device_get(jax.vmap(
        lambda s, d, info: jpropose(s, d, jnp.asarray(anchors), info[0],
                                    info[1], info[2], use_pallas=True, **kw))(
        jnp.asarray(scores), jnp.asarray(deltas), jnp.asarray(im_info)))
    p_rois, p_scores, p_valid = tpropose(t(scores), t(deltas), t(anchors),
                                         t(im_info), use_kernel=use_kernel,
                                         **kw)
    np.testing.assert_array_equal(p_valid.numpy(), j_valid)
    np.testing.assert_allclose(p_rois.numpy(), j_rois, atol=1e-4, rtol=0)
    np.testing.assert_allclose(p_scores.numpy(), j_scores, atol=1e-6, rtol=0)


# ---- ROIAlign -------------------------------------------------------------

@pytest.mark.parametrize("sampling", [1, 2])
def test_roi_align_matches_jax(sampling):
    rng = np.random.RandomState(2)
    feat = rng.randn(2, 10, 14, 8).astype(np.float32)
    rois = rand_boxes(rng, 24, spread=260.0, size=120.0).reshape(2, 12, 4)
    rois[0, 0] = [-40, -30, 10, 5]          # partly outside the map
    rois[1, 1] = [50, 50, 50, 50]           # degenerate: min-1-cell clamp
    rois[1, 2] = [230, 150, 400, 300]       # past the far edge
    kw = dict(spatial_scale=1.0 / 16, pooled_size=7, sampling_ratio=sampling)
    ref = jax.device_get(jax.vmap(
        lambda f, r: jroi_align(f, r, mode="avg", **kw))(feat, rois))
    out = troi_align(t(feat), t(rois), mode="avg", **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # wider than tall and taller than wide take the two einsum orders
    ref_t = jax.device_get(jax.vmap(
        lambda f, r: jroi_align(f, r, mode="avg", **kw))(
            feat.transpose(0, 2, 1, 3), rois[..., [1, 0, 3, 2]]))
    out_t = troi_align(t(feat.transpose(0, 2, 1, 3)),
                       t(rois[..., [1, 0, 3, 2]]), mode="avg", **kw)
    np.testing.assert_allclose(out_t.numpy(), ref_t, atol=1e-5, rtol=0)


def test_roi_align_unported_modes_raise():
    feat, rois = torch.zeros(1, 4, 4, 2), torch.zeros(1, 1, 4)
    for mode, s in (("exact", 1), ("max", 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            troi_align(feat, rois, mode=mode, sampling_ratio=s)
    with pytest.raises(ValueError):
        troi_align(feat, rois, mode="mean")


# ---- image staging and prep -----------------------------------------------

_prep_jit = jax.jit(_prep_one, static_argnums=(7, 8))


def prep_cfg():
    cfg = generate_config("resnet50", "PascalVOC")
    return cfg.network


@pytest.mark.parametrize("s2d", [True, False])
def test_image_prep_matches_jax(s2d):
    net = prep_cfg()
    scale, stride = (64, 96), 16
    raws = [np.random.RandomState(k).randint(0, 256, hw + (3,), np.uint8)
            for k, hw in enumerate([(50, 75), (75, 50), (51, 75), (64, 96),
                                    (33, 47)])]
    mean = jnp.asarray(net.PIXEL_MEANS, jnp.float32)
    std = jnp.asarray(net.PIXEL_STDS, jnp.float32)
    for raw in raws:
        staged, raw_hw, ratio, im_info = timage.stage_raw_to_bucket(
            raw, scale, stride)
        j_staged, j_hw, j_ratio, j_info = jimage.stage_raw_to_bucket(
            raw, scale, stride)
        np.testing.assert_array_equal(staged, j_staged)
        np.testing.assert_array_equal(raw_hw, j_hw)
        assert ratio == j_ratio
        np.testing.assert_array_equal(im_info, j_info)
        assert timage.bucket_shape(scale, stride, raw.shape[1] >= raw.shape[0]
                                   ) == staged.shape[:2]

        out = timage.prep_images(
            t(staged[None]), t(raw_hw[None]), t(np.asarray([ratio])),
            t(im_info[None]), pixel_means=net.PIXEL_MEANS,
            pixel_stds=net.PIXEL_STDS, s2d=s2d)[0].numpy()
        dev = np.asarray(_prep_jit(jnp.asarray(staged), jnp.asarray(raw_hw),
                                   jnp.float32(ratio), jnp.asarray(im_info),
                                   False, mean, std, s2d, jnp.float32))
        np.testing.assert_allclose(out, dev, atol=1e-4, rtol=0)
        host, s, (eh, ew) = jimage.resize_to_bucket(
            jimage.transform_image(raw, net.PIXEL_MEANS, net.PIXEL_STDS),
            scale, stride)
        assert (eh, ew) == tuple(im_info[:2]) and s == im_info[2]
        if s2d:
            host = timage.space_to_depth2(host)
            np.testing.assert_array_equal(host, jimage.space_to_depth2(
                jimage.resize_to_bucket(jimage.transform_image(
                    raw, net.PIXEL_MEANS, net.PIXEL_STDS), scale, stride)[0]))
        np.testing.assert_allclose(out, host, atol=1e-4, rtol=0)


def test_compute_scale_matches_jax():
    for hw in [(375, 500), (500, 375), (600, 1000), (1000, 600), (333, 1200),
               (40, 41)]:
        assert timage.compute_scale(*hw, (600, 1000)) == \
            jimage.compute_scale(*hw, (600, 1000))


# ---- host post-process ----------------------------------------------------

def test_postprocess_matches_jax():
    rng = np.random.RandomState(4)
    r, k = 60, 5
    rois = rand_boxes(rng, r, spread=150.0, size=80.0)
    deltas = (rng.randn(r, 4 * k) * 0.2).astype(np.float32)
    info = np.asarray([120, 180, 0.8], np.float32)
    logits = rng.randn(r, k).astype(np.float32) * 2
    scores = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
        np.float32)
    valid = rng.rand(r) > 0.1
    boxes_t = tpost.decode_image_boxes(rois, deltas, info)
    boxes_j = jpost.decode_image_boxes(rois, deltas, info)
    np.testing.assert_allclose(boxes_t, boxes_j, atol=1e-3, rtol=0)
    for cap in (100, 8):        # 8 exercises the keep-ties-at-cutoff cap
        # both post-processes on the same boxes: the classes and scores of
        # the records must agree exactly, boxes to decode tolerance
        dets_t = tpost.per_class_nms(scores, boxes_j, valid, k, 0.05, 0.3, cap)
        dets_j = jpost.per_class_nms(scores, boxes_j, valid, k, 0.05, 0.3, cap)
        rec_t = tpost.detections_to_records(dets_t)
        rec_j = jpost.detections_to_records(dets_j)
        assert [x["cls"] for x in rec_t] == [x["cls"] for x in rec_j]
        np.testing.assert_allclose([x["score"] for x in rec_t],
                                   [x["score"] for x in rec_j], atol=1e-6)
        np.testing.assert_allclose([x["bbox"] for x in rec_t],
                                   [x["bbox"] for x in rec_j], atol=1e-6)
    # the cut-off rule keeps every row tied at the threshold score
    tied = np.zeros((4, 3), np.float32)
    tied[:, 1] = [0.9, 0.5, 0.5, 0.5]
    tb = np.tile(np.float32([0, 0, 10, 10]), (4, 3)) + \
        np.arange(4, dtype=np.float32)[:, None] * 50
    d = tpost.per_class_nms(tied, tb, np.ones(4, bool), 3, 0.05, 0.3, 2)
    assert len(d[1]) == 4


def stable_greedy_nms(dets, thresh):
    """Greedy NMS in descending score order, equal scores in row order (a
    stable sort), with the legacy +1 areas in float32."""
    order = sorted(range(len(dets)), key=lambda i: -dets[i, 4])
    area = (dets[:, 2] - dets[:, 0] + 1) * (dets[:, 3] - dets[:, 1] + 1)
    keep, removed = [], np.zeros(len(dets), bool)
    for a, i in enumerate(order):
        if removed[i]:
            continue
        keep.append(i)
        for j in order[a + 1:]:
            iw = min(dets[i, 2], dets[j, 2]) - max(dets[i, 0], dets[j, 0]) + 1
            ih = min(dets[i, 3], dets[j, 3]) - max(dets[i, 1], dets[j, 1]) + 1
            inter = np.float32(max(iw, 0) * max(ih, 0))
            if inter / (area[i] + area[j] - inter) > np.float32(thresh):
                removed[j] = True
    return keep


@pytest.mark.parametrize("oracle", ["native", "stable-greedy"])
def test_postprocess_tied_scores_match_reference(oracle):
    """Exact score ties (common once bf16 logits are rounded): among equal
    scores the lower row comes first, as the reference's native NMS sorts
    (``std::stable_sort``).  Integer boxes, so every IoU is the correctly
    rounded quotient of two exact integers in all implementations."""
    from mx_rcnn_tpu import native
    if oracle == "native":
        if not native.available():
            pytest.skip("the JAX package's native library does not load; its "
                        "numpy fallback sorts ties the other way")
        ref_nms = None              # jpost.per_class_nms's default
    else:
        ref_nms = stable_greedy_nms
    # two boxes that overlap at an equal score, one above them
    dets = np.float32([[0, 0, 10, 10, .5], [1, 1, 11, 11, .5],
                       [50, 50, 60, 60, .9]])
    want = native.nms(dets, 0.3) if oracle == "native" \
        else stable_greedy_nms(dets, 0.3)
    assert want == [2, 0]
    assert tnms(dets, 0.3) == want
    rng = np.random.RandomState(11)
    r, k = 200, 4
    xy = rng.randint(0, 120, (r, 2))
    wh = rng.randint(8, 60, (r, 2))
    boxes = np.tile(np.concatenate([xy, xy + wh], 1), (1, k)).astype(
        np.float32)
    scores = rng.choice(np.float32([0.25, 0.5, 0.75]), (r, k))
    valid = rng.rand(r) > 0.1
    for cap in (100, 30):
        got = tpost.per_class_nms(scores, boxes, valid, k, 0.05, 0.3, cap)
        want = jpost.per_class_nms(scores, boxes, valid, k, 0.05, 0.3, cap,
                                   nms_fn=ref_nms)
        for c in range(1, k):
            np.testing.assert_array_equal(got[c], want[c])
