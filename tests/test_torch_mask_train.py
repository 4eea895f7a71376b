"""The host and device pieces of the port's Mask R-CNN training against the
JAX package, on the CPU.

* ``mask_bce`` against the JAX one: logits beyond ±30, all-zero weights
  (the denominator clamped at 1), bf16 logits, and a batch reduced per
  image as the JAX ``vmap(mask_bce)``; float32 on both sides, rtol 1e-6.
* ``mask_targets_for_rois`` against the JAX one on the identity RoI, a
  shifted RoI, a RoI outside its gt box, RoIs past the crop's top edge
  (both taps clipped to S − 1) and seeded random RoIs: equal except at
  pixels whose float64 sample lies within 1e-5 of 0.5, the threshold's
  band, where the two libraries' float32 sums may round to either side;
  the separable form against its ``_sample_gather`` oracle within 1e-6.
* ``rasterize_gt_masks`` bitwise against the JAX one (cv2): polygons with
  and without the flip, several parts, parts of fewer than 3 points,
  points outside the canvas; RLE dicts with compressed and list counts,
  flipped; ``None``; more gt than ``max_gt``.  ``resize_nearest`` alone
  against ``cv2.resize(INTER_NEAREST)`` for crop sides 1…300, up and down.
* ``sample_rois``'s ``gt_index`` and ``is_fg`` equal to the JAX ones on
  the same uniforms.
* ``AnchorLoader`` batches of a mask network on a COCO fixture (flipped
  records, polygons, RLE dicts, a record past ``MAX_GT``): the gt keys and
  ``gt_masks`` equal to the JAX device-prep ``AnchorLoader``'s, serially
  and at 2 workers, bitwise; ``ROIIter`` carries no masks.
* ``metric_scalars`` reports ``MaskLoss``.
"""

import dataclasses
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data import loader as j_loader
from mx_rcnn_tpu.data.mask import rasterize_gt_masks as j_rasterize
from mx_rcnn_tpu.models.losses import mask_bce as j_mask_bce
from mx_rcnn_tpu.ops.mask_target import _lerp_weights as j_lerp_weights
from mx_rcnn_tpu.ops.mask_target import \
    mask_targets_for_rois as j_mask_targets
from mx_rcnn_tpu.ops.sample_rois import sample_rois as j_sample_rois

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data import loader as t_loader
from mx_rcnn_tpu_torch.data.coco_dataset import COCODataset
from mx_rcnn_tpu_torch.data.mask import (GT_MASK_SIZE, rasterize_gt_masks,
                                         resize_nearest)
from mx_rcnn_tpu_torch.eval.mask_rle import counts_to_string, encode
from mx_rcnn_tpu_torch.models.losses import mask_bce
from mx_rcnn_tpu_torch.ops import mask_target
from mx_rcnn_tpu_torch.ops.mask_target import mask_targets_for_rois
from mx_rcnn_tpu_torch.ops.sample_rois import sample_rois
from mx_rcnn_tpu_torch.train.metric import metric_scalars
from tests.fixtures import make_mini_coco

torch.set_num_threads(2)

S, OUT = 16, 8  # a small gt crop and target side for the op tests
BAND = 1e-5


# ---- mask_bce -----------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "large", "zero_weight", "bf16"])
def test_mask_bce_matches_jax(case):
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 6, 7, 7).astype(np.float32) * 4
    target = (rng.rand(2, 6, 7, 7) < 0.5).astype(np.float32)
    weight = (rng.rand(2, 6) < 0.6).astype(np.float32)
    if case == "large":
        logits[..., :3, :] = rng.choice([-45.0, 31.0, 60.0], (2, 6, 3, 7))
    if case == "zero_weight":
        weight[1] = 0.0
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    jdtype = jnp.bfloat16 if case == "bf16" else jnp.float32
    got = mask_bce(torch.from_numpy(logits).to(dtype),
                   torch.from_numpy(target), torch.from_numpy(weight))
    assert got.dtype == torch.float32 and got.shape == (2,)
    want = jax.vmap(j_mask_bce)(jnp.asarray(logits, jdtype), target, weight)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    if case == "zero_weight":
        assert float(got[1]) == 0.0
    # one image alone is the JAX scalar
    one = mask_bce(torch.from_numpy(logits[0]).to(dtype),
                   torch.from_numpy(target[0]), torch.from_numpy(weight[0]))
    np.testing.assert_allclose(float(one), float(want[0]), rtol=1e-6)


# ---- mask_targets_for_rois ------------------------------------------------------

def target_case(name, rng):
    """(gt_masks (G, S, S), gt_boxes (G, 4), rois (R, 4), gt_index (R,))."""
    g = 3
    masks = (rng.rand(g, S, S) < 0.5).astype(np.float32)
    masks[1] = 0.0
    masks[1, 4:12, 3:9] = 1.0
    boxes = np.asarray([[10, 12, 50, 40], [0, 0, 31, 63], [20, 5, 21, 6]],
                       np.float32)
    if name == "identity":
        rois, gi = boxes.copy(), np.arange(g)
    elif name == "shifted":
        rois = boxes + np.asarray([3.5, -2.25, 3.5, -2.25], np.float32)
        gi = np.arange(g)
    elif name == "outside":
        rois = boxes + np.asarray([200, 300, 200, 300], np.float32)
        gi = np.arange(g)
    elif name == "top_edge":
        # RoIs reaching past the crop's bottom/right edge: both lerp taps
        # clip to S − 1
        rois = np.stack([boxes[:, 0] + 0.3 * (boxes[:, 2] - boxes[:, 0]),
                         boxes[:, 1] + 0.5 * (boxes[:, 3] - boxes[:, 1]),
                         boxes[:, 2] + 0.02 * (boxes[:, 2] - boxes[:, 0]),
                         boxes[:, 3] + 0.03 * (boxes[:, 3] - boxes[:, 1])],
                        1).astype(np.float32)
        gi = np.arange(g)
    else:
        r = 40
        gi = rng.randint(0, g, r)
        xy = rng.uniform(-10, 60, (r, 2))
        wh = rng.uniform(0.5, 50, (r, 2))
        rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return masks, boxes, rois, gi


def sample64(masks, boxes, rois, gi, out):
    """The bilinear samples before the threshold, in float64 (the band's
    reference)."""
    my, mx = mask_target._frame_coords(
        torch.from_numpy(boxes[None]).double(), torch.from_numpy(rois[None]),
        torch.from_numpy(gi[None]), masks.shape[-1], out)
    return mask_target._sample_gather(torch.from_numpy(masks[gi]).double(),
                                      my[0].double(), mx[0].double(), out,
                                      masks.shape[-1]).numpy()


@pytest.mark.parametrize("name", ["identity", "shifted", "outside",
                                  "top_edge", "random"])
def test_mask_targets_match_jax(name):
    rng = np.random.RandomState(3)
    masks, boxes, rois, gi = target_case(name, rng)
    want = np.asarray(j_mask_targets(masks, boxes, rois, gi, out_size=OUT))
    for dtype in (torch.float32, torch.uint8):
        got = mask_targets_for_rois(
            torch.from_numpy(masks).to(dtype)[None],
            torch.from_numpy(boxes)[None], torch.from_numpy(rois)[None],
            torch.from_numpy(gi)[None], out_size=OUT)[0].numpy()
        assert got.dtype == np.float32 and got.shape == (len(rois), OUT, OUT)
        v64 = sample64(masks, boxes, rois, gi, OUT)
        off = got != want
        assert not (off & (np.abs(v64 - 0.5) > BAND)).any(), name
    if name == "outside":
        assert not want.any()
    if name == "identity":
        assert want.any()


def test_mask_targets_batch_and_oracle():
    """Two images in one call equal two calls; the separable sampler equals
    the four-gather oracle before the threshold."""
    rng = np.random.RandomState(4)
    cases = [target_case("random", rng), target_case("shifted", rng)]
    r = min(len(c[2]) for c in cases)
    stack = [torch.from_numpy(np.stack([c[i][:r] if i >= 2 else c[i]
                                        for c in cases])) for i in range(4)]
    both = mask_targets_for_rois(*stack, out_size=OUT)
    for b, c in enumerate(cases):
        one = mask_targets_for_rois(*(torch.from_numpy(
            (x[:r] if i >= 2 else x))[None] for i, x in enumerate(c)),
            out_size=OUT)
        np.testing.assert_array_equal(both[b].numpy(), one[0].numpy())
    masks, boxes, rois, gi = cases[0]
    my, mx = mask_target._frame_coords(
        torch.from_numpy(boxes[None]), torch.from_numpy(rois[None]),
        torch.from_numpy(gi[None]), S, OUT)
    wy, wx = mask_target._lerp_weights(my, S), mask_target._lerp_weights(mx, S)
    m = torch.from_numpy(masks[gi])[None]
    sep = (wy @ m @ wx.transpose(-1, -2))[0].numpy()
    gather = mask_target._sample_gather(torch.from_numpy(masks[gi]), my[0],
                                        mx[0], OUT, S).numpy()
    np.testing.assert_allclose(sep, gather, rtol=0, atol=1e-6)
    # the lerp rows equal the JAX ones, outside rows all zero
    t = np.asarray([-1.5, -1.0, -0.5, 0.0, 3.25, S - 1.0, S - 0.5, S, S + 2],
                   np.float32)
    got = mask_target._lerp_weights(torch.from_numpy(t), S).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_lerp_weights(t, S)))
    assert not got[[0, 1, 7, 8]].any() and got[6, S - 1] == 1.0


# ---- rasterize_gt_masks ----------------------------------------------------------

def rle_of(mask, compressed):
    r = encode(mask)
    return ({"size": r["size"], "counts": counts_to_string(r["counts"])}
            if compressed else r)


def raster_case(rng, h, w):
    """Boxes and segmentations of every kind over an (h, w) image."""
    segs, boxes = [], []
    for k in range(9):
        x1, y1 = rng.uniform(-4, w * 0.6), rng.uniform(-4, h * 0.6)
        x2 = min(x1 + rng.uniform(0.2, w * 0.5), w + 3)
        y2 = min(y1 + rng.uniform(0.2, h * 0.5), h + 3)
        boxes.append((x1, y1, x2, y2))
        kind = k % 6
        if kind == 0:    # one octagon-ish part inside the box
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
            segs.append([list(np.stack([cx + (x2 - x1) / 2 * np.cos(ang),
                                        cy + (y2 - y1) / 2 * np.sin(ang)],
                                       1).ravel())])
        elif kind == 1:  # several parts, one of 2 points, points outside
            segs.append([list(rng.uniform(-20, w + 20, 10)),
                         [x1, y1, x2, y2],
                         list(rng.uniform(-5, max(h, w), 2 * rng.randint(3, 7)))])
        elif kind in (2, 3):
            m = np.zeros((h, w), np.uint8)
            m[rng.randint(0, h):, rng.randint(0, w):] = 1
            m ^= (rng.rand(h, w) < 0.1).astype(np.uint8)
            segs.append(rle_of(m, compressed=kind == 2))
        elif kind == 4:
            segs.append(None)
        else:            # a part of fewer than 3 points only
            segs.append([[x1, y1, x2, y2]])
    return segs, np.asarray(boxes, np.float32)


@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("max_gt", [4, 9, 12])
def test_rasterize_matches_jax_bitwise(flipped, max_gt):
    rng = np.random.RandomState(10 + max_gt)
    for h, w in ((48, 64), (37, 91), (120, 33)):
        segs, boxes = raster_case(rng, h, w)
        if flipped:  # the roidb stores flipped records' boxes mirrored
            boxes = np.stack([w - 1 - boxes[:, 2], boxes[:, 1],
                              w - 1 - boxes[:, 0], boxes[:, 3]], 1)
        got = rasterize_gt_masks(segs, boxes, w, flipped, max_gt)
        want = j_rasterize(segs, boxes, w, flipped, max_gt)
        assert got.dtype == np.uint8
        assert got.shape == (max_gt, GT_MASK_SIZE, GT_MASK_SIZE)
        np.testing.assert_array_equal(got.astype(np.float32), want)
        assert got[:min(max_gt, len(boxes))].any(axis=(1, 2)).sum() >= 2
    # no segmentation at all (VOC, synthetic): full box masks
    got = rasterize_gt_masks(None, boxes[:3], 64, flipped, max_gt)
    np.testing.assert_array_equal(got.astype(np.float32),
                                  j_rasterize(None, boxes[:3], 64, flipped,
                                              max_gt))
    assert got[:3].all() and not got[3:].any()


def test_resize_nearest_matches_cv2():
    rng = np.random.RandomState(0)
    for side in range(1, 301):
        other = rng.randint(1, 301)
        img = (rng.rand(side, other) < 0.5).astype(np.uint8)
        for dst in (GT_MASK_SIZE, 28):
            want = cv2.resize(img, (dst, dst),
                              interpolation=cv2.INTER_NEAREST)
            np.testing.assert_array_equal(resize_nearest(img, dst, dst), want,
                                          err_msg=f"{img.shape} -> {dst}")
        want = cv2.resize(img, (other, side), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(resize_nearest(img, side, other), want)


# ---- sample_rois' mask outputs -------------------------------------------------

def test_sample_rois_gt_index_and_is_fg_match_jax():
    rng = np.random.RandomState(5)
    b, r, g = 2, 30, 5
    gt = np.zeros((b, g, 4), np.float32)
    gt[..., :2] = rng.uniform(0, 60, (b, g, 2))
    gt[..., 2:] = gt[..., :2] + rng.uniform(8, 40, (b, g, 2))
    gtc = rng.randint(1, 6, (b, g)).astype(np.int32)
    gtv = np.ones((b, g), bool)
    gtv[1, 3:] = False
    rois = np.concatenate([gt + rng.uniform(-4, 4, gt.shape),
                           np.concatenate([rng.uniform(0, 80, (b, r - g, 2))]
                                          * 2, -1)
                           + np.asarray([0, 0, 10, 10])], 1).astype(np.float32)
    valid = np.ones((b, r), bool)
    kw = dict(num_classes=6, batch_rois=16, fg_fraction=0.25)
    rois_aug = np.concatenate([rois, gt], 1)
    valid_aug = np.concatenate([valid, gtv], 1)
    draws, want = [], []
    for i in range(b):
        key = jax.random.PRNGKey(i)
        kf, kb = jax.random.split(key)
        draws.append([np.asarray(jax.random.uniform(k, (r + g,)))
                      for k in (kf, kb)])
        want.append(jax.device_get(j_sample_rois(
            rois_aug[i], valid_aug[i], gt[i], gtc[i], gtv[i], key, **kw)))
    got = sample_rois(torch.from_numpy(rois_aug), torch.from_numpy(valid_aug),
                      torch.from_numpy(gt), torch.from_numpy(gtc),
                      torch.from_numpy(gtv),
                      draws=tuple(torch.from_numpy(np.stack(
                          [d[j] for d in draws])) for j in range(2)), **kw)
    for i in range(b):
        np.testing.assert_array_equal(got["gt_index"][i].numpy(),
                                      want[i]["gt_index"])
        np.testing.assert_array_equal(got["is_fg"][i].numpy(),
                                      want[i]["is_fg"])
        np.testing.assert_array_equal(got["label"][i].numpy(),
                                      want[i]["label"])
    assert got["is_fg"].any() and not got["is_fg"].all()


# ---- the loader's gt_masks -------------------------------------------------------

def mask_cfg(gen, **kw):
    cfg = gen("resnet101_fpn_mask", "coco", tpu__SCALES=((64, 96),),
              tpu__MAX_GT=4, tpu__PREFETCH_WATCHDOG_S=30.0, **kw)
    return cfg.replace(network=dataclasses.replace(
        cfg.network, NETWORK="resnet50", FPN_ANCHOR_SCALES=(4,)))


@pytest.fixture(scope="module")
def coco_roidb(tmp_path_factory):
    """A COCO fixture's records and their mirrors, pixels inline (the
    comparison is of the gt and masks, not of two JPEG decoders): polygon
    segmentations, two turned into RLE dicts (compressed and count list),
    one record with more non-crowd gt than ``MAX_GT``."""
    root = str(tmp_path_factory.mktemp("coco"))
    make_mini_coco(os.path.join(root, "coco"), image_set="minitrain", n=6,
                   size=(60, 90), seed=2)
    imdb = COCODataset("minitrain", os.path.join(root, "data"),
                       os.path.join(root, "coco"))
    roidb = [dict(r) for r in imdb.gt_roidb()]
    rng = np.random.RandomState(0)
    for i, rec in enumerate(roidb):
        rec["image_array"] = rng.randint(0, 256, (rec["height"],
                                                  rec["width"], 3), np.uint8)
        segs = list(rec["segmentation"])
        if i < 2 and segs:
            m = np.zeros((rec["height"], rec["width"]), np.uint8)
            x1, y1, x2, y2 = rec["boxes"][0].astype(int)
            m[y1:y2 + 1, x1:(x1 + x2) // 2 + 1] = 1
            segs[0] = rle_of(m, compressed=i == 0)
        rec["segmentation"] = segs
    many = roidb[2]
    reps = 3
    many["boxes"] = np.concatenate([many["boxes"]] * reps)
    many["gt_classes"] = np.concatenate([many["gt_classes"]] * reps)
    many["segmentation"] = list(many["segmentation"]) * reps
    assert len(many["boxes"]) > 4
    return imdb.append_flipped_images(roidb)


GT_KEYS = ("gt_boxes", "gt_classes", "gt_valid", "im_info", "flip",
           "gt_masks")


@pytest.mark.parametrize("workers", [0, 2])
def test_anchor_loader_masks_match_jax(coco_roidb, workers):
    want = list(j_loader.AnchorLoader(
        coco_roidb, mask_cfg(j_generate_config, tpu__DEVICE_PREP=True), 2,
        shuffle=True, seed=4))
    loader = t_loader.AnchorLoader(
        coco_roidb, mask_cfg(generate_config, tpu__LOADER_WORKERS=workers), 2,
        shuffle=True, seed=4)
    try:
        got = list(loader)
    finally:
        loader.close_workers()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["gt_masks"].dtype == np.uint8
        assert a["gt_masks"].shape == (2, 4, GT_MASK_SIZE, GT_MASK_SIZE)
        for k in GT_KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert any(b["flip"].any() for b in got)
    assert all(b["gt_masks"].any() for b in got)


def test_roi_iter_and_box_configs_carry_no_masks(coco_roidb):
    roidb = [dict(r, proposals=r["boxes"][:2]) for r in coco_roidb]
    cfg = mask_cfg(generate_config)
    assert "gt_masks" not in next(iter(t_loader.ROIIter(roidb, cfg, 2)))
    box = cfg.replace(network=dataclasses.replace(cfg.network,
                                                  HAS_MASK=False))
    assert "gt_masks" not in next(iter(t_loader.AnchorLoader(roidb, box, 2)))
    assert "gt_masks" not in t_loader._load_record(roidb[0], cfg,
                                                   cfg.tpu.SCALES[0])


def test_metric_scalars_report_the_mask_loss():
    aux = {"rcnn_label": torch.tensor([[1, 0]]),
           "rcnn_pred": torch.tensor([[1, 1]]),
           "rcnn_label_weight": torch.ones(1, 2),
           "rcnn_cls_loss": torch.tensor(0.5),
           "rcnn_bbox_loss": torch.tensor(0.25),
           "mask_loss": torch.tensor(0.75, requires_grad=True)}
    out = metric_scalars(aux)
    assert float(out["MaskLoss"]) == 0.75 and not out["MaskLoss"].requires_grad
    assert "MaskLoss" not in metric_scalars({k: v for k, v in aux.items()
                                             if k != "mask_loss"})
