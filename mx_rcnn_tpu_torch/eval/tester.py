"""Inference and evaluation driver (counterpart of
``mx_rcnn_tpu/eval/tester.py``: ``Predictor``, ``predict``,
``predict_detections``, the pyramid cache and mask entry points,
``im_detect``, ``_im_detect_device``, ``paste_mask``, ``_mask_pass``,
``_Progress``, ``pred_eval``, ``generate_proposals``).

``Predictor`` binds converted weights to a model on one device;
``im_detect`` runs a batch and maps every image's boxes back to its
original frame, ready for ``ops.postprocess.per_class_nms``;
``pred_eval`` runs a dataset through it and scores the detections.  The
serve engine's entry points are :meth:`Predictor.put_staged` (one
host→device copy of a staged batch), :meth:`Predictor.predict_staged`
and :meth:`Predictor.predict_serve_e2e` (one call each per batch) and
:meth:`Predictor.fetch` (one readback); the engine keeps the
first-dispatch bookkeeping.

Mask R-CNN (``HAS_MASK``): :meth:`Predictor.predict` and
:meth:`Predictor.predict_detections` keep the batch's pyramid, so that the
mask branch runs on the final detections without the body again;
``pred_eval(with_masks=True)`` pastes each detection's 28×28 mask into
its image as an RLE (``_mask_pass``, by ``TEST.MASK_PASTE``) and scores
box and segm (``imdb.evaluate_sds``).  The JAX package's persistent
program cache, mesh plans, int8 variants, drawing and telemetry spans are
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from mx_rcnn_tpu_torch import native
from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.data.image import prep_images
from mx_rcnn_tpu_torch.eval.mask_rle import encode
from mx_rcnn_tpu_torch.logger import logger
from mx_rcnn_tpu_torch.ops.mask_paste import paste_masks
from mx_rcnn_tpu_torch.ops.postprocess import (decode_image_boxes,
                                               device_dets_to_per_class,
                                               device_postprocess,
                                               per_class_nms)
from mx_rcnn_tpu_torch.utils.convert_jax import load_jax_params

INFER_DTYPES = ("float32", "bfloat16")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card, and raises
    when there is none — the port never falls back to the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class Predictor:
    """A model with bound weights on one device.

    ``params``: the flat JAX parameter layout (dict or ``.npz`` path, see
    ``utils/convert_jax.py``).  ``dtype``: ``"float32"`` keeps the
    weights as loaded; ``"bfloat16"`` rounds every float32 parameter and
    FrozenBN statistic through bfloat16, the JAX package's bf16 parameter
    variant.  Compute runs in ``cfg.tpu.COMPUTE_DTYPE``; outputs are
    float32 either way.  With float32 compute on the card, TF32 is
    switched off for cuDNN and cuBLAS, which would otherwise run float32
    convolutions in TF32.
    """

    def __init__(self, model: torch.nn.Module,
                 params: Union[Dict[str, np.ndarray], str, os.PathLike],
                 cfg: Config, device=None, dtype: str = "float32"):
        if dtype not in INFER_DTYPES:
            raise ValueError(f"infer dtype must be one of {INFER_DTYPES}, "
                             f"got {dtype!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.infer_dtype = dtype
        if self.device.type == "cuda" and cfg.tpu.COMPUTE_DTYPE == "float32":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model
        self._bind(params)
        self.model = model.to(self.device).eval()
        net = cfg.network
        self._means = self._put(np.asarray(net.PIXEL_MEANS, np.float32))
        self._stds = self._put(np.asarray(net.PIXEL_STDS, np.float32))
        self._has_mask = bool(net.HAS_MASK)
        # the pyramid of the last forward (mask models) and its batch's
        # identity, (images shape, forward count): the cached mask entry
        # points check it, so a reordered caller fails instead of reading
        # another batch's features
        self._feats = None
        self._feats_token = None
        self._predict_count = 0

    def _bind(self, params) -> None:
        """Copy ``params`` into the model's tensors, where they lie, with
        the dtype variant's rounding."""
        load_jax_params(self.model, params)
        if self.infer_dtype == "bfloat16":
            with torch.no_grad():
                for t in (*self.model.parameters(), *self.model.buffers()):
                    t.copy_(t.to(torch.bfloat16))

    def update_params(self, params) -> None:
        """Swap the bound weights in place, the serving hot-reload
        primitive: the same load and variant rounding as construction, into
        the same tensors on the device, so no program key changes and no
        first dispatch follows.  The caller makes sure that no forward is
        in flight."""
        self._bind(params)
        self._feats = None  # the cached pyramid belongs to the old weights
        self._feats_token = None

    def batch_put(self, batch: dict) -> dict:
        """Move a batch to the device.  A staged raw batch (keys
        ``raw_hw``/``prep_ratio`` beside uint8 ``images``, from
        ``data.image.stage_raw_to_bucket``) is prepped on the device into
        the network input, mirrored where its ``flip`` (B,) is set;
        ``im_info`` and host keys stay numpy."""
        out = dict(batch)
        images = self._put(batch["images"])
        if "raw_hw" in batch:
            flip = out.pop("flip", None)
            images = self.prep(images, self._put(out.pop("raw_hw")),
                               self._put(out.pop("prep_ratio")),
                               self._put(batch["im_info"], torch.float32),
                               None if flip is None else self._put(flip))
        out["images"] = images
        return out

    def prep(self, staged, raw_hw, ratio, im_info, flip=None):
        """``data.image.prep_images`` with this predictor's pixel means,
        stds and space-to-depth, on the tensors' device."""
        return prep_images(staged, raw_hw, ratio, im_info,
                           pixel_means=self._means, pixel_stds=self._stds,
                           s2d=self.cfg.network.HOST_S2D, flip=flip)

    def put_staged(self, staged, raw_hw, ratio, im_info):
        """One host→device copy of a staged batch
        (``data.image.stage_raw_to_bucket`` rows stacked): the uint8 pixels
        (B, Hb, Wb, 3) and their sidecars (raw_hw (B, 2), ratio (B,),
        im_info (B, 3), all as float32, exact for these values) are packed
        into one pinned byte buffer, copied non-blocking, and split again
        on the device → ``(staged uint8, raw_hw int32, ratio float32,
        im_info float32)``."""
        staged = np.ascontiguousarray(staged, np.uint8)
        b = staged.shape[0]
        side = np.concatenate([np.asarray(raw_hw, np.float32).reshape(b, 2),
                               np.asarray(ratio, np.float32).reshape(b, 1),
                               np.asarray(im_info, np.float32).reshape(b, 3)],
                              axis=1)
        npix = staged.size
        off = -(-npix // 4) * 4          # the float32 sidecars 4-aligned
        host = torch.empty(off + side.nbytes, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        buf = host.numpy()
        buf[:npix] = staged.reshape(-1)
        buf[off:] = side.reshape(-1).view(np.uint8)
        dev = host.to(self.device, non_blocking=True)
        side_d = dev[off:].view(torch.float32).view(b, 6)
        return (dev[:npix].view(staged.shape), side_d[:, 0:2].to(torch.int32),
                side_d[:, 2].contiguous(), side_d[:, 3:6].contiguous())

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        """One device→host copy: ``t`` into pinned memory, non-blocking,
        then the stream waited on; a CPU tensor comes back as it is."""
        if t.device.type != "cuda":
            return t.numpy()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return host.numpy()

    def _put(self, x, dtype=None) -> torch.Tensor:
        """``x`` on the device.  Host arrays bound for the card go through
        pinned memory with a non-blocking copy: a copy from pageable memory
        waits for all the work queued before it, which would stall the
        host until the previous batch's forward is done."""
        t = torch.as_tensor(x)
        if self.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device, dtype)

    def _forward(self, images, info):
        """The model's ``predict``; on a mask model ``predict_with_feats``,
        its pyramid kept for this batch's mask pass."""
        self._predict_count += 1
        self._feats_token = (tuple(images.shape), self._predict_count)
        if self._has_mask:
            out, self._feats = self.model.predict_with_feats(images, info)
            return out
        return self.model.predict(images, info)

    @torch.inference_mode()
    def predict(self, images, im_info):
        """The model's ``predict`` on the device → ``(rois, roi_valid,
        cls_prob, bbox_deltas, roi_scores)``, tensors on the device; a mask
        model keeps the batch's pyramid (:meth:`capture_feats`)."""
        return self._forward(self._put(images),
                             self._put(im_info, torch.float32))

    @property
    def feats_token(self):
        """The identity of the batch whose pyramid is cached: take it right
        after :meth:`predict` and hand it to the cached mask entry
        points."""
        return self._feats_token

    def capture_feats(self):
        """``(pyramid, token)`` of the last forward: a handle that stays
        valid after the next forward replaces the cache, so the overlapped
        loop runs batch N's mask pass while batch N+1 is in flight."""
        return self._feats, self._feats_token

    def _check_token(self, token) -> None:
        if token != self._feats_token:
            raise AssertionError(
                f"stale pyramid cache: predict() was last called on batch "
                f"{self._feats_token}, not {token}; run predict() on the "
                f"batch whose masks you want (pass predictor.feats_token "
                f"taken right after predict())")

    def _cached(self, token, feats):
        if not self._has_mask:
            raise ValueError("the model has no mask head")
        if feats is None:
            if self._feats is None:
                raise AssertionError("call predict() on this batch first")
            self._check_token(token)
            feats = self._feats
        return feats

    @torch.inference_mode()
    def predict_masks(self, images, im_info, boxes, labels):
        """Boxes (B, R, 4) in the scaled frame and labels (B, R) → (B, R,
        28, 28) mask probabilities on the device, the pyramid computed
        again from ``images`` (right for any batch)."""
        if not self._has_mask:
            raise ValueError("the model has no mask head")
        return self.model.predict_masks(
            self._put(images), self._put(im_info, torch.float32),
            self._put(boxes, torch.float32), self._put(labels, torch.int64))

    @torch.inference_mode()
    def predict_masks_cached(self, boxes, labels, token, feats=None):
        """The mask branch over the pyramid of the preceding forward, which
        ``token`` (:attr:`feats_token` of that call) must name; a ``feats``
        from :meth:`capture_feats` is used instead, and then no check is
        needed.  → (B, R, 28, 28) float32 on the device."""
        feats = self._cached(token, feats)
        return self.model.masks_from_feats(
            feats, self._put(boxes, torch.float32),
            self._put(labels, torch.int64))

    @torch.inference_mode()
    def predict_masks_packed(self, boxes, labels, orig_boxes, hp: int,
                             wp: int, token, feats=None):
        """The mask branch and the paste on the device: scaled-frame
        ``boxes`` feed ROIAlign, original-frame ``orig_boxes`` place the
        masks in the padded (hp, wp) frame → (B, R, wp, hp // 8) packed
        bits on the device (``ops/mask_paste.py``); ``token``/``feats`` as
        in :meth:`predict_masks_cached`."""
        probs = self.predict_masks_cached(boxes, labels, token, feats)
        return paste_masks(probs, self._put(orig_boxes, torch.float32),
                           hp, wp)

    @torch.inference_mode()
    def predict_rpn(self, images, im_info):
        """``FasterRCNN.predict_rpn`` on the device → ``(rois (B, P, 4),
        roi_scores (B, P), roi_valid (B, P))`` in the scaled image frame,
        tensors on the device."""
        return self.model.predict_rpn(self._put(images),
                                      self._put(im_info, torch.float32))

    @torch.inference_mode()
    def predict_detections(self, images, im_info, max_per_image: int,
                           thresh: float):
        """The forward and the device post-process
        (``ops.postprocess.device_postprocess``, the per-class NMS of the
        batch on the NMS kernels when ``TEST.CXX_PROPOSAL``) → ``(dets
        (B, cap, 6) [x1,y1,x2,y2,score,cls], valid (B, cap))``, still on
        the device.  The forward's outputs are float32 before the box
        math, whatever the compute dtype."""
        return self._detections(self._put(images),
                                self._put(im_info, torch.float32),
                                max_per_image, thresh)

    @torch.inference_mode()
    def predict_staged(self, staged, raw_hw, ratio, im_info):
        """Device prep and :meth:`predict` in one call, on the device
        tensors of :meth:`put_staged` → ``predict``'s outputs."""
        return self.model.predict(self.prep(staged, raw_hw, ratio, im_info),
                                  im_info)

    @torch.inference_mode()
    def predict_serve_e2e(self, staged, raw_hw, ratio, im_info, flip,
                          max_per_image: int, thresh: float,
                          return_forward: bool = False):
        """The single-dispatch serving call: device prep
        (``prep_images``), the forward and the device post-process, on the
        device tensors of :meth:`put_staged` → ``(dets (B, cap, 6),
        valid (B, cap))``, still on the device.  ``flip`` (B,) bool or
        None.  ``return_forward`` appends the forward's ``(rois,
        roi_valid, cls_prob, bbox_deltas)`` (the hot-reload canary checks
        them: the detections zero their padded rows)."""
        return self._detections(self.prep(staged, raw_hw, ratio, im_info,
                                          flip), im_info, max_per_image,
                                thresh, return_forward)

    def _detections(self, images, info, max_per_image, thresh,
                    return_forward: bool = False):
        rois, roi_valid, cls_prob, bbox_deltas, _ = self._forward(images,
                                                                  info)
        cfg = self.cfg
        dets, valid = device_postprocess(
            rois.float(), roi_valid, cls_prob.float(), bbox_deltas.float(),
            info, num_classes=cfg.NUM_CLASSES, thresh=float(thresh),
            nms_thresh=cfg.TEST.NMS, max_per_image=int(max_per_image),
            use_kernel=cfg.TEST.CXX_PROPOSAL)
        if return_forward:
            return dets, valid, (rois, roi_valid, cls_prob, bbox_deltas)
        return dets, valid


def im_detect(predictor: Predictor, batch: dict):
    """Forward one batch → per-image ``(scores (R, K), boxes (R, 4K),
    valid (R,))`` numpy triples in ORIGINAL image coordinates, one per
    valid batch row (``batch_valid``, default all)."""
    rois, roi_valid, cls_prob, bbox_deltas, _ = predictor.predict(
        batch["images"], batch["im_info"])
    rois, roi_valid, cls_prob, bbox_deltas = (
        t.cpu().numpy() for t in (rois, roi_valid, cls_prob, bbox_deltas))
    im_info = np.asarray(batch["im_info"])
    n = int(np.sum(batch.get("batch_valid", np.ones(len(rois), bool))))
    return [(cls_prob[b], decode_image_boxes(rois[b], bbox_deltas[b], im_info[b]),
             roi_valid[b]) for b in range(n)]


def _im_detect_device(predictor: Predictor, batch: dict, max_per_image: int,
                      thresh: float, num_classes: int) -> list:
    """One batch through :meth:`Predictor.predict_detections` → per valid
    batch row, the per-class ``[None, (N1, 5), ...]`` list that
    ``per_class_nms`` returns, so ``all_boxes`` fills alike on both
    routes."""
    dets, dvalid = predictor.predict_detections(
        batch["images"], batch["im_info"], max_per_image, thresh)
    dets, dvalid = dets.cpu().numpy(), dvalid.cpu().numpy()
    n = int(np.sum(batch.get("batch_valid", np.ones(len(dets), bool))))
    return [device_dets_to_per_class(dets[b], dvalid[b], num_classes)
            for b in range(n)]


def generate_proposals(predictor: Predictor, test_loader, roidb: list,
                       cache_path: Optional[str] = None) -> list:
    """The RPN over ``test_loader`` (a ``TestLoader`` over ``roidb``): each
    valid batch row's kept proposals, in the original image frame (``rois
    / im_info[2]``), score-descending, float32, into ``roidb[i]
    ["proposals"]`` (alternate training, stages 2 and 5).  One readback a
    batch.  With ``cache_path``, the list of every record's proposals is
    pickled there (``tools/train_rcnn.py --proposals`` reads it back)."""
    for batch in test_loader:
        batch = predictor.batch_put(batch)
        rois, scores, valid = predictor.predict_rpn(batch["images"],
                                                    batch["im_info"])
        packed = predictor.fetch(torch.cat(
            [rois.float(), scores.float()[..., None],
             valid.float()[..., None]], dim=-1))
        im_info = np.asarray(batch["im_info"])
        n = int(np.sum(batch["batch_valid"]))
        for b in range(n):
            i = int(batch["indices"][b])
            v = packed[b, :, 5] > 0
            props = packed[b, v, :4] / im_info[b, 2]
            order = np.argsort(-packed[b, v, 4])
            roidb[i]["proposals"] = props[order].astype(np.float32)
    if cache_path:
        with open(cache_path, "wb") as f:
            pickle.dump([r.get("proposals") for r in roidb], f,
                        pickle.HIGHEST_PROTOCOL)
        logger.info("wrote proposals to %s", cache_path)
    return roidb


def _resize_coeffs(n_src: int, n_dst: int):
    """Per output pixel of a linear resize from ``n_src`` to ``n_dst``
    pixels: the two source pixels and their float32 weights, as
    ``cv2.resize``'s ``INTER_LINEAR`` sets them up for float images
    (source ``(j + 0.5) · scale − 0.5`` in double, then float; clamped to
    the edge pixel with weight 0 past either end)."""
    scale = 1.0 / (n_dst / n_src)
    fx = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx)
    fx = (fx - sx).astype(np.float32)
    sx = sx.astype(np.int64)
    edge = (sx < 0) | (sx >= n_src - 1)
    fx[edge] = 0.0
    sx = np.clip(sx, 0, n_src - 1)
    return sx, np.minimum(sx + 1, n_src - 1), np.float32(1.0) - fx, fx


def paste_mask(prob: np.ndarray, box, h: int, w: int) -> np.ndarray:
    """One (M, M) mask probability map → its (h, w) uint8 binary mask at
    ``box`` (original frame, [x1, y1, x2, y2]): resized to the integer
    window [floor(x1), ceil(x2)] × [floor(y1), ceil(y2)] by a linear
    resize in float32 (rows first, then columns, as ``cv2.resize``
    ``INTER_LINEAR`` does; the JAX package calls cv2 here), thresholded at
    0.5 and clipped to the frame."""
    prob = np.asarray(prob, np.float32)
    m = prob.shape[0]
    x1, y1 = int(np.floor(box[0])), int(np.floor(box[1]))
    x2, y2 = int(np.ceil(box[2])), int(np.ceil(box[3]))
    bw, bh = max(x2 - x1 + 1, 1), max(y2 - y1 + 1, 1)
    c0, c1, a0, a1 = _resize_coeffs(m, bw)
    r0, r1, b0, b1 = _resize_coeffs(m, bh)
    rows = prob[:, c0] * a0 + prob[:, c1] * a1               # (M, bw)
    resized = rows[r0] * b0[:, None] + rows[r1] * b1[:, None]  # (bh, bw)
    out = np.zeros((h, w), np.uint8)
    ox1, oy1 = max(x1, 0), max(y1, 0)
    ox2, oy2 = min(x2 + 1, w), min(y2 + 1, h)
    if ox2 > ox1 and oy2 > oy1:
        out[oy1:oy2, ox1:ox2] = (
            resized[oy1 - y1:oy2 - y1, ox1 - x1:ox2 - x1] >= 0.5)
    return out


MASK_PASTE_MODES = ("native", "device", "host")


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _mask_pass(predictor: Predictor, batch: dict, dets: list, all_boxes,
               all_masks, roidb: list, max_per_image: int, num_classes: int,
               token=None, feats=None) -> None:
    """The mask branch on one batch's final detections: ``all_masks[k][i]``
    gets one full-image RLE dict per row of ``all_boxes[k][i]``.

    ``cfg.TEST.MASK_PASTE`` picks the paste: ``"native"`` reads back the
    (R, 28, 28) probabilities and pastes and encodes each in C++
    (``native.paste_rle``; raises when the library is unavailable);
    ``"device"`` pastes on the card and reads back packed bits, encoded in
    C++ (``native.rle_encode_packed``); ``"host"`` is :func:`paste_mask`
    and ``mask_rle.encode`` in numpy, the oracle of the other two.  Up to
    ``max_per_image`` (or 100 without a cap) detections an image go
    through the branch at once; more are drained in further passes.
    ``token``/``feats``: the pyramid of this batch's forward (see
    :meth:`Predictor.predict_masks_cached`)."""
    if not dets:
        return
    mode = predictor.cfg.TEST.MASK_PASTE
    if mode not in MASK_PASTE_MODES:
        raise ValueError(f"TEST.MASK_PASTE must be one of "
                         f"{MASK_PASTE_MODES}, got {mode!r}")
    im_info = np.asarray(batch["im_info"])
    indices = batch["indices"]
    b_all = batch["images"].shape[0]   # the padded batch; dets: valid rows
    r_cap = max_per_image if max_per_image > 0 else 100
    if mode == "device":
        # the padded original frame of every image of the batch, in
        # multiples of 128 (few shapes; the encoder's 64-bit columns)
        hp = _round_up(max(roidb[int(indices[b])]["height"]
                           for b in range(len(dets))), 128)
        wp = _round_up(max(roidb[int(indices[b])]["width"]
                           for b in range(len(dets))), 128)
    queues = [[] for _ in range(b_all)]    # (class, image, row) a batch row
    for b in range(len(dets)):
        i = int(indices[b])
        for k in range(1, num_classes):
            queues[b] += [(k, i, di) for di in range(len(all_boxes[k][i]))]
    while any(queues):
        mboxes = np.zeros((b_all, r_cap, 4), np.float32)   # scaled frame
        morig = np.zeros((b_all, r_cap, 4), np.float32)    # original frame
        mlabels = np.zeros((b_all, r_cap), np.int64)
        taken = []
        for b in range(b_all):
            taken.append(queues[b][:r_cap])
            queues[b] = queues[b][r_cap:]
            for r, (k, i, di) in enumerate(taken[b]):
                morig[b, r] = all_boxes[k][i][di][:4]
                mboxes[b, r] = morig[b, r] * im_info[b, 2]
                mlabels[b, r] = k
        if mode == "device":
            packed = predictor.fetch(predictor.predict_masks_packed(
                mboxes, mlabels, morig, hp, wp, token, feats))
        else:
            probs = predictor.fetch(predictor.predict_masks_cached(
                mboxes, mlabels, token, feats))
        for b in range(b_all):
            for r, (k, i, di) in enumerate(taken[b]):
                h, w = roidb[i]["height"], roidb[i]["width"]
                box = all_boxes[k][i][di][:4]
                if mode == "device":
                    rle = {"size": [h, w], "counts":
                           native.rle_encode_packed(packed[b, r], h, w)}
                elif mode == "native":
                    rle = {"size": [h, w], "counts":
                           native.paste_rle(probs[b, r], box, h, w)}
                else:
                    rle = encode(paste_mask(probs[b, r], box, h, w))
                if all_masks[k][i] is None:
                    all_masks[k][i] = [None] * len(all_boxes[k][i])
                all_masks[k][i][di] = rle


class _Progress:
    """Eval progress: one log line per ``every`` images, whatever the batch
    size and the order batches complete in."""

    def __init__(self, total: int, every: int = 100):
        self.total = total
        self.every = max(int(every), 1)
        self._next = self.every
        self.t0 = time.perf_counter()

    def update(self, done: int) -> None:
        if done < self._next:
            return
        self._next = (done // self.every + 1) * self.every
        rate = max(done, 1) / max(time.perf_counter() - self.t0, 1e-9)
        logger.info("im_detect: %d/%d  %.3fs/im  %.1f imgs/s", done,
                    self.total, 1.0 / rate, rate)


def _probe_det_cache(det_cache: str) -> None:
    """Fail on an unwritable ``det_cache`` before the dataset runs: a
    throwaway file is written and removed beside it."""
    if os.path.isdir(det_cache):
        raise IsADirectoryError(f"det_cache is a directory: {det_cache}")
    d = os.path.dirname(det_cache)
    if d:
        os.makedirs(d, exist_ok=True)
    probe = f"{det_cache}.probe.{os.getpid()}"
    open(probe, "wb").close()
    os.remove(probe)


def _write_det_cache(det_cache: str, all_boxes) -> None:
    """Pickle ``all_boxes`` to a temporary file and rename it, so
    ``det_cache`` is only ever complete or absent."""
    tmp = f"{det_cache}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, det_cache)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    logger.info("cached detections to %s", det_cache)


def pred_eval(predictor: Predictor, test_loader, imdb,
              max_per_image: Optional[int] = None,
              thresh: Optional[float] = None,
              vis: bool = False,
              with_masks: bool = False,
              det_cache: Optional[str] = None,
              inflight: Optional[int] = None,
              host_workers: Optional[int] = None,
              device_postprocess: bool = False) -> dict:
    """The dataset loop: ``all_boxes[cls][image]`` = (N, 5)
    [x1,y1,x2,y2,score] after the per-class score threshold, NMS and the
    per-image cap; then ``imdb.evaluate_detections``.

    ``with_masks`` (a mask model): each batch's final detections go through
    the mask branch (``_mask_pass``, ``TEST.MASK_PASTE``), and box and segm
    are scored by ``imdb.evaluate_sds`` → ``{"bbox": …, "segm": …}``; a
    dataset without segm scoring (PASCAL VOC) scores boxes only, with a
    warning, as the JAX package does.

    ``det_cache``: pickle the final ``all_boxes`` there (probed before the
    loop, written through a rename after it) for ``tools/reeval.py``.

    ``inflight`` (default ``cfg.tpu.EVAL_INFLIGHT``): the window of the
    overlapped loop (``eval/pipeline.py``), which post-processes batch N
    on ``host_workers`` threads while batch N+1 runs on the card;
    ``all_boxes`` is bit-identical to the serial loop (``inflight=0``) at
    any depth.

    ``device_postprocess``: decode, per-class NMS and cap on the card
    (:meth:`Predictor.predict_detections`); the host reads back
    ``max_per_image`` rows per image.  Exact score ties at the cap may
    resolve differently from the host route.

    The loader's ``put`` hook (the ``TestLoader`` contract) is set to
    :meth:`Predictor.batch_put`, so that each batch comes on the device,
    copied and prepped on the prefetch thread when there is one;
    ``loader_wait_s`` is the wait for the next batch (at ``prefetch`` 0,
    its read and copy).

    Returns the scorer's dict, plus ``"eval_pipeline"``: the loop's
    mode, images, wall time, images per second, loader wait, the mask
    passes' seconds (``mask_pass_s``) and, for the overlapped loop, its
    readback wait, host post-process time (the mask passes included), the
    time the loop waited on it and the overlap fraction
    ``1 − post_wait / host_post``.
    """
    if vis:
        raise NotImplementedError("pred_eval(vis=True): drawing needs cv2 "
                                  "and is not ported")
    if not hasattr(test_loader, "put"):
        raise TypeError(f"pred_eval: {type(test_loader).__name__} has no "
                        f"put hook (the TestLoader contract)")
    cfg = predictor.cfg
    if max_per_image is None:
        max_per_image = cfg.TEST.MAX_PER_IMAGE
    if thresh is None:
        thresh = cfg.TEST.THRESH
    if inflight is None:
        inflight = cfg.tpu.EVAL_INFLIGHT
    if host_workers is None:
        host_workers = cfg.tpu.EVAL_HOST_WORKERS
    num_classes = imdb.num_classes
    num_images = imdb.num_images
    with_masks = with_masks and cfg.network.HAS_MASK
    if with_masks and not hasattr(imdb, "evaluate_sds"):
        logger.warning("%s has no segm evaluation; scoring boxes only",
                       type(imdb).__name__)
        with_masks = False
    if det_cache:
        _probe_det_cache(det_cache)

    test_loader.put = predictor.batch_put  # batches arrive on the device

    all_boxes: List[List] = [[None for _ in range(num_images)]
                             for _ in range(num_classes)]
    all_masks: Optional[List[List]] = (
        [[None for _ in range(num_images)] for _ in range(num_classes)]
        if with_masks else None)
    progress = _Progress(num_images)
    stats: dict = {}
    mask_s = 0.0
    if inflight and int(inflight) > 0:
        from mx_rcnn_tpu_torch.eval.pipeline import run_pipelined
        stats = run_pipelined(
            predictor, test_loader, all_boxes=all_boxes, all_masks=all_masks,
            num_classes=num_classes, max_per_image=max_per_image,
            thresh=thresh, nms_thresh=cfg.TEST.NMS,
            device_postprocess=device_postprocess, inflight=int(inflight),
            host_workers=int(host_workers), progress=progress)
        done, loader_wait = stats["images"], stats["loader_wait_s"]
        mode, mask_s = stats["mode"], stats["mask_pass_s"]
    else:
        mode = "serial+devpost" if device_postprocess else "serial"
        done = 0
        loader_wait = 0.0
        it = iter(test_loader)
        while True:
            t_wait = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            loader_wait += time.perf_counter() - t_wait
            if device_postprocess:
                dets = _im_detect_device(predictor, batch, max_per_image,
                                         thresh, num_classes)
            else:
                dets = im_detect(predictor, batch)
            for b, row in enumerate(dets):
                i = int(batch["indices"][b])
                if device_postprocess:
                    dets_pc = row
                else:
                    scores, boxes, valid = row
                    dets_pc = per_class_nms(scores, boxes, valid, num_classes,
                                            thresh, cfg.TEST.NMS,
                                            max_per_image)
                for k in range(1, num_classes):
                    all_boxes[k][i] = dets_pc[k]
                done += 1
            if with_masks:
                t_mask = time.perf_counter()
                _mask_pass(predictor, batch, dets, all_boxes, all_masks,
                           test_loader.roidb, max_per_image, num_classes,
                           token=predictor.feats_token)
                mask_s += time.perf_counter() - t_mask
            progress.update(done)
    wall = time.perf_counter() - progress.t0
    rate = done / max(wall, 1e-9)
    host_post = stats.get("host_post_s", 0.0)
    post_wait = stats.get("post_wait_s", 0.0)
    meta = dict(mode=mode, images=done, imgs_per_sec=rate, wall_s=wall,
                loader_wait_s=loader_wait, mask_pass_s=mask_s,
                readback_wait_s=stats.get("readback_wait_s", 0.0),
                host_post_s=host_post, post_wait_s=post_wait,
                overlap_frac=(max(0.0, 1.0 - post_wait / host_post)
                              if host_post > 0 else 0.0),
                inflight=int(inflight), host_workers=int(host_workers),
                device_postprocess=bool(device_postprocess))
    logger.info("pred_eval[%s]: %d images  Wall=%.1fs  LoaderWait=%.1fs  "
                "%.1f imgs/s  overlap %.2f", mode, done, wall, loader_wait,
                rate, meta["overlap_frac"])
    if det_cache:
        _write_det_cache(det_cache, all_boxes)
    out = (imdb.evaluate_sds(all_boxes, all_masks) if with_masks
           else imdb.evaluate_detections(all_boxes))
    out["eval_pipeline"] = meta
    return out
