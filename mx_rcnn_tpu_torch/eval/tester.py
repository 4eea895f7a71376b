"""Inference and evaluation driver (counterpart of
``mx_rcnn_tpu/eval/tester.py``: ``Predictor``, ``predict``,
``predict_detections``, ``im_detect``, ``_im_detect_device``,
``_Progress``, ``pred_eval``, ``generate_proposals``).

``Predictor`` binds converted weights to a model on one device;
``im_detect`` runs a batch and maps every image's boxes back to its
original frame, ready for ``ops.postprocess.per_class_nms``;
``pred_eval`` runs a dataset through it and scores the detections.  The
serve engine's entry points are :meth:`Predictor.put_staged` (one
host→device copy of a staged batch), :meth:`Predictor.predict_staged`
and :meth:`Predictor.predict_serve_e2e` (one call each per batch) and
:meth:`Predictor.fetch` (one readback); the engine keeps the
first-dispatch bookkeeping.  The JAX package's persistent program cache,
mesh plans, int8 variants, mask pass, drawing and telemetry spans are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.data.image import prep_images
from mx_rcnn_tpu_torch.logger import logger
from mx_rcnn_tpu_torch.models.detector import FasterRCNN
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

    def __init__(self, model: FasterRCNN, params: Union[Dict[str, np.ndarray],
                                                        str, os.PathLike],
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

    @torch.inference_mode()
    def predict(self, images, im_info):
        """``FasterRCNN.predict`` on the device → ``(rois, roi_valid,
        cls_prob, bbox_deltas, roi_scores)``, tensors on the device."""
        return self.model.predict(self._put(images),
                                  self._put(im_info, torch.float32))

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
                          max_per_image: int, thresh: float):
        """The single-dispatch serving call: device prep
        (``prep_images``), the forward and the device post-process, on the
        device tensors of :meth:`put_staged` → ``(dets (B, cap, 6),
        valid (B, cap))``, still on the device.  ``flip`` (B,) bool or
        None."""
        return self._detections(self.prep(staged, raw_hw, ratio, im_info,
                                          flip), im_info, max_per_image,
                                thresh)

    def _detections(self, images, info, max_per_image, thresh):
        rois, roi_valid, cls_prob, bbox_deltas, _ = self.model.predict(
            images, info)
        cfg = self.cfg
        return device_postprocess(
            rois.float(), roi_valid, cls_prob.float(), bbox_deltas.float(),
            info, num_classes=cfg.NUM_CLASSES, thresh=float(thresh),
            nms_thresh=cfg.TEST.NMS, max_per_image=int(max_per_image),
            use_kernel=cfg.TEST.CXX_PROPOSAL)


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
    mode, images, wall time, images per second, loader wait and, for the
    overlapped loop, its readback wait, host post-process time, the time
    the loop waited on it and the overlap fraction
    ``1 − post_wait / host_post``.
    """
    if vis:
        raise NotImplementedError("pred_eval(vis=True): drawing needs cv2 "
                                  "and is not ported")
    if with_masks:
        raise NotImplementedError("pred_eval(with_masks=True): the mask "
                                  "branch is not ported (ROADMAP.md A.7)")
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
    if det_cache:
        _probe_det_cache(det_cache)

    test_loader.put = predictor.batch_put  # batches arrive on the device

    all_boxes: List[List] = [[None for _ in range(num_images)]
                             for _ in range(num_classes)]
    progress = _Progress(num_images)
    stats: dict = {}
    if inflight and int(inflight) > 0:
        from mx_rcnn_tpu_torch.eval.pipeline import run_pipelined
        stats = run_pipelined(
            predictor, test_loader, all_boxes=all_boxes,
            num_classes=num_classes, max_per_image=max_per_image,
            thresh=thresh, nms_thresh=cfg.TEST.NMS,
            device_postprocess=device_postprocess, inflight=int(inflight),
            host_workers=int(host_workers), progress=progress)
        done, loader_wait = stats["images"], stats["loader_wait_s"]
        mode = stats["mode"]
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
            progress.update(done)
    wall = time.perf_counter() - progress.t0
    rate = done / max(wall, 1e-9)
    host_post = stats.get("host_post_s", 0.0)
    post_wait = stats.get("post_wait_s", 0.0)
    meta = dict(mode=mode, images=done, imgs_per_sec=rate, wall_s=wall,
                loader_wait_s=loader_wait,
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
    out = imdb.evaluate_detections(all_boxes)
    out["eval_pipeline"] = meta
    return out
