"""The overlapped eval loop (counterpart of ``mx_rcnn_tpu/eval/pipeline.py:
run_pipelined``): batch N+1's forward runs on the card while batch N is
decoded and NMSed on the host.

* A bounded window: at most ``inflight`` batches are dispatched and not yet
  post-processed.
* Readback without a host stall: each output is copied into a pinned host
  tensor with ``non_blocking=True`` and a CUDA event is recorded after the
  copies; the host task waits on that event, the dispatching thread never
  does.  On the CPU the outputs are host tensors already.
* Host work (decode + per-class NMS, or the device route's per-class
  split, then on a mask model the mask pass) runs on a
  ``host_workers``-wide thread pool; results are addressed by image index,
  so ``all_boxes`` and ``all_masks`` are bit-identical to the serial loop
  at any depth.
* Mask models: the next forward replaces the ``Predictor``'s cached
  pyramid, so each dispatch takes ``capture_feats()`` — the batch's own
  pyramid and token — and its host task hands that to the mask pass
  (``predict_masks_*(..., feats=...)``): batch N's masks come from batch
  N's features while N+1 is in flight.

``inflight=1`` degenerates to the serial order; ``inflight=2`` is double
buffering, the default (``cfg.tpu.EVAL_INFLIGHT``).  A batch arrives on the
device: the loader's ``put`` hook copied it, on the prefetch thread when
there is one; ``loader_wait_s`` is the wait for it.  Not
ported: drawing and the telemetry spans.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mx_rcnn_tpu_torch.ops.postprocess import (decode_image_boxes,
                                               device_dets_to_per_class,
                                               per_class_nms)


class _InFlight:
    """One dispatched batch whose host copies are in flight."""

    __slots__ = ("batch", "host", "event", "n_valid", "feats", "token")

    def __init__(self, batch, host, event, n_valid, feats, token):
        self.batch = batch
        self.host = host          # host tensors the outputs are copied into
        self.event = event        # CUDA event after the copies, or None
        self.n_valid = n_valid
        self.feats = feats        # the batch's pyramid (mask models) or None
        self.token = token


def _to_host(arrays):
    """Start the device-to-host copies of ``arrays`` → (host tensors,
    event recorded after them or None for CPU tensors)."""
    if arrays[0].device.type != "cuda":
        return tuple(arrays), None
    host = tuple(torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                 for a in arrays)
    for h, a in zip(host, arrays):
        h.copy_(a, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def run_pipelined(predictor, test_loader, *, all_boxes, num_classes,
                  max_per_image, thresh, nms_thresh, device_postprocess,
                  inflight, host_workers, progress, all_masks=None) -> dict:
    """Drive the overlapped loop; fills ``all_boxes`` (and ``all_masks``
    when given: the mask pass runs) in place and returns the stats
    ``pred_eval`` reports (seconds: ``loader_wait_s``, the host tasks'
    ``readback_wait_s`` on the copies, ``mask_pass_s`` in their mask
    passes and ``host_post_s`` in all, and ``post_wait_s``, the
    dispatching thread's wait on them).  The loader's batches arrive on
    the device (``pred_eval`` installs ``Predictor.batch_put`` as its
    ``put`` hook)."""
    from mx_rcnn_tpu_torch.eval.tester import _mask_pass

    mode = "pipelined+devpost" if device_postprocess else "pipelined"
    with_masks = all_masks is not None
    inflight = max(int(inflight), 1)
    window: deque = deque()   # dispatched, not yet handed to the pool
    pending: deque = deque()  # host futures, in submission order
    done = 0
    loader_wait = 0.0
    readback_wait = 0.0
    host_post = 0.0
    post_wait = 0.0
    mask_s = 0.0
    pool = ThreadPoolExecutor(max_workers=max(int(host_workers), 1),
                              thread_name_prefix="eval-post")

    def dispatch(batch) -> None:
        if device_postprocess:
            arrays = predictor.predict_detections(
                batch["images"], batch["im_info"], max_per_image, thresh)
        else:
            arrays = predictor.predict(batch["images"], batch["im_info"])[:4]
        feats, token = (predictor.capture_feats() if with_masks
                        else (None, None))
        host, event = _to_host(arrays)
        bv = batch.get("batch_valid")
        n_valid = int(np.sum(bv)) if bv is not None else int(host[0].shape[0])
        window.append(_InFlight(batch, host, event, n_valid, feats, token))

    def host_task(entry: _InFlight) -> tuple:
        t_start = time.perf_counter()
        if entry.event is not None:
            entry.event.synchronize()
        t_ready = time.perf_counter()
        host = [t.numpy() for t in entry.host]
        indices = entry.batch["indices"]
        im_info = np.asarray(entry.batch["im_info"])
        rows = []
        for b in range(entry.n_valid):
            if device_postprocess:
                dets_pc = device_dets_to_per_class(host[0][b], host[1][b],
                                                   num_classes)
            else:
                rois, roi_valid, cls_prob, deltas = host
                boxes = decode_image_boxes(rois[b], deltas[b], im_info[b])
                dets_pc = per_class_nms(cls_prob[b], boxes, roi_valid[b],
                                        num_classes, thresh, nms_thresh,
                                        max_per_image)
            i = int(indices[b])
            for k in range(1, num_classes):
                all_boxes[k][i] = dets_pc[k]
            rows.append(dets_pc)
        t_mask = time.perf_counter()
        if with_masks:
            _mask_pass(predictor, entry.batch, rows, all_boxes, all_masks,
                       test_loader.roidb, max_per_image, num_classes,
                       token=entry.token, feats=entry.feats)
            entry.feats = None   # release the pyramid
        now = time.perf_counter()
        return (entry.n_valid, now - t_start, t_ready - t_start,
                now - t_mask)

    def finish_oldest() -> None:
        pending.append(pool.submit(host_task, window.popleft()))

    def account(res) -> None:
        nonlocal done, host_post, readback_wait, mask_s
        n, dt, wait, masks = res
        done += n
        host_post += dt
        readback_wait += wait
        mask_s += masks
        progress.update(done)

    def reap_done() -> None:
        while pending and pending[0].done():
            account(pending.popleft().result())

    def wait_oldest() -> None:
        nonlocal post_wait
        t = time.perf_counter()
        res = pending.popleft().result()
        post_wait += time.perf_counter() - t
        account(res)

    try:
        it = iter(test_loader)
        while True:
            t_wait = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            loader_wait += time.perf_counter() - t_wait
            reap_done()
            # the window counts dispatched batches and unfinished host work
            while len(window) + len(pending) >= inflight:
                if window:
                    finish_oldest()
                else:
                    wait_oldest()
            dispatch(batch)
            # hand all but the newest batch to the pool: host work on them
            # starts while the newest forward runs
            while len(window) > 1:
                finish_oldest()
        while window:
            finish_oldest()
        while pending:
            wait_oldest()
    finally:
        pool.shutdown(wait=True)
    return {"mode": mode, "images": done, "loader_wait_s": loader_wait,
            "readback_wait_s": readback_wait, "host_post_s": host_post,
            "mask_pass_s": mask_s,
            "post_wait_s": post_wait, "inflight": inflight,
            "host_workers": int(host_workers)}
