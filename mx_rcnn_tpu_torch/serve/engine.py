"""Online serving engine: the bucket-aware dynamic batcher over a
``Predictor`` (counterpart of ``mx_rcnn_tpu/serve/engine.py``).

Online traffic arrives one image at a time, at arbitrary sizes, and the
detector's throughput depends on batch fill.  Every request is staged into
one of two static bucket shapes (one per orientation), so mixed-size
traffic coalesces into full batches of a handful of programs, and warmup
(``serve/warmup.py``) makes the first dispatch of each before traffic.

Mechanics:

* ``submit`` stages the raw uint8 image into its orientation's bucket
  (``data.image.stage_raw_to_bucket``: a pad-copy; a raw larger than the
  bucket is pre-shrunk there, as cv2 would), routes it to that bucket's
  queue and returns a :class:`ServeFuture`.  The staging runs on the
  caller's thread, or with ``prep_workers`` > 0 in host-NMS mode in the
  prep worker pool (``data/workers.py:WorkerPool.prepare``, made by
  ``start()`` and closed by ``stop()``), off the interpreter lock the
  request threads share; in ``serve_e2e`` mode the caller stages, as in
  the JAX package.  Request threads touch numpy only.
* One dispatcher thread owns the device: every tensor op, kernel launch
  and readback of a batch runs on it (the kernels' launch counters are
  plain integers).  It flushes a bucket when it holds ``batch_size``
  requests, or when its oldest request has waited ``max_delay_ms``.
  Partial batches are padded with repeats of the last request; the
  padding rows never reach a response.
* Backpressure: ``submit`` beyond ``max_queue`` raises
  :class:`RejectedError` (the frontend's 503).  Per-request deadlines are
  swept before every flush: an expired request fails with
  :class:`DeadlineExceededError` (504) and costs no forward.
* A failing batch sets its error on every future of the batch (500).
  Nothing is retried, and nothing moves to the CPU or to the plain NMS.

Two forward modes, both prepping on the device (the port has no cv2):

* host NMS (default, the JAX ``_forward_legacy``): one forward, one
  readback of rois, validity, scores and deltas packed as (B, R, 5 + 5K)
  float32, then decode and per-class NMS on the host
  (``ops.postprocess``, the block ``pred_eval`` runs).
* ``serve_e2e`` (the JAX ``_forward_e2e``): prep, forward and the device
  post-process (the NMS kernels, once more) in one call, and one readback
  of (B, cap, 7) float32: the (B, cap, 6) detections and their validity.

Per batch, in both modes, the engine counts one ``h2d_transfers`` (the
staged pixels and their sidecars in one pinned buffer,
``Predictor.put_staged``), one ``dispatches`` (one call into the
predictor, whose launches are eager), one ``readbacks`` (one pinned copy,
``Predictor.fetch``) and its ``readback_bytes``.

First dispatches: the engine owns one :class:`ProgramRegistry` keyed by
(kind, shape), kind ``predict`` (host NMS) or ``serve_e2e``.  A batch whose
key is new counts as a ``recompiles`` and its wall time goes to the
registry's compile seconds (``compile/registry.py`` says what that holds
on the card); warmup makes every such dispatch happen before traffic.

Telemetry (whatever sink is active): ``serve/queue_wait`` spans,
``serve/h2d`` / ``serve/forward`` / ``serve/readback`` /
``serve/postprocess`` spans, ``serve/batch_fill`` / ``serve/pad_ratio``
gauges, ``serve/requests`` / ``serve/batches`` / ``serve/rejected`` /
``serve/shed`` / ``serve/deadline_exceeded`` / ``serve/recompile``
counters.  The engine mirrors the counts in :attr:`ServeEngine.counters`
and keeps its own latency :class:`Hist` instances (queue wait, service
time, request time, host prep, and request time per bucket), so that the
SLO controller and ``/metrics`` work with telemetry off.

SLO hooks (``serve/controller.py``): ``set_bucket_policy`` lowers a
bucket's flush threshold and delay (the program shape never changes),
``set_admit_limit`` sheds submits (503, ``serve/shed``) below
``max_queue``.

Layers above the batcher (``serve/stream.py``, ``serve/pool.py``):

* ``submit(..., stream=id)`` tags a stream frame; a batch that carries
  any counts in ``stream_batches`` / ``stream_batch_frames``, and one
  that mixes frames of two streams in ``stream_coalesced_batches``
  (``stream/*`` telemetry).  A :class:`~mx_rcnn_tpu_torch.serve.stream.
  StreamManager` sets :attr:`ServeEngine.stream`, and ``/metrics`` grows
  its ``stream`` section.
* ``start(external=True)`` leaves flushing to a
  :class:`~mx_rcnn_tpu_torch.serve.pool.ModelPool` dispatcher, which
  reads :meth:`due_state`, claims with :meth:`poll`, runs
  :meth:`dispatch_batch`, and is woken through ``on_work``.
* A :class:`~mx_rcnn_tpu_torch.serve.pool.CascadeRouter` sets
  :attr:`ServeEngine.cascade` on the small model's engine: every e2e
  batch folds its detections into per-image hardness on the device
  before the readback (``gate_batch``), and an escalated request enters
  the big model's engine through :meth:`submit_staged` with the small
  one's staged pixels.

Hot reload (``serve/replica.py``): :meth:`ServeEngine.quiesce` stops the
flushing and waits until no batch is on the device while admissions stay
open, so a weight swap in a single server answers no 503 (the queued
requests flush on the new weights after :meth:`ServeEngine.resume`);
:meth:`ServeEngine.drain` keeps the JAX contract (admissions refused,
queue flushed).  ``/metrics`` reports ``generation``, the last swap's
``reload`` info, the process's NMS kernel launches (``kernels``) and, on
the card, the process's ``device_memory``.

Request capture is not ported yet (ROADMAP.md A.7.7).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.compile.registry import ProgramRegistry
from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.data.image import bucket_shape, stage_raw_to_bucket
from mx_rcnn_tpu_torch.kernels import nms_cuda
from mx_rcnn_tpu_torch.logger import logger
from mx_rcnn_tpu_torch.ops.postprocess import (decode_image_boxes,
                                               detections_to_records,
                                               device_dets_to_per_class,
                                               per_class_nms)
from mx_rcnn_tpu_torch.telemetry import Hist


class RejectedError(RuntimeError):
    """Queue full, load shed, draining or engine stopped — the 503."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline expired before it was served — the 504."""


@dataclass(frozen=True)
class ServeOptions:
    """Engine knobs (the driver's ``--serve-batch`` / ``--max-delay-ms`` /
    ``--max-queue`` / ``--deadline-ms`` / ``--serve-e2e``)."""

    batch_size: int = 4
    # flush a partial batch once its oldest request has waited this long;
    # the latency/throughput knob (0 = serve singletons immediately)
    max_delay_ms: float = 10.0
    # submits beyond this many queued requests (all buckets) are rejected
    max_queue: int = 64
    # default per-request deadline (<= 0 disables); requests may override
    deadline_ms: float = 30000.0
    # staging worker processes for host-NMS mode (the driver's
    # --loader-workers); 0 stages on the caller's thread
    prep_workers: int = 0
    # single-dispatch serving: prep, forward and the device post-process
    # in one call, one (B, cap, 7) readback
    serve_e2e: bool = False

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.max_queue < self.batch_size:
            raise ValueError(
                f"max_queue ({self.max_queue}) must be >= batch_size "
                f"({self.batch_size}) or a full batch could never queue")
        if self.prep_workers < 0:
            raise ValueError(
                f"prep_workers must be >= 0, got {self.prep_workers}")


class ServeFuture:
    """Completion handle for one submitted request.  Once its batch is
    flushed, ``queue_wait_s`` holds the time it queued and ``batch_row``
    the row of the batch it filled."""

    __slots__ = ("_event", "_result", "_error", "queue_wait_s", "batch_row",
                 "hardness", "request")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self.queue_wait_s: Optional[float] = None
        self.batch_row: Optional[int] = None
        # set by the cascade gate on the small model's batches: the image's
        # hardness and its request, whose staged pixels an escalation
        # reuses; None on every other path
        self.hardness: Optional[float] = None
        self.request = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> List[dict]:
        """Block for the detections: records sorted by descending score,
        ``{"cls", "score", "bbox": [x1, y1, x2, y2]}`` in ORIGINAL image
        coordinates.  Raises the request's failure if it was rejected,
        expired, or its batch failed."""
        if not self._event.wait(timeout):
            raise TimeoutError("request not served within wait timeout")
        if self._error is not None:
            raise self._error
        return self._result

    def _set_result(self, result):
        self._result = result
        self._event.set()

    def _set_error(self, err: BaseException):
        self._error = err
        self._event.set()


class _Request:
    __slots__ = ("image", "im_info", "t_enqueue", "deadline", "bucket",
                 "future", "raw_hw", "ratio", "orig_hw", "stream")

    def __init__(self, image, im_info, t_enqueue, deadline, bucket=None,
                 raw_hw=None, ratio=None, orig_hw=None, stream=None):
        self.image = image          # the staged (Hb, Wb, 3) uint8 bucket
        self.im_info = im_info      # (3,) [eh, ew, scale]
        self.t_enqueue = t_enqueue  # monotonic
        self.deadline = deadline    # monotonic instant or None
        self.bucket = bucket        # (Hb, Wb) routing key
        self.raw_hw = raw_hw        # (2,) int32 valid raw extent
        self.ratio = ratio          # () float32 dst→src sampling ratio
        self.orig_hw = orig_hw      # (h, w) of the submitted image
        self.stream = stream        # stream id of a StreamManager frame
        self.future = ServeFuture()


class ServeEngine:
    """The dynamic batcher.  ``start()`` before submitting; ``stop()``
    fails whatever is still queued."""

    def __init__(self, predictor, cfg: Config,
                 options: Optional[ServeOptions] = None):
        self.predictor = predictor
        self.cfg = cfg
        self.opts = options or ServeOptions()
        # serving pins SCALES[0] as the TEST path does: two buckets
        self._scale = cfg.tpu.SCALES[0]
        self._stride = max(cfg.network.IMAGE_STRIDE,
                           cfg.network.RPN_FEAT_STRIDE)
        self._queues: Dict[Tuple[int, int], List[_Request]] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # external dispatch: another thread calls poll()/dispatch_batch()
        self._external = False
        # the external dispatcher's work signal, called without the lock
        # whenever new work or a policy change may have made a flush due
        self.on_work = None
        # readiness, set by warmup() once every program has dispatched
        self._ready = threading.Event()
        # drain mode: no new admissions; _inflight counts batches handed
        # to the predictor so that drain() can wait for a quiescent device
        self._draining = False
        self._inflight = 0
        # quiesce mode (a weight swap): admissions open, nothing flushes
        self._quiesced = False
        # checkpoint generation serving now (bumped by a hot reload) and
        # the info of the last swap (``serve/replica.py``)
        self.generation = 0
        self.last_reload: Optional[dict] = None
        self._dtype = getattr(predictor, "infer_dtype", "float32")
        # first-dispatch bookkeeping of this engine's (kind, shape) programs
        self.registry = ProgramRegistry(cfg, self._dtype)
        self.counters = {"requests": 0, "served": 0, "batches": 0,
                         "rejected": 0, "shed": 0, "deadline_exceeded": 0,
                         "recompiles": 0, "warmup_programs": 0,
                         # boundary crossings, per batch 1/1/1 in both modes
                         "h2d_transfers": 0, "dispatches": 0,
                         "readbacks": 0, "readback_bytes": 0,
                         # batches with >= 1 stream frame, their frames, and
                         # those mixing frames of different streams
                         "stream_batches": 0, "stream_batch_frames": 0,
                         "stream_coalesced_batches": 0}
        # latency distributions, live with telemetry off (the controller's
        # and /metrics' source); Hist locks itself, observed outside _lock
        self.hists: Dict[str, Hist] = {
            "serve/queue_wait": Hist(),
            "serve/service_time": Hist(),
            "serve/request_time": Hist(),
            "serve/host_prep": Hist(),
        }
        self._bucket_hists: Dict[str, Hist] = {}  # "HxW" -> request_time
        # SLO-controller overrides; max_batch is a flush threshold <=
        # opts.batch_size, the padded program shape never changes
        self._bucket_batch: Dict[Tuple[int, int], int] = {}
        self._bucket_delay_ms: Dict[Tuple[int, int], float] = {}
        self._admit_limit: Optional[int] = None
        self.controller = None  # set by SLOController.start()
        # a StreamManager attaches itself (``/metrics`` grows "stream");
        # the engine never calls into it
        self.stream = None
        # a CascadeRouter attaches itself to the small model's engine: each
        # e2e batch then runs its gate on the device detections
        self.cascade = None
        self._pool = None  # the prep worker pool (opts.prep_workers > 0)

    # -- lifecycle -------------------------------------------------------

    def start(self, external: bool = False) -> "ServeEngine":
        """Spawn the dispatcher thread, or with ``external=True`` leave the
        flushing to a caller of :meth:`poll` + :meth:`dispatch_batch`."""
        assert self._thread is None and not self._external, \
            "engine already started"
        if self.opts.prep_workers > 0 and self._pool is None:
            from mx_rcnn_tpu_torch.data.workers import WorkerPool

            # image-only: raw frames in, staged buckets back through the ring
            self._pool = WorkerPool(self.cfg,
                                    num_workers=self.opts.prep_workers)
        if external:
            self._external = True
            return self
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="serve-dispatch", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        with self._cond:
            self._stop = True
            pending = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
            self._cond.notify_all()
        for r in pending:
            r.future._set_error(RejectedError("engine stopped"))
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        self._external = False
        if self._pool is not None:
            self._pool.close()
            self._pool = None
        if self.on_work is not None:
            self.on_work()

    # -- readiness / drain -----------------------------------------------

    def mark_ready(self):
        """Warmup's signal: every steady-state program has dispatched;
        ``/readyz`` turns 200."""
        self._ready.set()

    def _ready_locked(self) -> bool:
        return (self._ready.is_set() and not self._draining
                and not self._stop
                and (self._thread is not None or self._external))

    def readiness(self) -> dict:
        """The ``/readyz`` payload: warmup and admission state, distinct
        from ``/healthz`` liveness."""
        with self._lock:
            return {
                "ready": self._ready_locked(),
                "warmed": self._ready.is_set(),
                "draining": self._draining,
                "generation": self.generation,
                "queue_depth": sum(len(q) for q in self._queues.values()),
                "admit_limit": self._admit_limit,
            }

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting (503) and wait until every queued request has
        flushed and no batch is on the device — the quiescent point a
        weight swap needs.  False if that did not happen within
        ``timeout`` (the caller should ``resume()``)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            while any(self._queues.values()) or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(remaining, 0.05))
        return True

    def quiesce(self, timeout: float = 30.0) -> bool:
        """Stop flushing batches and wait until none is on the device,
        admissions left open: the quiescent point of a weight swap in a
        single server, where no other replica could take a refused
        request.  Requests queue meanwhile (503 only past ``max_queue``)
        and flush after :meth:`resume`.  False if the batch on the device
        did not finish within ``timeout`` (the caller should
        ``resume()``)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._quiesced = True
            while self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(remaining, 0.05))
        return True

    def resume(self):
        """Re-open admissions after a :meth:`drain` and flushing after a
        :meth:`quiesce`."""
        with self._cond:
            self._draining = False
            self._quiesced = False
            self._cond.notify_all()
        if self.on_work is not None:
            self.on_work()

    # -- intake ----------------------------------------------------------

    def bucket_key(self, h: int, w: int) -> Tuple[int, int]:
        """The static (Hb, Wb) bucket a raw (h, w) image routes to."""
        return bucket_shape(self._scale, self._stride, landscape=(w >= h))

    def queue_depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    # -- SLO-controller policy surface -----------------------------------

    def bucket_policy(self, key: Tuple[int, int]) -> Tuple[int, float]:
        """Effective (flush_batch, max_delay_ms) of a bucket."""
        with self._lock:
            return (self._bucket_batch.get(key, self.opts.batch_size),
                    self._bucket_delay_ms.get(key, self.opts.max_delay_ms))

    def set_bucket_policy(self, key: Tuple[int, int],
                          max_batch: Optional[int] = None,
                          max_delay_ms: Optional[float] = None):
        """Override a bucket's flush threshold and delay.  ``max_batch`` is
        clamped to [1, opts.batch_size]; ``None`` leaves a knob unchanged;
        the configured value drops the override."""
        with self._cond:
            if max_batch is not None:
                b = max(1, min(int(max_batch), self.opts.batch_size))
                if b == self.opts.batch_size:
                    self._bucket_batch.pop(key, None)
                else:
                    self._bucket_batch[key] = b
            if max_delay_ms is not None:
                d = max(0.0, float(max_delay_ms))
                if d == self.opts.max_delay_ms:
                    self._bucket_delay_ms.pop(key, None)
                else:
                    self._bucket_delay_ms[key] = d
            # a shorter delay may make a parked bucket due now
            self._cond.notify()
        if self.on_work is not None:
            self.on_work()

    def set_admit_limit(self, limit: Optional[int]):
        """Shed submits (503) at this queue depth; ``None`` restores plain
        ``max_queue`` backpressure."""
        with self._lock:
            self._admit_limit = (None if limit is None
                                 else max(1, min(int(limit),
                                                 self.opts.max_queue)))

    def known_buckets(self) -> List[Tuple[int, int]]:
        """Buckets that have ever queued a request."""
        with self._lock:
            return sorted(self._queues.keys())

    def latency_hists(self) -> Dict[str, Hist]:
        """The engine's latency histograms, global and per bucket
        (``serve/request_time/HxW``)."""
        out = dict(self.hists)
        with self._lock:
            bucket = dict(self._bucket_hists)
        out.update({f"serve/request_time/{k}": h for k, h in bucket.items()})
        return out

    def policy(self) -> Dict[str, dict]:
        """Effective policy per known bucket (for ``/metrics``)."""
        with self._lock:
            return {f"{key[0]}x{key[1]}": {
                "max_batch": self._bucket_batch.get(key,
                                                    self.opts.batch_size),
                "max_delay_ms": self._bucket_delay_ms.get(
                    key, self.opts.max_delay_ms)}
                for key in sorted(self._queues.keys())}

    def submit(self, image: np.ndarray,
               deadline_ms: Optional[float] = None,
               stream: Optional[str] = None) -> ServeFuture:
        """Enqueue one raw RGB uint8 (H, W, 3) image.  Returns a
        :class:`ServeFuture`; raises :class:`RejectedError` at once when
        the queue is full, load is shed, or the engine is stopped or
        draining.  ``stream`` tags a stream frame with its stream id, for
        the flush side's coalescing counts only."""
        image = np.asarray(image)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) RGB image, "
                             f"got shape {tuple(image.shape)}")
        if image.dtype != np.uint8:
            raise ValueError(f"expected uint8 pixels, got {image.dtype}")
        tel = telemetry.get()
        t_prep = time.perf_counter()
        pool = self._pool
        if pool is not None and not self.opts.serve_e2e:
            staged, raw_hw, ratio, im_info = pool.prepare(image, self._scale)
        else:
            staged, raw_hw, ratio, im_info = stage_raw_to_bucket(
                image, self._scale, self._stride)
        prep_s = time.perf_counter() - t_prep
        self.hists["serve/host_prep"].observe(prep_s)
        tel.observe("serve/host_prep", prep_s)
        key = self.bucket_key(image.shape[0], image.shape[1])
        now = time.monotonic()
        if deadline_ms is None:
            deadline_ms = self.opts.deadline_ms
        deadline = now + deadline_ms / 1e3 if deadline_ms > 0 else None
        req = _Request(staged, im_info, now, deadline, bucket=key,
                       raw_hw=raw_hw, ratio=ratio,
                       orig_hw=(int(image.shape[0]), int(image.shape[1])),
                       stream=stream)
        return self._enqueue(req, key, tel)

    def submit_staged(self, staged: np.ndarray, raw_hw, ratio, im_info,
                      orig_hw, deadline_ms: Optional[float] = None,
                      stream: Optional[str] = None) -> ServeFuture:
        """Cascade escalation intake: enqueue an already staged uint8
        bucket (another engine's ``_Request.image``) with its sidecars,
        without staging again, so the escalated request reuses the pixels
        byte for byte and pays no host prep.  ``serve_e2e`` mode only.
        The bucket is checked against this engine's, so that a geometry
        drift between cascade models raises instead of dispatching a
        foreign shape."""
        if not self.opts.serve_e2e:
            raise RejectedError(
                "submit_staged requires serve_e2e mode (staged uint8 "
                "buffers are only a program input on the fused path)")
        key = self.bucket_key(int(orig_hw[0]), int(orig_hw[1]))
        if tuple(staged.shape[:2]) != key:
            raise ValueError(
                f"staged buffer {tuple(staged.shape[:2])} does not match "
                f"this engine's bucket {key} — cascade models must share "
                f"bucket geometry (SCALES + strides)")
        now = time.monotonic()
        if deadline_ms is None:
            deadline_ms = self.opts.deadline_ms
        deadline = now + deadline_ms / 1e3 if deadline_ms > 0 else None
        req = _Request(staged, im_info, now, deadline, bucket=key,
                       raw_hw=raw_hw, ratio=ratio,
                       orig_hw=(int(orig_hw[0]), int(orig_hw[1])),
                       stream=stream)
        return self._enqueue(req, key, telemetry.get())

    def _enqueue(self, req: _Request, key, tel) -> ServeFuture:
        """Admission: backpressure and shed checks under the lock, queue
        insert, counters, work signal."""
        with self._cond:
            if self._stop:
                self.counters["rejected"] += 1
                tel.counter("serve/rejected")
                raise RejectedError("engine stopped")
            if self._draining:
                self.counters["rejected"] += 1
                tel.counter("serve/rejected")
                raise RejectedError(
                    "draining (weight swap in progress) — retry shortly")
            depth = sum(len(q) for q in self._queues.values())
            if self._admit_limit is not None and depth >= self._admit_limit:
                self.counters["shed"] += 1
                tel.counter("serve/shed")
                raise RejectedError(
                    f"load shed: SLO controller capped admissions at "
                    f"{self._admit_limit} queued requests ({depth} "
                    f"pending) — retry with backoff")
            if depth >= self.opts.max_queue:
                self.counters["rejected"] += 1
                tel.counter("serve/rejected")
                raise RejectedError(
                    f"queue full ({depth}/{self.opts.max_queue} requests "
                    f"pending) — retry with backoff")
            self._queues.setdefault(key, []).append(req)
            self.counters["requests"] += 1
            tel.counter("serve/requests")
            tel.gauge("serve/queue_depth", depth + 1)
            self._cond.notify()
        if self.on_work is not None:
            self.on_work()
        return req.future

    # -- dispatch --------------------------------------------------------

    def _sweep_expired_locked(self, now: float) -> List[_Request]:
        expired = []
        for q in self._queues.values():
            live = []
            for r in q:
                (expired if r.deadline is not None and r.deadline <= now
                 else live).append(r)
            q[:] = live
        return expired

    def _next_batch_locked(self, now: float):
        """(requests, None) when a bucket is due, else (None, wait_s).

        Full buckets flush first; among due buckets the one whose oldest
        request is oldest wins, so no bucket's traffic starves another's.
        "Full" and "due" are judged against the controller's per-bucket
        overrides, else the configured options."""
        if self._quiesced:
            return None, None  # resume() notifies
        best_key, best_t, best_full = None, None, False
        wait = None
        for key, q in self._queues.items():
            if not q:
                continue
            b = self._bucket_batch.get(key, self.opts.batch_size)
            delay = self._bucket_delay_ms.get(
                key, self.opts.max_delay_ms) / 1e3
            head_t = q[0].t_enqueue
            full = len(q) >= b
            if not (full or (now - head_t) >= delay):
                remaining = delay - (now - head_t)
                wait = remaining if wait is None else min(wait, remaining)
                continue
            if best_key is None or (full, -head_t) > (best_full, -best_t):
                best_key, best_t, best_full = key, head_t, full
        if best_key is not None:
            q = self._queues[best_key]
            b = self._bucket_batch.get(best_key, self.opts.batch_size)
            take, q[:] = q[:b], q[b:]
            return take, None
        return None, wait

    def _fail_expired(self, expired: List[_Request]):
        for r in expired:
            self.counters["deadline_exceeded"] += 1
            telemetry.get().counter("serve/deadline_exceeded")
            r.future._set_error(DeadlineExceededError(
                "request expired before it reached a batch (engine "
                "overloaded? raise --max-queue or the deadline)"))

    def due_state(self, now: float):
        """Peek for the pool's scheduler: ``(due, depth, wait_s)``.
        ``due`` when a bucket would flush now (full, or its delay passed)
        or an expired request needs sweeping; ``wait_s`` the soonest that
        could change (None when idle).  Advisory: :meth:`poll` judges
        again under the lock."""
        with self._lock:
            depth = 0
            due = False
            wait = None
            for key, q in self._queues.items():
                depth += len(q)
                if not q or due or self._quiesced:
                    continue
                b = self._bucket_batch.get(key, self.opts.batch_size)
                delay = self._bucket_delay_ms.get(
                    key, self.opts.max_delay_ms) / 1e3
                head_t = q[0].t_enqueue
                if len(q) >= b or (now - head_t) >= delay:
                    due = True
                    continue
                remaining = delay - (now - head_t)
                wait = remaining if wait is None else min(wait, remaining)
                for r in q:
                    if r.deadline is not None:
                        if r.deadline <= now:
                            due = True
                            break
                        wait = min(wait, r.deadline - now)
        return due, depth, wait

    def poll(self, now: Optional[float] = None):
        """Claim the next due batch for an external dispatcher: sweeps
        expired requests (504) and pops one bucket's flush if due.
        Returns ``(batch, wait_s)``; a claimed batch holds an in-flight
        slot until :meth:`dispatch_batch` releases it."""
        with self._cond:
            if self._stop:
                return None, None
            if now is None:
                now = time.monotonic()
            expired = self._sweep_expired_locked(now)
            batch, wait = self._next_batch_locked(now)
            if batch is not None:
                self._inflight += 1
        self._fail_expired(expired)
        return batch, wait

    def dispatch_batch(self, batch: List[_Request]):
        """Run one claimed batch; on any error every future of the batch
        gets it (no retry, no fallback), and the in-flight slot is
        released either way."""
        try:
            self._run_batch(batch, time.monotonic())
        except BaseException as e:  # noqa: BLE001 — fail the batch
            logger.exception("serve batch failed")
            for r in batch:
                r.future._set_error(e)
        finally:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()  # drain() waits on this

    def _dispatch_loop(self):
        while True:
            with self._cond:
                if self._stop:
                    return
                now = time.monotonic()
                expired = self._sweep_expired_locked(now)
                batch, wait = self._next_batch_locked(now)
                if batch is not None:
                    self._inflight += 1
                if batch is None and not expired:
                    self._cond.wait(timeout=wait)
                    continue
            self._fail_expired(expired)
            if batch is not None:
                self.dispatch_batch(batch)

    def _run_batch(self, reqs: List[_Request], now: float):
        tel = telemetry.get()
        b = self.opts.batch_size
        pad = b - len(reqs)
        for row, r in enumerate(reqs):
            r.future.queue_wait_s = now - r.t_enqueue
            r.future.batch_row = row
            tel.add("serve/queue_wait", now - r.t_enqueue)
            self.hists["serve/queue_wait"].observe(now - r.t_enqueue)
            tel.observe("serve/queue_wait", now - r.t_enqueue)
        # pad partial batches with repeats of the last request
        rows = reqs + [reqs[-1]] * pad
        staged = np.stack([r.image for r in rows])
        raw_hw = np.stack([r.raw_hw for r in rows])
        ratio = np.asarray([r.ratio for r in rows], np.float32)
        im_info = np.stack([r.im_info for r in rows])
        tel.gauge("serve/batch_fill", len(reqs) / b)
        tel.gauge("serve/pad_ratio", pad / b)
        # inference mode is per thread: set here, on the dispatcher
        with torch.inference_mode():
            forward = (self._forward_e2e if self.opts.serve_e2e
                       else self._forward_legacy)
            results, xfer = forward(reqs, staged, raw_hw, ratio, im_info,
                                    tel)
        done = time.monotonic()
        service_s = done - now
        self.hists["serve/service_time"].observe(service_s)
        tel.observe("serve/service_time", service_s)
        new_bucket_hists = {}
        for r in reqs:
            req_s = done - r.t_enqueue
            self.hists["serve/request_time"].observe(req_s)
            tel.observe("serve/request_time", req_s)
            if r.bucket is not None:
                bk = f"{r.bucket[0]}x{r.bucket[1]}"
                h = self._bucket_hists.get(bk) or new_bucket_hists.get(bk)
                if h is None:
                    h = new_bucket_hists[bk] = Hist()
                h.observe(req_s)
                tel.observe(f"serve/request_time/{bk}", req_s)
        stream_ids = {r.stream for r in reqs if r.stream is not None}
        stream_frames = sum(1 for r in reqs if r.stream is not None)
        with self._lock:
            self._bucket_hists.update(new_bucket_hists)
            self.counters["batches"] += 1
            self.counters["served"] += len(reqs)
            if stream_frames:
                self.counters["stream_batches"] += 1
                self.counters["stream_batch_frames"] += stream_frames
                if len(stream_ids) > 1:
                    self.counters["stream_coalesced_batches"] += 1
            for k, v in xfer.items():
                self.counters[k] = self.counters.get(k, 0) + v
        tel.counter("serve/batches")
        tel.counter("serve/images", len(reqs))
        if stream_frames:
            tel.counter("stream/batches")
            tel.counter("stream/batch_frames", stream_frames)
            if len(stream_ids) > 1:
                tel.counter("stream/coalesced_batches")
        # answered only once counted: a client that has its reply finds
        # its request in /metrics
        for r, res in zip(reqs, results):
            r.future._set_result(res)

    def _note_first_dispatch(self, shape, kind: str, tel) -> bool:
        """First-seen accounting for one batch's program in the registry,
        and the recompile counters."""
        first = self.registry.note_dispatch(kind, shape)
        if first:
            self.counters["recompiles"] += 1
            tel.counter("serve/recompile")
            tel.meta("recompile", program=kind,
                     shape=[s for s in shape if not isinstance(s, str)],
                     dtype=self._dtype)
        return first

    def _call(self, kind: str, shape, args, fn, tel):
        """The batch's one host→device copy of ``args``, its one call into
        the predictor and its one readback (``fn`` maps the device args to
        the one packed tensor to read back).  The wall time of a program's
        first dispatch goes to the registry."""
        first = self._note_first_dispatch(shape, kind, tel)
        t0 = time.monotonic()
        with tel.span("serve/h2d"):
            dev_args = self.predictor.put_staged(*args)
        with tel.span("serve/forward"):
            packed = fn(dev_args)
        with tel.span("serve/readback"):
            host = self.predictor.fetch(packed)
        if first:
            self.registry.record_compile_seconds(kind, shape,
                                                 time.monotonic() - t0)
        return host

    def _forward_legacy(self, reqs: List[_Request], staged, raw_hw, ratio,
                        im_info, tel) -> tuple:
        """Host-NMS mode: prep and forward in one call
        (``Predictor.predict_staged``), one readback of (B, R, 5 + 5K)
        float32 [rois, valid, scores, deltas], decode and per-class NMS on
        the host.  Returns each request's records and the batch's counter
        increments: 1 h2d copy, 1 dispatch, 1 readback and its bytes."""
        def run(args):
            rois, roi_valid, cls_prob, deltas = \
                self.predictor.predict_staged(*args)[:4]
            return torch.cat([rois.float(), roi_valid[..., None].float(),
                              cls_prob.float(), deltas.float()], dim=-1)

        host = self._call("predict", tuple(staged.shape),
                          (staged, raw_hw, ratio, im_info), run, tel)
        k = self.cfg.NUM_CLASSES
        rois, roi_valid = host[..., :4], host[..., 4] > 0.5
        cls_prob, deltas = host[..., 5:5 + k], host[..., 5 + k:]
        cfg = self.cfg
        results = []
        with tel.span("serve/postprocess"):
            for i, r in enumerate(reqs):
                boxes = decode_image_boxes(rois[i], deltas[i], r.im_info)
                dets_pc = per_class_nms(cls_prob[i], boxes, roi_valid[i],
                                        cfg.NUM_CLASSES, cfg.TEST.THRESH,
                                        cfg.TEST.NMS, cfg.TEST.MAX_PER_IMAGE)
                results.append(detections_to_records(dets_pc))
        return results, {"h2d_transfers": 1, "dispatches": 1,
                         "readbacks": 1, "readback_bytes": int(host.nbytes)}

    def _forward_e2e(self, reqs: List[_Request], staged, raw_hw, ratio,
                     im_info, tel) -> tuple:
        """Single-dispatch mode (``--serve-e2e``): prep, forward and the
        device post-process in one call (``Predictor.predict_serve_e2e``),
        one readback of (B, cap, 7) float32 [x1, y1, x2, y2, score, cls,
        valid].  Responses come from ``device_dets_to_per_class``, the
        ``--device-postprocess`` contract: exactly ``MAX_PER_IMAGE`` rows,
        so exact score ties at the cap may resolve differently from the
        host-NMS mode.  With a cascade attached, its gate folds the
        detections into per-image hardness on the device before the
        readback (a (B,) float32 read of its own, no h2d copy).  Returns
        as the host-NMS mode does."""
        cfg = self.cfg
        mpi = int(cfg.TEST.MAX_PER_IMAGE)
        th = float(cfg.TEST.THRESH)
        # the call's statics extend the key as string tokens
        shape = tuple(staged.shape) + (f"mpi={mpi}", f"th={th:g}")

        def run(args):
            # serve traffic never flips
            dets, dvalid = self.predictor.predict_serve_e2e(*args, None,
                                                            mpi, th)
            if self.cascade is not None:
                self.cascade.gate_batch(dets, dvalid, reqs)
            return torch.cat([dets, dvalid[..., None].float()], dim=-1)

        host = self._call("serve_e2e", shape,
                          (staged, raw_hw, ratio, im_info), run, tel)
        results = []
        with tel.span("serve/postprocess"):
            for i in range(len(reqs)):
                dets_pc = device_dets_to_per_class(host[i, :, :6],
                                                   host[i, :, 6] > 0.5,
                                                   cfg.NUM_CLASSES)
                results.append(detections_to_records(dets_pc))
        return results, {"h2d_transfers": 1, "dispatches": 1,
                         "readbacks": 1, "readback_bytes": int(host.nbytes)}

    # -- introspection ---------------------------------------------------

    def metrics(self) -> dict:
        """The ``/metrics`` payload: counters, live queue state, latency
        quantiles, effective per-bucket policy, the compile snapshot and
        (with a controller attached) its state.  ``_lock`` is not
        reentrant, so everything that takes its own lock runs after it is
        released."""
        with self._lock:
            out = {
                "counters": dict(self.counters),
                "queue_depth": sum(len(q) for q in self._queues.values()),
                "buckets": {f"{h}x{w}": len(q)
                            for (h, w), q in self._queues.items()},
                "options": {"batch_size": self.opts.batch_size,
                            "max_delay_ms": self.opts.max_delay_ms,
                            "max_queue": self.opts.max_queue,
                            "deadline_ms": self.opts.deadline_ms,
                            "serve_e2e": self.opts.serve_e2e},
                "admit_limit": self._admit_limit,
                "generation": self.generation,
                "reload": self.last_reload,
                "ready": self._ready_locked(),
                "draining": self._draining,
            }
        # the process's NMS launches: a replica's /metrics is how the plane
        # reads them
        out["kernels"] = {"nms_mask": nms_cuda.nms_mask.launches,
                          "nms_sweep": nms_cuda.nms_sweep.launches}
        dev = getattr(self.predictor, "device", None)
        if dev is not None and dev.type == "cuda":
            out["device_memory"] = {
                "allocated": torch.cuda.memory_allocated(dev),
                "reserved": torch.cuda.memory_reserved(dev),
                "peak": torch.cuda.max_memory_allocated(dev)}
        latency = {}
        for name, h in self.hists.items():
            short = name.split("/", 1)[1]
            for q, tag in ((0.5, "p50_ms"), (0.99, "p99_ms")):
                v = h.quantile(q)
                if v is not None:
                    latency[f"{short}_{tag}"] = round(v * 1e3, 3)
        out["latency"] = latency
        out["policy"] = self.policy()
        out["dtype"] = self._dtype
        out["compile"] = self.registry.snapshot()
        if self.stream is not None:
            out["stream"] = self.stream.metrics()
        ctrl = self.controller
        if ctrl is not None:
            out["controller"] = ctrl.state()
        return out
