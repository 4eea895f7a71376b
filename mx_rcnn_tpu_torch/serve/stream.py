"""Streaming serving: per-stream temporal state over the shared batcher
(counterpart of ``mx_rcnn_tpu/serve/stream.py``: ``StaleSeqError``,
``StreamOptions``, ``FrameResult``, ``_StreamState``, ``StreamManager``).

A camera at 30 frames/s pays the full forward 30 times a second even when
nothing in the scene moved.  This layer adds two things:

* **Cross-stream coalescing.**  Frames of different streams go into the
  one :class:`~mx_rcnn_tpu_torch.serve.engine.ServeEngine` batcher
  (``submit(..., stream=...)``), so same-bucket frames of many cameras
  share one dispatch; the engine counts how often
  (``stream_coalesced_batches``, batch occupancy on ``/metrics``).
* **The frame-delta skip.**  A gate on the card (:func:`frame_delta`,
  kind ``frame_delta`` in the engine's program registry, first-dispatched
  per bucket by :meth:`StreamManager.warmup`) takes the mean absolute
  pixel delta between the incoming staged uint8 frame and the stream's
  reference frame (the last frame that took the full path): one float32
  scalar and a 4-byte readback.  Below ``skip_thresh`` the stream's cached
  detections answer at once: no batch, no forward, no engine counter
  moves and no ``serve/service_time`` observation (the SLO controller
  never sees a skip).  Above it, on a bucket change, a generation change
  (weight hot reload), or after ``max_skip`` consecutive skips, the frame
  takes the normal path and becomes the new reference.

On the card the gate runs on a CUDA stream of its own, so its readback
waits for the gate's copy and reduction only, not for a forward that the
dispatcher thread has queued on the default stream.

A skipped frame returns the reference frame's detections verbatim.
``skip_thresh`` is in mean absolute uint8 units over the whole staged
bucket (padding included: a size change reads as motion); 0 turns the
gate off, and a gate-off stream is byte for byte the ``/predict`` path.

Ordering: a stream's frames are serialised by a per-stream lock and a
strictly increasing ``seq`` (a stale or repeated one raises
:class:`StaleSeqError`, the frontend's 409), so each stream's replies
keep its order however frames of other streams interleave in the
batcher.  Request tracing is not ported yet (ROADMAP.md A.7.9): frames
carry no trace context.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.data.image import stage_raw_to_bucket
from mx_rcnn_tpu_torch.logger import logger
from mx_rcnn_tpu_torch.serve.engine import RejectedError, ServeEngine
from mx_rcnn_tpu_torch.telemetry import Hist

KIND = "frame_delta"


class StaleSeqError(ValueError):
    """Frame ``seq`` not strictly greater than the stream's last: the
    frontend's 409 (a reconnecting client resumes past its high-water
    mark, it does not replay)."""


def frame_delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The gate: mean |a − b| over two staged uint8 buckets of one shape,
    as a float32 scalar on their device."""
    return torch.mean(torch.abs(a.to(torch.float32) - b.to(torch.float32)))


@dataclass(frozen=True)
class StreamOptions:
    """Stream knobs (the driver's ``--stream-skip-thresh`` /
    ``--stream-max-skip``)."""

    # mean absolute uint8 pixel delta below which a frame skips the
    # forward and answers with the reference frame's detections; <= 0
    # turns the gate off (coalescing only, byte-identical results)
    skip_thresh: float = 0.0
    # after this many consecutive skips the next frame takes the full
    # path whatever its delta: how stale a static scene's answer may get
    max_skip: int = 30
    # a frame of a new stream beyond this many is rejected (503) once no
    # idle stream can be evicted
    max_streams: int = 256
    # streams idle this long are evictable when the table is full
    idle_ttl_s: float = 300.0

    def __post_init__(self):
        if self.max_skip < 1:
            raise ValueError(f"max_skip must be >= 1, got {self.max_skip}")
        if self.max_streams < 1:
            raise ValueError(
                f"max_streams must be >= 1, got {self.max_streams}")


class FrameResult:
    """Completion handle for one stream frame.  A ``skipped`` frame shares
    the reference frame's future (usually resolved already); a forwarded
    frame carries its own."""

    __slots__ = ("stream_id", "seq", "skipped", "delta", "_future")

    def __init__(self, stream_id, seq, skipped, delta, future):
        self.stream_id = stream_id
        self.seq = seq
        self.skipped = skipped
        # the gate's measurement; None when the gate is off or had no
        # reference to compare with (first frame, bucket change, refresh)
        self.delta = delta
        self._future = future

    def result(self, timeout: Optional[float] = None):
        """Detection records: the reference frame's when skipped."""
        return self._future.result(timeout)

    @property
    def queue_wait_s(self) -> Optional[float]:
        return None if self.skipped else self._future.queue_wait_s

    def cascade(self) -> Optional[dict]:
        """Cascade provenance of the frame that produced these records
        (the reference frame's when skipped), or None when the stream is
        not cascade-routed.  Call after :meth:`result`."""
        prov = getattr(self._future, "provenance", None)
        return prov() if prov is not None else None


class _StreamState:
    __slots__ = ("stream_id", "last_seq", "bucket", "ref_dev", "ref_future",
                 "generation", "skip_run", "last_used", "lock")

    def __init__(self, stream_id: str):
        self.stream_id = stream_id
        self.last_seq = 0
        self.bucket = None      # (Hb, Wb) of the reference frame
        self.ref_dev = None     # the reference's staged uint8, on the device
        self.ref_future = None  # the reference frame's future
        self.generation = -1    # engine generation the reference was served at
        self.skip_run = 0       # consecutive skips since the last forward
        self.last_used = time.monotonic()
        self.lock = threading.Lock()  # serialises one stream's frames


class StreamManager:
    """Per-stream state over a started :class:`ServeEngine`.

    Construction attaches it (``engine.stream``): ``/metrics`` grows the
    ``stream`` section.  The gate's first dispatches count in the engine's
    :class:`~mx_rcnn_tpu_torch.compile.registry.ProgramRegistry` under
    kind ``frame_delta``, never in the engine's ``recompiles``.  The gate
    runs on the predictor's device (the CPU for a predictor without one).
    ``cascade`` (a :class:`~mx_rcnn_tpu_torch.serve.pool.CascadeRouter`
    whose small model is this engine's) routes forwarded frames through
    the router, so a hard frame escalates as a ``/predict`` does."""

    def __init__(self, engine: ServeEngine,
                 options: Optional[StreamOptions] = None, cascade=None):
        self.engine = engine
        self.cascade = cascade
        self.opts = options or StreamOptions()
        self._streams: Dict[str, _StreamState] = {}
        self._lock = threading.Lock()  # guards _streams and the counters
        self.counters = {"frames": 0, "forwarded": 0, "skipped": 0,
                         "delta_dispatches": 0, "refreshes": 0,
                         "bucket_switches": 0, "stale_seq": 0, "evicted": 0}
        # skips have a hist of their own: serve/service_time and
        # serve/request_time measure real forwards only
        self.hists: Dict[str, Hist] = {"stream/skip_time": Hist()}
        self._registry = engine.registry
        self._stride = max(engine.cfg.network.IMAGE_STRIDE,
                           engine.cfg.network.RPN_FEAT_STRIDE)
        self.device = torch.device(getattr(engine.predictor, "device",
                                           "cpu"))
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        engine.stream = self

    @property
    def gate_enabled(self) -> bool:
        return self.opts.skip_thresh > 0

    # -- the gate on the device -------------------------------------------

    def _on_side(self):
        return (torch.cuda.stream(self._side) if self._side is not None
                else contextlib.nullcontext())

    def _put(self, staged: np.ndarray) -> torch.Tensor:
        """A staged frame on the gate's device (pinned, non-blocking, on
        the gate's stream)."""
        t = torch.from_numpy(np.ascontiguousarray(staged, np.uint8))
        if self._side is None:
            return t.to(self.device)
        with self._on_side():
            return t.pin_memory().to(self.device, non_blocking=True)

    def _dispatch_delta(self, a_dev, b_dev, shape) -> float:
        """One gate dispatch and its 4-byte readback, with the registry's
        first-dispatch accounting (wall time of the first into its compile
        seconds)."""
        reg = self._registry
        first = reg.note_dispatch(KIND, shape)
        t0 = time.perf_counter()
        with torch.inference_mode(), self._on_side():
            delta = float(frame_delta(a_dev, b_dev))
        if first:
            reg.record_compile_seconds(KIND, shape, time.perf_counter() - t0)
        with self._lock:
            self.counters["delta_dispatches"] += 1
        telemetry.get().counter("stream/delta_dispatches")
        return delta

    def warmup(self) -> int:
        """First-dispatch one ``frame_delta`` program per orientation bucket
        (gate on only), so that steady-state streaming adds none.  Returns
        the number of programs first-dispatched."""
        if not self.gate_enabled:
            return 0
        reg = self._registry
        before = reg.counters["programs"]
        short, long_ = self.engine._scale
        t0 = time.perf_counter()
        for h, w in ((short, long_), (long_, short)):
            staged, _, _, _ = stage_raw_to_bucket(
                np.zeros((h, w, 3), np.uint8), self.engine._scale,
                self._stride)
            dev = self._put(staged)
            self._dispatch_delta(dev, dev, tuple(staged.shape))
        compiled = reg.counters["programs"] - before
        logger.info("stream warmup: %d frame_delta program(s) ready in "
                    "%.1fs (skip_thresh=%g, max_skip=%d)", compiled,
                    time.perf_counter() - t0, self.opts.skip_thresh,
                    self.opts.max_skip)
        return compiled

    # -- intake ----------------------------------------------------------

    def _state(self, stream_id: str) -> _StreamState:
        now = time.monotonic()
        with self._lock:
            st = self._streams.get(stream_id)
            if st is None:
                if len(self._streams) >= self.opts.max_streams:
                    for sid, s in list(self._streams.items()):
                        if now - s.last_used > self.opts.idle_ttl_s:
                            del self._streams[sid]
                            self.counters["evicted"] += 1
                if len(self._streams) >= self.opts.max_streams:
                    raise RejectedError(
                        f"stream table full ({len(self._streams)}/"
                        f"{self.opts.max_streams} active) — retire idle "
                        f"streams or raise --max-streams")
                st = self._streams[stream_id] = _StreamState(stream_id)
            st.last_used = now
            return st

    def submit_frame(self, stream_id: str, seq: int, image: np.ndarray,
                     deadline_ms: Optional[float] = None) -> FrameResult:
        """One sequenced frame → :class:`FrameResult`.  Raises
        :class:`StaleSeqError` on a seq that does not increase; the
        engine's :class:`RejectedError` and deadlines pass through as for
        any request."""
        tel = telemetry.get()
        state = self._state(stream_id)
        with state.lock:
            if seq <= state.last_seq:
                with self._lock:
                    self.counters["stale_seq"] += 1
                tel.counter("stream/stale_seq")
                raise StaleSeqError(
                    f"stream {stream_id!r}: seq {seq} <= last accepted "
                    f"{state.last_seq} (frames must arrive with strictly "
                    f"increasing seq)")
            state.last_seq = seq
            with self._lock:
                self.counters["frames"] += 1
            tel.counter("stream/frames")
            return self._gate_and_submit(state, seq, image, deadline_ms, tel)

    def _gate_and_submit(self, state: _StreamState, seq: int, image,
                         deadline_ms, tel) -> FrameResult:
        t0 = time.perf_counter()
        key = cur_dev = staged = None
        delta = None
        if self.gate_enabled:
            raw8 = np.asarray(image)
            if raw8.dtype != np.uint8:
                raw8 = np.clip(raw8, 0, 255).astype(np.uint8)
            staged, _, _, _ = stage_raw_to_bucket(
                raw8, self.engine._scale, self._stride)
            key = self.engine.bucket_key(image.shape[0], image.shape[1])
            if state.bucket is not None and state.bucket != key:
                with self._lock:
                    self.counters["bucket_switches"] += 1
                tel.counter("stream/bucket_switches")
            ref_ok = (state.ref_dev is not None and state.bucket == key
                      and state.ref_future is not None
                      and state.ref_future._error is None
                      and state.generation == self.engine.generation)
            if ref_ok and state.skip_run >= self.opts.max_skip:
                # forced refresh: cached detections must not outlive the
                # skip budget, however static the scene
                ref_ok = False
                with self._lock:
                    self.counters["refreshes"] += 1
                tel.counter("stream/refreshes")
            if ref_ok:
                cur_dev = self._put(staged)
                delta = self._dispatch_delta(cur_dev, state.ref_dev,
                                             tuple(staged.shape))
                if delta < self.opts.skip_thresh:
                    # the skip: cached detections, no engine work at all
                    state.skip_run += 1
                    with self._lock:
                        self.counters["skipped"] += 1
                    tel.counter("stream/skipped")
                    dt = time.perf_counter() - t0
                    self.hists["stream/skip_time"].observe(dt)
                    tel.observe("stream/skip_time", dt)
                    return FrameResult(state.stream_id, seq, True, delta,
                                       state.ref_future)
        # the full path: an ordinary request tagged with its stream; with a
        # cascade attached it rides the router, so hard frames escalate
        if self.cascade is not None:
            fut = self.cascade.submit(image, deadline_ms=deadline_ms,
                                      stream=state.stream_id,
                                      model_id=self.cascade.small)
        else:
            fut = self.engine.submit(image, deadline_ms=deadline_ms,
                                     stream=state.stream_id)
        state.ref_future = fut
        state.generation = self.engine.generation
        state.skip_run = 0
        if self.gate_enabled:
            state.bucket = key
            # the staged pixels become the reference on the device (the
            # gate's copy when the delta ran)
            state.ref_dev = (cur_dev if cur_dev is not None
                             else self._put(staged))
        with self._lock:
            self.counters["forwarded"] += 1
        tel.counter("stream/forwarded")
        return FrameResult(state.stream_id, seq, False, delta, fut)

    # -- introspection ---------------------------------------------------

    def active_streams(self) -> int:
        with self._lock:
            return len(self._streams)

    def metrics(self) -> dict:
        """The ``/metrics`` ``stream`` section: the manager's counters with
        the engine's flush-side stream counts folded in, the live stream
        table's size, batch occupancy (stream frames per slot of a
        stream-carrying batch) and the skip fraction."""
        with self._lock:
            c = dict(self.counters)
            active = len(self._streams)
        ec = self.engine.counters
        c["batches"] = ec.get("stream_batches", 0)
        c["batch_frames"] = ec.get("stream_batch_frames", 0)
        c["coalesced_batches"] = ec.get("stream_coalesced_batches", 0)
        occupancy = (c["batch_frames"]
                     / max(c["batches"] * self.engine.opts.batch_size, 1))
        out = {
            "active_streams": active,
            "counters": c,
            "batch_occupancy": round(occupancy, 4),
            "skip_fraction": round(c["skipped"] / max(c["frames"], 1), 4),
            "options": {"skip_thresh": self.opts.skip_thresh,
                        "max_skip": self.opts.max_skip,
                        "max_streams": self.opts.max_streams},
        }
        latency = {}
        h = self.hists["stream/skip_time"]
        for q, tag in ((0.5, "skip_time_p50_ms"), (0.99, "skip_time_p99_ms")):
            v = h.quantile(q)
            if v is not None:
                latency[tag] = round(v * 1e3, 3)
        if latency:
            out["latency"] = latency
        return out
