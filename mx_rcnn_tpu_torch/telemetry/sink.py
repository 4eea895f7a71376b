"""The telemetry sink (counterpart of ``mx_rcnn_tpu/telemetry/sink.py``):
monotonic-clock spans, counters, gauges and log-spaced histograms, a
JSONL event stream and an aggregated summary.

* ``Telemetry`` — the live sink.  ``span(name)`` times a block on
  ``time.perf_counter``; ``counter``/``gauge``/``observe`` record
  occurrences, sampled values and distribution observations.  Every
  record is appended to ``events_rank{N}.jsonl`` (one JSON object per
  line, schema below) and folded into in-memory aggregates that
  ``summary()``/``write_summary()`` expose without re-reading the file.
* ``NullTelemetry`` — the disabled sink: every method is a no-op and
  ``span`` returns one cached context manager, so an instrumented hot
  path pays one attribute check and no allocation.
* ``Hist`` — the streaming histogram behind ``observe``, usable on its
  own: the serve engine keeps its own so that the SLO controller and
  ``/metrics`` read quantiles with telemetry off.

Thread-safety: the writer and the aggregate dicts share one lock.  Events
are buffered by the file object and flushed on ``close``/``write_summary``.

JSONL event schema (``v`` = schema version, one object per line), the
JAX package's, so its report tools read the port's streams::

    {"v": 1, "t": <unix wall seconds>, "rank": <process index>,
     "kind": "span" | "counter" | "gauge" | "hist" | "meta",
     "name": "<slashed metric name>", ...kind-specific fields}

  span    → "dur_s" (optionally "n": batched count, "ts": wall start)
  counter → "inc"
  gauge   → "value"
  hist    → "value" (seconds, one observation)
  meta    → "fields" dict

Every event also lands in a bounded in-memory ring; ``dump_flight(reason)``
writes the ring atomically to ``flight_{rank}.jsonl`` (the flight
recorder), taking the lock with a timeout so that it can run from a
signal handler.  With ``trace=True`` (or ``MXR_TELEMETRY_TRACE=1``) span
records carry ``"ts"``, the wall-clock start.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import threading
import time
from typing import List, Optional

SCHEMA_VERSION = 1
SUMMARY_NAME = "summary.json"
# flight-recorder ring bound: ~4k events ≈ the last few hundred steps of
# a fully-instrumented train loop, < 1 MB of dicts
RING_SIZE = 4096

# Histogram bucket upper bounds, in SECONDS: log-spaced at factor √2 from
# 0.1 ms to ~105 s (41 boundaries + implicit +Inf overflow), the JAX
# package's exactly, so that histograms of either package merge by adding
# bucket counts.  √2 keeps the interpolated quantile within ~20% of the
# estimate anywhere on the latency axis, fine for SLO control.
HIST_MIN_S = 1e-4
HIST_FACTOR = 2.0 ** 0.5
HIST_LE = tuple(round(HIST_MIN_S * HIST_FACTOR ** i, 10) for i in range(41))


def quantile_from_counts(le, buckets, count, q: float) -> Optional[float]:
    """Quantile estimate from (boundaries, per-bucket counts, total).
    Linear interpolation inside the bucket holding the q-th observation
    (lower edge 0 for the first bucket; the +Inf overflow bucket clamps to
    the last finite boundary).  None when the histogram is empty."""
    if count <= 0:
        return None
    target = max(min(q, 1.0), 0.0) * count
    cum = 0
    for i, c in enumerate(buckets):
        if c == 0:
            continue
        prev, cum = cum, cum + c
        if cum >= target:
            if i >= len(le):  # overflow bucket: no upper edge to lerp to
                return float(le[-1])
            lo = float(le[i - 1]) if i > 0 else 0.0
            hi = float(le[i])
            frac = min(max((target - prev) / c, 0.0), 1.0)
            return lo + (hi - lo) * frac
    return float(le[-1])


class Hist:
    """Streaming log-spaced histogram (fixed :data:`HIST_LE` boundaries).

    The distribution primitive behind ``Telemetry.observe``, usable
    standalone (``ServeEngine`` keeps its own).  Thread-safe; ``merge``
    adds another histogram's buckets in (associative and commutative).

    A bounded ring of periodic snapshots (one per ≥``SNAP_INTERVAL_S`` of
    observation traffic) backs ``window_quantile``: the windowed estimate
    is the quantile of (current − snapshot at the window edge), i.e. of
    roughly the last ``window_s`` seconds of observations — what an
    admission controller wants ("p99 *right now*"), where the lifetime
    quantile would be polluted by a cold start or an old burst.
    """

    SNAP_INTERVAL_S = 0.5
    SNAP_KEEP = 256  # × interval ⇒ ~2 min of window reach

    __slots__ = ("count", "sum", "buckets", "_lock", "_snaps",
                 "_last_snap_t")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.buckets: List[int] = [0] * (len(HIST_LE) + 1)
        self._lock = threading.Lock()
        self._snaps: collections.deque = collections.deque(
            maxlen=self.SNAP_KEEP)
        self._last_snap_t: Optional[float] = None

    def observe(self, value: float, now: Optional[float] = None):
        value = float(value)
        i = bisect.bisect_left(HIST_LE, value)
        with self._lock:
            now = time.monotonic() if now is None else now
            if (self._last_snap_t is None
                    or now - self._last_snap_t >= self.SNAP_INTERVAL_S):
                # state as of now⁻ (before this observation) — the window
                # delta then covers everything from this instant on
                self._snaps.append((now, self.count, tuple(self.buckets)))
                self._last_snap_t = now
            self.count += 1
            self.sum += value
            self.buckets[i] += 1

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            return quantile_from_counts(HIST_LE, self.buckets, self.count, q)

    def window_quantile(self, q: float, window_s: float,
                        now: Optional[float] = None) -> Optional[float]:
        """Quantile over roughly the trailing ``window_s`` seconds (the
        whole history when the run is younger than the window)."""
        with self._lock:
            now = time.monotonic() if now is None else now
            cutoff = now - window_s
            base = None
            for t, c, b in reversed(self._snaps):
                if t <= cutoff:
                    base = (c, b)
                    break
            if base is None:
                counts, n = self.buckets, self.count
            else:
                counts = [x - y for x, y in zip(self.buckets, base[1])]
                n = self.count - base[0]
            return quantile_from_counts(HIST_LE, counts, n, q)

    def merge(self, other) -> "Hist":
        """Fold another :class:`Hist` (or its ``to_dict``) into this one."""
        if isinstance(other, Hist):
            other = other.to_dict()
        if list(other.get("le", HIST_LE)) != list(HIST_LE):
            raise ValueError("histogram bucket boundaries disagree — "
                             "streams from different HIST_LE versions "
                             "cannot be merged")
        with self._lock:
            self.count += int(other["count"])
            self.sum += float(other["sum"])
            for i, c in enumerate(other["buckets"]):
                self.buckets[i] += int(c)
        return self

    def to_dict(self) -> dict:
        with self._lock:
            return {"count": self.count, "sum": self.sum,
                    "le": list(HIST_LE), "buckets": list(self.buckets)}

    @classmethod
    def from_dict(cls, d: dict) -> "Hist":
        return cls().merge(d)


class _NullSpan:
    """Zero-allocation context manager for the disabled sink."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTelemetry:
    """Disabled sink: one attribute check (``enabled``) on hot paths, no
    allocations (``span`` hands back one cached context manager)."""

    enabled = False
    rank = 0
    trace = False

    def span(self, name):
        return _NULL_SPAN

    def add(self, name, seconds, n=1, ts=None):
        pass

    def counter(self, name, inc=1):
        pass

    def gauge(self, name, value):
        pass

    def meta(self, name, **fields):
        pass

    def observe(self, name, value):
        pass

    def hist_quantile(self, name, q, window_s=None):
        return None

    def live_hists(self) -> dict:
        return {}

    def dump_flight(self, reason, **fields):
        return None

    def summary(self) -> dict:
        return {}

    def write_summary(self, extra: Optional[dict] = None) -> Optional[str]:
        return None

    def close(self):
        pass


NULL = NullTelemetry()


class _Span:
    """Context manager recording a perf_counter duration into its sink.
    Durations always come from the monotonic clock; when the sink is in
    trace mode the wall-clock START is captured too so the trace export
    can place the span exactly (rather than deriving start = end - dur
    from the emit-time ``t``)."""

    __slots__ = ("_tel", "_name", "_t0", "_w0")

    def __init__(self, tel: "Telemetry", name: str):
        self._tel = tel
        self._name = name

    def __enter__(self):
        self._w0 = time.time() if self._tel.trace else None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tel.add(self._name, time.perf_counter() - self._t0,
                      ts=self._w0)
        return False


class Telemetry:
    """Live sink writing ``events_rank{rank}.jsonl`` under ``out_dir``.

    ``rank``/``world`` mirror the multi-host contract of ``profile_dir``:
    every rank streams its own file (no cross-process writer collisions on
    a shared filesystem) and only process 0 calls ``write_summary``.
    """

    enabled = True

    def __init__(self, out_dir: str, rank: int = 0, world: int = 1,
                 run_meta: Optional[dict] = None, stream: bool = True,
                 trace: Optional[bool] = None, ring_size: int = RING_SIZE):
        self.out_dir = out_dir
        self.rank = int(rank)
        self.world = int(world)
        if trace is None:  # env opt-in so drivers need no new flag
            env = os.environ.get("MXR_TELEMETRY_TRACE", "")
            trace = env.strip().lower() in ("1", "true", "yes", "on")
        self.trace = bool(trace)
        self._lock = threading.Lock()
        self._spans: dict = {}     # name -> [count, total, min, max]
        self._counters: dict = {}  # name -> int
        self._gauges: dict = {}    # name -> [count, total, min, max, last]
        self._hists: dict = {}     # name -> Hist
        self._ring: collections.deque = collections.deque(
            maxlen=max(int(ring_size), 1))
        self._run_meta = dict(run_meta or {})
        self._file = None
        if stream:
            os.makedirs(out_dir, exist_ok=True)
            self.events_path = os.path.join(out_dir,
                                            f"events_rank{self.rank}.jsonl")
            self._file = open(self.events_path, "w")
        if self._run_meta or stream:
            self.meta("run", world=self.world, **self._run_meta)

    # -- recording -------------------------------------------------------

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def _emit(self, rec: dict):
        self._ring.append(rec)  # flight recorder: bounded, crash-readable
        if self._file is not None:
            self._file.write(json.dumps(rec) + "\n")

    def add(self, name: str, seconds: float, n: int = 1,
            ts: Optional[float] = None):
        """Record a measured duration (the non-context-manager span form —
        callers that already hold a perf_counter difference, e.g. the
        trainer's loader-wait accumulation, feed it here).  ``n`` lets one
        record stand for n back-to-back occurrences (group dispatches).
        ``ts`` is an optional wall-clock span START (trace mode)."""
        with self._lock:
            s = self._spans.get(name)
            if s is None:
                self._spans[name] = [n, seconds, seconds, seconds]
            else:
                s[0] += n
                s[1] += seconds
                s[2] = min(s[2], seconds)
                s[3] = max(s[3], seconds)
            rec = {"v": SCHEMA_VERSION, "t": time.time(), "rank": self.rank,
                   "kind": "span", "name": name, "dur_s": seconds}
            if n != 1:
                rec["n"] = n
            if ts is not None:
                rec["ts"] = ts
            self._emit(rec)

    def counter(self, name: str, inc: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + inc
            self._emit({"v": SCHEMA_VERSION, "t": time.time(),
                        "rank": self.rank, "kind": "counter", "name": name,
                        "inc": inc})

    def gauge(self, name: str, value: float):
        value = float(value)
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                self._gauges[name] = [1, value, value, value, value]
            else:
                g[0] += 1
                g[1] += value
                g[2] = min(g[2], value)
                g[3] = max(g[3], value)
                g[4] = value
            self._emit({"v": SCHEMA_VERSION, "t": time.time(),
                        "rank": self.rank, "kind": "gauge", "name": name,
                        "value": value})

    def observe(self, name: str, value: float):
        """One observation into the named log-spaced histogram (seconds).
        The distribution complement to ``gauge``: answers "what is p99?"
        where gauges only keep last/min/max/mean."""
        value = float(value)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Hist()
            h.observe(value)
            self._emit({"v": SCHEMA_VERSION, "t": time.time(),
                        "rank": self.rank, "kind": "hist", "name": name,
                        "value": value})

    def hist_quantile(self, name: str, q: float,
                      window_s: Optional[float] = None) -> Optional[float]:
        """Quantile of a named histogram — over the trailing ``window_s``
        seconds when given, else the whole run.  None when unknown/empty."""
        with self._lock:
            h = self._hists.get(name)
        if h is None:
            return None
        if window_s is not None:
            return h.window_quantile(q, window_s)
        return h.quantile(q)

    def live_hists(self) -> dict:
        """Name → live :class:`Hist` (the objects, not copies — Hist is
        internally locked)."""
        with self._lock:
            return dict(self._hists)

    def meta(self, name: str, **fields):
        with self._lock:
            self._emit({"v": SCHEMA_VERSION, "t": time.time(),
                        "rank": self.rank, "kind": "meta", "name": name,
                        "fields": fields})

    def dump_flight(self, reason: str, **fields) -> Optional[str]:
        """Flight-recorder dump: append a ``flight_trigger`` meta event
        explaining WHY, then atomically write the event ring to
        ``flight_{rank}.jsonl`` under ``out_dir``.

        Callable from signal handlers and failure paths: the lock acquire
        is bounded, and when it times out (the handler interrupted a
        thread that holds the sink lock) the stream write is skipped but
        the ring still gets the trigger and the dump proceeds — a flight
        dump that deadlocks the dying process would be worse than a
        slightly torn one.  Returns the dump path (None without a dir).
        """
        rec = {"v": SCHEMA_VERSION, "t": time.time(), "rank": self.rank,
               "kind": "meta", "name": "flight_trigger",
               "fields": {"reason": reason, **fields}}
        got = self._lock.acquire(timeout=1.0)
        try:
            self._ring.append(rec)
            if got and self._file is not None:
                self._file.write(json.dumps(rec) + "\n")
                self._file.flush()
            events = None
            for _ in range(3):  # lockless list(deque) may race an append
                try:
                    events = list(self._ring)
                    break
                except RuntimeError:
                    continue
            if events is None:
                events = [rec]
        finally:
            if got:
                self._lock.release()
        if not self.out_dir:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"flight_{self.rank}.jsonl")
        # tmp must be unique per CALL, not just per process: two threads
        # dumping concurrently would otherwise share one tmp and the
        # second os.replace finds it already consumed
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "w") as f:
                for ev in events:
                    f.write(json.dumps(ev) + "\n")
            os.replace(tmp, path)
        except OSError:  # out_dir torn down mid-shutdown; ring has it
            return None
        return path

    # -- reading ---------------------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            return {
                "schema": SCHEMA_VERSION,
                "rank": self.rank,
                "world": self.world,
                "meta": dict(self._run_meta),
                "spans": {
                    k: {"count": c, "total_s": t, "mean_s": t / max(c, 1),
                        "min_s": lo, "max_s": hi}
                    for k, (c, t, lo, hi) in sorted(self._spans.items())},
                "counters": dict(sorted(self._counters.items())),
                "gauges": {
                    k: {"count": c, "mean": t / max(c, 1), "min": lo,
                        "max": hi, "last": last}
                    for k, (c, t, lo, hi, last) in sorted(self._gauges.items())},
                "hists": {
                    k: h.to_dict() for k, h in sorted(self._hists.items())},
            }

    def write_summary(self, extra: Optional[dict] = None) -> Optional[str]:
        """Write the aggregated summary JSON (from process 0 only; other
        ranks' event files are folded offline)."""
        doc = self.summary()
        if extra:
            doc.update(extra)
        self.flush()
        path = os.path.join(self.out_dir, SUMMARY_NAME)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    def flush(self):
        with self._lock:
            if self._file is not None:
                self._file.flush()

    def close(self):
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
