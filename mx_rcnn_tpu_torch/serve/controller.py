"""SLO-driven admission controller (counterpart of
``mx_rcnn_tpu/serve/controller.py``).

A :class:`SLOController` reads the engine's own latency histograms and
queue state every control tick and steers three knobs toward a
``--target-p99-ms``:

* **per-bucket flush delay** — AIMD: halve a bucket's ``max_delay_ms``
  when the windowed p99 breaches the target, creep it back toward the
  configured value by 10% steps after ``relax_after`` consecutive healthy
  ticks.
* **per-bucket flush batch** — the same AIMD on the flush threshold,
  between 1 and ``opts.batch_size``; the program shape never changes.
* **admission limit** — when the queue-depth trend (least-squares slope
  over the tick history) grows AND the predicted drain time (depth /
  recent serve rate) exceeds ``shed_margin`` x target, cap admissions at
  the depth the engine can drain within budget; further submits 503 at
  once (``serve/shed``).

Every decision is telemetry: ``slo/decisions`` / ``slo/tighten`` /
``slo/relax`` / ``slo/shed_on`` / ``slo/shed_off`` counters,
``slo/p99_ms`` / ``slo/queue_depth`` / ``slo/drain_rate`` /
``slo/admit_limit`` gauges, an ``slo_decision`` meta event per action,
and a flight-recorder dump on the shed-on transition.  ``tick()`` takes an
injectable ``now`` so that tests drive the control law without threads.
The capacity signal the JAX autoscaler reads is not ported yet.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.logger import logger


@dataclass(frozen=True)
class ControllerOptions:
    """Control-law knobs (CLI: ``--target-p99-ms`` / ``--slo-interval-ms``
    / ``--slo-window-s``)."""

    # the SLO: windowed end-to-end request-time p99 to hold, milliseconds
    target_p99_ms: float = 100.0
    # control tick period; also the granularity of trend estimation
    interval_s: float = 0.5
    # trailing window the p99 is computed over — long enough to smooth a
    # batch boundary, short enough that control reacts within seconds
    window_s: float = 10.0
    # don't act on fewer observations than this per window (noise guard)
    min_samples: int = 8
    # healthy band: relax only when p99 < headroom x target (hysteresis —
    # relaxing at 0.99 x target would oscillate across the boundary)
    headroom: float = 0.8
    # consecutive healthy ticks before each additive relax step
    relax_after: int = 4
    # shed when predicted drain time exceeds this multiple of the target
    shed_margin: float = 1.5
    # how many ticks of depth history feed the trend slope
    trend_ticks: int = 8
    # tenant/model label ("" for a single model): in log lines, state()
    # and the slo_decision meta, so that a shed names its tenant
    label: str = ""

    def __post_init__(self):
        if self.target_p99_ms <= 0:
            raise ValueError(
                f"target_p99_ms must be > 0, got {self.target_p99_ms}")
        if self.interval_s <= 0:
            raise ValueError(
                f"interval_s must be > 0, got {self.interval_s}")
        if not 0.0 < self.headroom < 1.0:
            raise ValueError(
                f"headroom must be in (0, 1), got {self.headroom}")


class SLOController:
    """Periodic controller over one :class:`ServeEngine`.

    ``start()`` attaches to the engine (``engine.controller = self``, so
    ``/metrics`` carries live controller state) and spawns the tick
    thread; ``stop()`` detaches and restores the engine's configured
    policy.  Tests call :meth:`tick` directly.
    """

    def __init__(self, engine, options: Optional[ControllerOptions] = None):
        self.engine = engine
        self.opts = options or ControllerOptions()
        self._lock = threading.Lock()
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._depth_hist: list = []       # [(now, depth)] trend window
        self._count_hist: list = []       # hist.count per tick (window base)
        self._admit_limit: Optional[int] = None
        self._last_served = 0             # counters["served"] at last tick
        self._last_tick_t: Optional[float] = None
        self._healthy_streak = 0
        self._shedding = False
        self.ticks = 0
        self.decisions = 0                # ticks that changed any knob
        self.last_p99_ms: Optional[float] = None
        self.last_drain_rate = 0.0
        self.last_slope = 0.0
        self.last_depth = 0

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "SLOController":
        assert self._thread is None, "controller already started"
        self.engine.controller = self
        self._thread = threading.Thread(target=self._run,
                                        name="slo-controller", daemon=True)
        self._thread.start()
        logger.info("SLO controller%s on: target p99 %.1f ms, tick "
                    "%.0f ms, window %.1f s",
                    f" [{self.opts.label}]" if self.opts.label else "",
                    self.opts.target_p99_ms,
                    self.opts.interval_s * 1e3, self.opts.window_s)
        return self

    def stop(self, timeout: float = 5.0):
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        # restore configured policy so a stopped controller leaves no
        # residue (tightened buckets / a stale admit limit)
        for key in self.engine.known_buckets():
            self.engine.set_bucket_policy(
                key, max_batch=self.engine.opts.batch_size,
                max_delay_ms=self.engine.opts.max_delay_ms)
        self.engine.set_admit_limit(None)
        if self.engine.controller is self:
            self.engine.controller = None

    def _run(self):
        while not self._stop_event.wait(self.opts.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — control must not kill serve
                logger.exception("SLO controller tick failed")

    # -- the control law -------------------------------------------------

    def tick(self, now: Optional[float] = None):
        """One control decision.  ``now`` is injectable (monotonic) so
        tests can drive windows and trends without real time passing."""
        o = self.opts
        now = time.monotonic() if now is None else now
        tel = telemetry.get()
        eng = self.engine

        hist = eng.hists["serve/request_time"]
        samples = hist.count
        p99 = hist.window_quantile(0.99, o.window_s, now=now)
        p99_ms = None if p99 is None else p99 * 1e3
        depth = eng.queue_depth()

        # serve rate since the last tick (requests actually completed)
        served = eng.counters["served"]
        if self._last_tick_t is not None and now > self._last_tick_t:
            rate = (served - self._last_served) / (now - self._last_tick_t)
        else:
            rate = 0.0
        self._last_served, self._last_tick_t = served, now

        # queue-depth trend: least-squares slope over the tick history
        self._depth_hist.append((now, depth))
        self._depth_hist = self._depth_hist[-o.trend_ticks:]
        slope = _slope(self._depth_hist)

        window_n = samples - self._window_base(samples, now)
        acted = []

        target_s = o.target_p99_ms / 1e3
        breach = (p99_ms is not None and window_n >= o.min_samples
                  and p99_ms > o.target_p99_ms)
        healthy = (p99_ms is None
                   or p99_ms < o.headroom * o.target_p99_ms)

        if breach:
            self._healthy_streak = 0
            for key in eng.known_buckets():
                b, d = eng.bucket_policy(key)
                nb = max(1, b - 1)
                nd = d / 2.0 if d > 0.25 else 0.0
                if (nb, nd) != (b, d):
                    eng.set_bucket_policy(key, max_batch=nb,
                                          max_delay_ms=nd)
                    acted.append(("tighten", key, nb, nd))
                    tel.counter("slo/tighten")
        elif healthy:
            self._healthy_streak += 1
            if self._healthy_streak >= o.relax_after:
                self._healthy_streak = 0
                cfg_b = eng.opts.batch_size
                cfg_d = eng.opts.max_delay_ms
                for key in eng.known_buckets():
                    b, d = eng.bucket_policy(key)
                    nb = min(cfg_b, b + 1)
                    nd = min(cfg_d, d + max(cfg_d * 0.1, 0.5))
                    if (nb, nd) != (b, d):
                        eng.set_bucket_policy(key, max_batch=nb,
                                              max_delay_ms=nd)
                        acted.append(("relax", key, nb, nd))
                        tel.counter("slo/relax")
        else:
            self._healthy_streak = 0

        # predictive shed: growing queue that cannot drain within budget
        drain_s = depth / rate if rate > 0 else (float("inf") if depth
                                                 else 0.0)
        should_shed = (depth > 0 and slope > 0
                       and drain_s > o.shed_margin * target_s)
        if should_shed:
            # admit what the engine can drain within the latency budget
            limit = max(eng.opts.batch_size,
                        int(rate * target_s * o.shed_margin))
            eng.set_admit_limit(limit)
            self._admit_limit = limit
            if not self._shedding:
                self._shedding = True
                acted.append(("shed_on", None, limit, None))
                tel.counter("slo/shed_on")
                tel.dump_flight("slo_shed", p99_ms=p99_ms, depth=depth,
                                slope=slope, drain_s=drain_s,
                                admit_limit=limit)
                logger.warning(
                    "SLO shed ON%s: depth %d growing (%.2f/s), drain "
                    "%.2fs > %.2fs budget — admissions capped at %d",
                    f" [{o.label}]" if o.label else "", depth,
                    slope, drain_s, o.shed_margin * target_s, limit)
        elif self._shedding and healthy and slope <= 0:
            self._shedding = False
            eng.set_admit_limit(None)
            self._admit_limit = None
            acted.append(("shed_off", None, None, None))
            tel.counter("slo/shed_off")
            logger.info("SLO shed OFF: queue drained, p99 back in budget")

        with self._lock:
            self.ticks += 1
            self.last_p99_ms = p99_ms
            self.last_drain_rate = rate
            self.last_slope = slope
            self.last_depth = depth
            if acted:
                self.decisions += len(acted)

        if p99_ms is not None:
            tel.gauge("slo/p99_ms", p99_ms)
        tel.gauge("slo/queue_depth", depth)
        tel.gauge("slo/drain_rate", rate)
        tel.gauge("slo/admit_limit",
                  self._admit_limit if self._admit_limit is not None else -1)
        for action, key, b, d in acted:
            tel.counter("slo/decisions")
            tel.meta("slo_decision", action=action, tenant=o.label or None,
                     bucket=None if key is None else f"{key[0]}x{key[1]}",
                     max_batch=b, max_delay_ms=d, p99_ms=p99_ms,
                     depth=depth, slope=round(slope, 4))
        return acted

    def _window_base(self, samples: int, now: float) -> int:
        # observation count outside the window = count at (now − window),
        # read from per-tick (t, count) records; 0 while the history is
        # still shorter than one window, matching ``window_quantile``'s
        # whole-history fallback
        o = self.opts
        cutoff = now - o.window_s
        self._count_hist.append((now, samples))
        keep = max(int(o.window_s / o.interval_s) + 2, 2)
        self._count_hist = self._count_hist[-keep:]
        base = 0
        for t, c in self._count_hist:
            if t > cutoff:
                break
            base = c
        return base

    # -- introspection ---------------------------------------------------

    def state(self) -> dict:
        """Live controller state for ``/metrics`` (JSON) and
        ``engine_summary`` (the ``gauges`` sub-dict folds into the
        Prometheus registry)."""
        with self._lock:
            return {
                "label": self.opts.label,
                "target_p99_ms": self.opts.target_p99_ms,
                "ticks": self.ticks,
                "decisions": self.decisions,
                "shedding": self._shedding,
                "admit_limit": self._admit_limit,
                "last_p99_ms": self.last_p99_ms,
                "gauges": {
                    "slo/target_p99_ms": self.opts.target_p99_ms,
                    "slo/last_p99_ms": self.last_p99_ms or 0.0,
                    "slo/decisions": float(self.decisions),
                    "slo/shedding": 1.0 if self._shedding else 0.0,
                    "slo/queue_depth_slope": self.last_slope,
                    "slo/drain_rate": self.last_drain_rate,
                },
            }


def _slope(points) -> float:
    """Least-squares slope of [(t, y)] — the queue-depth trend in
    requests/second.  0 for fewer than 2 points or zero time spread."""
    n = len(points)
    if n < 2:
        return 0.0
    t0 = points[0][0]
    xs = [t - t0 for t, _ in points]
    ys = [float(y) for _, y in points]
    mx = sum(xs) / n
    my = sum(ys) / n
    denom = sum((x - mx) ** 2 for x in xs)
    if denom <= 0:
        return 0.0
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom
