"""Several models behind one frontend on one device, and the cascade
between two of them (counterpart of ``mx_rcnn_tpu/serve/pool.py``:
``param_nbytes``, ``ModelEntry``, ``ModelPool``, ``CascadeFuture``,
``CascadeRouter``).

:class:`ModelPool`:

* **The registry.**  Each entry keys a model id to its own config,
  ``Predictor`` (and so its own program registry) and
  :class:`~mx_rcnn_tpu_torch.serve.engine.ServeEngine`, started with
  ``start(external=True)``.  ``/predict?model=...`` resolves here; a
  request that names no model goes to the first one registered.
* **Weight residency.**  The models' parameters and buffers are paged
  between the device and the host under a byte budget
  (``--weight-budget-mb``), least recently used first; a pinned model is
  never paged out.  A page-out copies every tensor of ``predictor.model``
  into pinned host memory and points the tensor there, which frees its
  device memory; a page-in copies them back, into new device memory, and
  waits for the copies.  Both keep the tensors (their identity, shape and
  dtype), so neither is a first dispatch of any program.
* **Cross-model scheduling.**  One dispatcher thread owns the device:
  among the models with a due flush it takes the highest
  ``weight · (queue depth + 1)``, the least recently scheduled on a tie,
  pages the model in and runs the batch.  Within a model the engine's own
  bucket order holds.
* **Tenant isolation.**  An entry may carry its own
  :class:`~mx_rcnn_tpu_torch.serve.controller.SLOController`, which acts
  on that model's engine only.

:class:`CascadeRouter`: every gated request goes to the small model; its
engine's e2e batches fold their detections, still on the device, into
per-image hardness (``flywheel/hardness.py:build_device_hardness``,
kind ``cascade_gate`` in that engine's program registry) and read back B
floats; an image whose
hardness reaches ``thresh · HARDNESS_MAX`` is escalated to the big model
through :meth:`ServeEngine.submit_staged` with the small model's staged
pixels.  Request capture is not ported (ROADMAP.md A.7.7), so escalated
images feed no capture ring (the router's ``capture`` is None), and there
is no request tracing (A.7.9).

Driver: ``python -m mx_rcnn_tpu_torch.serve --models a=resnet101,b=...``
(``serve/driver.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.flywheel.hardness import (HARDNESS_MAX,
                                                 build_device_hardness)
from mx_rcnn_tpu_torch.logger import logger
from mx_rcnn_tpu_torch.telemetry import Hist

# tenant fidelity classes (--model-arg ID:fidelity=...): "cascade" routes
# the tenant's traffic through the gate, "full" pins it to the big model
FIDELITY_CLASSES = ("cascade", "full")


def _state_tensors(model: torch.nn.Module) -> List[torch.Tensor]:
    return [*model.parameters(), *model.buffers()]


def param_nbytes(model: Optional[torch.nn.Module]) -> int:
    """Bytes of a module's parameters and buffers (0 for None: a
    predictor without a model)."""
    if model is None:
        return 0
    return sum(t.numel() * t.element_size() for t in _state_tensors(model))


class ModelEntry:
    """One registered model: identity, compute, policy, residency."""

    __slots__ = ("model_id", "cfg", "predictor", "engine", "controller",
                 "pinned", "weight", "fidelity", "resident", "bytes",
                 "host_params", "last_use", "last_sched", "batches",
                 "page_ins", "page_outs")

    def __init__(self, model_id, cfg, predictor, engine, controller=None,
                 pinned=False, weight=1.0, fidelity="cascade"):
        self.model_id = model_id
        self.cfg = cfg
        self.predictor = predictor
        self.engine = engine
        self.controller = controller
        self.pinned = bool(pinned)
        self.weight = max(float(weight), 1e-3)
        if fidelity not in FIDELITY_CLASSES:
            raise ValueError(f"fidelity must be one of {FIDELITY_CLASSES}, "
                             f"got {fidelity!r}")
        self.fidelity = fidelity
        self.resident = True        # the predictor placed its weights
        self.bytes = param_nbytes(getattr(predictor, "model", None))
        self.host_params = None     # the host copies while paged out
        self.last_use = time.monotonic()
        self.last_sched = 0.0
        self.batches = 0
        self.page_ins = 0
        self.page_outs = 0


class ModelPool:
    """The model entries, the residency manager and the one cross-model
    dispatcher thread.  Engines must be started with
    ``start(external=True)`` before :meth:`add_model`."""

    def __init__(self, budget_bytes: int = 0, idle_poll_s: float = 0.05):
        # 0 = unbounded: nothing pages unless asked
        self.budget_bytes = max(int(budget_bytes), 0)
        self._idle_poll_s = max(float(idle_poll_s), 1e-3)
        self._entries: Dict[str, ModelEntry] = {}
        self._order: List[str] = []     # registration order; [0] = default
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._last_model: Optional[str] = None
        self.counters = {"weight_page_in": 0, "weight_page_out": 0,
                         "sched_batches": 0, "sched_switches": 0}
        self.hists = {"pool/page_in_time": Hist(),
                      "pool/page_out_time": Hist()}
        # a CascadeRouter under --cascade: /metrics grows "cascade".  The
        # pool never calls into it (escalations arrive as ordinary submits
        # to the big model's engine)
        self.cascade = None

    # -- registry --------------------------------------------------------

    def add_model(self, model_id: str, cfg, predictor, engine,
                  controller=None, pinned: bool = False,
                  weight: float = 1.0,
                  fidelity: str = "cascade") -> ModelEntry:
        if not model_id or "/" in model_id:
            raise ValueError(f"bad model id {model_id!r}")
        entry = ModelEntry(model_id, cfg, predictor, engine,
                           controller=controller, pinned=pinned,
                           weight=weight, fidelity=fidelity)
        with self._lock:
            if model_id in self._entries:
                raise ValueError(f"model {model_id!r} already registered")
            if pinned:
                pinned_total = entry.bytes + sum(
                    e.bytes for e in self._entries.values() if e.pinned)
                if self.budget_bytes and pinned_total > self.budget_bytes:
                    raise ValueError(
                        f"pinned models need {pinned_total} bytes, over "
                        f"the {self.budget_bytes}-byte weight budget")
            self._entries[model_id] = entry
            self._order.append(model_id)
        engine.on_work = self._wake.set
        # a new resident model may push the pool over budget: page colder
        # ones out rather than refuse the registration
        self.ensure_resident(model_id)
        logger.info("model pool: registered %r (%d bytes, pinned=%s, "
                    "weight=%g)", model_id, entry.bytes, pinned, weight)
        return entry

    def model_ids(self) -> List[str]:
        with self._lock:
            return list(self._order)

    @property
    def default_model(self) -> Optional[str]:
        with self._lock:
            return self._order[0] if self._order else None

    def entry(self, model_id: Optional[str] = None) -> ModelEntry:
        """A model id (None: the default) → its entry; ``KeyError`` for an
        unknown id (the frontend's 404)."""
        with self._lock:
            if model_id is None:
                if not self._order:
                    raise KeyError("model pool is empty")
                model_id = self._order[0]
            e = self._entries.get(model_id)
            if e is None:
                raise KeyError(f"unknown model {model_id!r} "
                               f"(have {sorted(self._entries)})")
            return e

    def engine_for(self, model_id: Optional[str] = None):
        return self.entry(model_id).engine

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ModelPool":
        if self._thread is not None:
            return self
        self._stop = False
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="pool-dispatch", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            if e.controller is not None:
                e.controller.stop()
            e.engine.stop(timeout=timeout)
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def readiness(self) -> dict:
        with self._lock:
            entries = [(mid, self._entries[mid]) for mid in self._order]
        per_model = {mid: e.engine.readiness() for mid, e in entries}
        return {"ready": bool(per_model)
                and all(d["ready"] for d in per_model.values()),
                "models": per_model}

    # -- weight residency ------------------------------------------------

    def ensure_resident(self, model_id: str) -> None:
        """Page ``model_id``'s weights in, paging least recently used
        unpinned siblings out as the budget needs.  The dispatcher calls
        it before every batch; a no-op when resident (the steady
        state)."""
        with self._lock:
            e = self._entries[model_id]
            e.last_use = time.monotonic()
            if e.resident:
                self._evict_over_budget_locked(keep=model_id)
                return
            self._evict_over_budget_locked(keep=model_id, incoming=e.bytes)
            self._page_in_locked(e)

    def _evict_over_budget_locked(self, keep: str, incoming: int = 0):
        if not self.budget_bytes:
            return
        resident = sum(e.bytes for e in self._entries.values()
                       if e.resident)
        over = resident + incoming - self.budget_bytes
        if over <= 0:
            return
        victims = sorted(
            (e for e in self._entries.values()
             if e.resident and not e.pinned and e.model_id != keep),
            key=lambda e: e.last_use)
        for v in victims:
            if over <= 0:
                break
            self._page_out_locked(v)
            over -= v.bytes
        if over > 0:
            # the pinned set and the incoming model alone exceed the budget:
            # serve anyway (refusing would deadlock traffic), but say so
            logger.warning("model pool: weight budget %d bytes exceeded "
                           "by %d bytes even after paging (pinned set too "
                           "large?)", self.budget_bytes, over)

    def _page_out_locked(self, e: ModelEntry):
        t0 = time.perf_counter()
        model = getattr(e.predictor, "model", None)
        if model is not None:
            tensors = _state_tensors(model)
            pin = any(t.device.type == "cuda" for t in tensors)
            with torch.no_grad():
                host = []
                for t in tensors:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                    h.copy_(t)
                    host.append(h)
                for t, h in zip(tensors, host):
                    t.data = h  # the device storage is released here
            e.host_params = host
        dt = time.perf_counter() - t0
        e.resident = False
        e.page_outs += 1
        self.counters["weight_page_out"] += 1
        self.hists["pool/page_out_time"].observe(dt)
        tel = telemetry.get()
        tel.counter("serve/weight_page_out")
        tel.observe("pool/page_out_time", dt)
        logger.info("model pool: paged OUT %r (%d bytes, %.1f ms)",
                    e.model_id, e.bytes, dt * 1e3)

    def _page_in_locked(self, e: ModelEntry):
        t0 = time.perf_counter()
        model = getattr(e.predictor, "model", None)
        if model is not None and e.host_params is not None:
            device = torch.device(e.predictor.device)
            with torch.no_grad():
                for t, h in zip(_state_tensors(model), e.host_params):
                    t.data = h.to(device, non_blocking=True)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            e.bytes = param_nbytes(model)
        dt = time.perf_counter() - t0
        e.host_params = None
        e.resident = True
        e.page_ins += 1
        self.counters["weight_page_in"] += 1
        self.hists["pool/page_in_time"].observe(dt)
        tel = telemetry.get()
        tel.counter("serve/weight_page_in")
        tel.observe("pool/page_in_time", dt)
        logger.info("model pool: paged IN %r (%d bytes, %.1f ms)",
                    e.model_id, e.bytes, dt * 1e3)

    def residency(self) -> dict:
        """The ``/metrics`` residency doc: the budget, the bytes on the
        device, each model's block, and the paging times (ms: mean and
        bucketed quantiles);
        mirrored into the sink as ``serve/resident_bytes`` and
        ``serve/resident/<model>``."""
        now = time.monotonic()
        with self._lock:
            models = {
                e.model_id: {"resident": int(e.resident),
                             "bytes": e.bytes,
                             "pinned": e.pinned,
                             "weight": e.weight,
                             "page_ins": e.page_ins,
                             "page_outs": e.page_outs,
                             "idle_s": round(now - e.last_use, 3)}
                for e in self._entries.values()}
            device_bytes = sum(e.bytes for e in self._entries.values()
                               if e.resident)
        tel = telemetry.get()
        tel.gauge("serve/resident_bytes", device_bytes)
        for mid, doc in models.items():
            tel.gauge(f"serve/resident/{mid}", doc["resident"])
        times = {}
        for name, h in self.hists.items():
            key = name.split("/")[1]
            d = h.to_dict()
            if d["count"]:
                times[f"{key}_mean_ms"] = round(d["sum"] / d["count"] * 1e3,
                                                3)
            for q, tag in ((0.5, "p50_ms"), (0.99, "p99_ms")):
                v = h.quantile(q)
                if v is not None:
                    times[f"{key}_{tag}"] = round(v * 1e3, 3)
        return {"budget_bytes": self.budget_bytes,
                "device_bytes": device_bytes,
                "resident_models": sum(d["resident"]
                                       for d in models.values()),
                "models": models, "paging": times}

    # -- cross-model dispatch --------------------------------------------

    def _pick_locked(self, now: float):
        """(entry, wait_s): the due model with the best ``weight · (depth
        + 1)``, least recently scheduled first on a tie, or (None, the
        soonest wait) when nothing is due."""
        best = None
        best_score = None
        wait = None
        for mid in self._order:
            e = self._entries[mid]
            due, depth, w = e.engine.due_state(now)
            if due:
                score = (e.weight * (depth + 1), -e.last_sched)
                if best is None or score > best_score:
                    best, best_score = e, score
            elif w is not None:
                wait = w if wait is None else min(wait, w)
        return best, wait

    def _dispatch_loop(self):
        while not self._stop:
            now = time.monotonic()
            with self._lock:
                e, wait = self._pick_locked(now)
            if e is None:
                timeout = self._idle_poll_s if wait is None \
                    else max(min(wait, self._idle_poll_s), 1e-4)
                self._wake.wait(timeout=timeout)
                self._wake.clear()
                continue
            batch, _ = e.engine.poll(now)
            if batch is None:
                continue  # raced with a sweep or a policy change
            self.ensure_resident(e.model_id)
            with self._lock:
                if self._last_model not in (None, e.model_id):
                    self.counters["sched_switches"] += 1
                self._last_model = e.model_id
                e.last_sched = now
                e.batches += 1
                self.counters["sched_batches"] += 1
            e.engine.dispatch_batch(batch)

    # -- introspection ---------------------------------------------------

    def metrics(self) -> dict:
        """The pool's ``/metrics``: every model's engine counters summed
        under ``counters`` (single-model clients keep working), each
        model's own payload under ``models``, the scheduler's and the
        residency state, and the cascade's when one is attached."""
        with self._lock:
            order = list(self._order)
            pool_counters = dict(self.counters)
            batches = {mid: self._entries[mid].batches for mid in order}
        models = {mid: self.engine_for(mid).metrics() for mid in order}
        agg: Dict[str, float] = {}
        for doc in models.values():
            for k, v in (doc.get("counters") or {}).items():
                if isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0) + v
        out = {"multimodel": True,
               "default_model": order[0] if order else None,
               "models": models,
               "counters": agg,
               "queue_depth": sum(d.get("queue_depth", 0)
                                  for d in models.values()),
               "ready": bool(models) and all(d.get("ready")
                                             for d in models.values()),
               "pool": {"counters": pool_counters,
                        "batches": batches,
                        "last_model": self._last_model},
               "residency": self.residency()}
        if self.cascade is not None:
            out["cascade"] = self.cascade.metrics()
        return out


# ---------------------------------------------------------------------------
# The cascade: the small model first, the hard images escalated.


class CascadeFuture:
    """Completion handle of one cascade-routed request, with the
    :class:`~mx_rcnn_tpu_torch.serve.engine.ServeFuture` surface that the
    frontend and the stream layer read (``result``, ``queue_wait_s``,
    ``_error``).  In ``gate``
    mode the escalation is decided once, at the first ``result``, from the
    hardness the gate stamped on the small model's future, so concurrent
    callers see one decision and one escalated submit."""

    __slots__ = ("_router", "_fut", "_mode", "_model", "_reason",
                 "_deadline_ms", "_lock", "_decided", "_escalated",
                 "_big_fut")

    def __init__(self, router, fut, mode, model, reason=None,
                 deadline_ms=None):
        self._router = router
        self._fut = fut              # the small model's (gate) or the final
        self._mode = mode            # "gate" | "direct"
        self._model = model
        self._reason = reason
        self._deadline_ms = deadline_ms
        self._lock = threading.Lock()
        self._decided = False
        self._escalated = False
        self._big_fut = None

    @property
    def _error(self):
        with self._lock:
            big = self._big_fut
        return (big if big is not None else self._fut)._error

    @property
    def queue_wait_s(self):
        """The client's whole queue residence: the small model's wait, and
        for an escalated image the big model's too."""
        total = self._fut.queue_wait_s
        with self._lock:
            big = self._big_fut
        if big is not None and big.queue_wait_s is not None:
            total = (total or 0.0) + big.queue_wait_s
        return total

    def result(self, timeout=None):
        if self._mode == "direct":
            return self._fut.result(timeout)
        records = self._fut.result(timeout)
        with self._lock:
            if not self._decided:
                self._decided = True
                h = self._fut.hardness
                req = self._fut.request
                if (h is not None and req is not None
                        and self._router.should_escalate(h)):
                    try:
                        self._big_fut = self._router._escalate(
                            req, deadline_ms=self._deadline_ms)
                        self._escalated = True
                    except Exception:  # noqa: BLE001 — degrade, not 503
                        # the big model refused (queue full, draining):
                        # answer with the small model's records
                        self._router._note_escalation_rejected()
                if not self._escalated:
                    self._router._note_answered_small()
            big = self._big_fut
        if big is None:
            return records
        return big.result(timeout)

    def provenance(self) -> dict:
        """The ``cascade`` field of a reply: which model answered, why."""
        if self._mode == "direct":
            doc = {"model": self._model, "escalated": False}
            if self._reason:
                doc["reason"] = self._reason
            return doc
        with self._lock:
            esc = self._escalated
        doc = {"model": self._router.big if esc else self._router.small,
               "escalated": esc, "thresh": self._router.thresh}
        h = self._fut.hardness
        if h is not None:
            doc["hardness"] = round(float(h), 4)
        return doc


class CascadeRouter:
    """The accuracy-aware router over a (small, big) pair of a pool.

    A gated request goes to the small model, whose engine runs the gate
    (registry kind ``cascade_gate``) on each e2e batch's detections on the
    device and stamps each future with its image's hardness before the
    readback.  An image whose hardness reaches ``thresh · HARDNESS_MAX``
    is submitted again to the big model's engine through
    :meth:`~mx_rcnn_tpu_torch.serve.engine.ServeEngine.submit_staged`,
    with the staged pixels reused, and rides the pool's scheduler.

    Routing by the addressed model id: the small (default) model gates;
    the big one is served directly ("addressed"); an entry with
    ``fidelity="full"`` goes to the big model ("fidelity"); any other
    model of the pool bypasses the cascade.  Capture is not ported, so
    ``capture`` is None and escalated images are not logged for mining.
    """

    KIND = "cascade_gate"

    def __init__(self, pool: ModelPool, small: str, big: str,
                 thresh: float = 0.5):
        if small == big:
            raise ValueError("--cascade needs two DISTINCT models, got "
                             f"{small!r} twice")
        if not 0.0 <= float(thresh) <= 1.0:
            raise ValueError(f"cascade thresh must be in [0, 1], got "
                             f"{thresh}")
        self.pool = pool
        self.small = small
        self.big = big
        self.thresh = float(thresh)
        self._thresh_raw = self.thresh * HARDNESS_MAX
        self.small_entry = pool.entry(small)   # KeyError: unknown model
        self.big_entry = pool.entry(big)
        se, be = self.small_entry.engine, self.big_entry.engine
        for eng, mid in ((se, small), (be, big)):
            if not eng.opts.serve_e2e:
                raise ValueError(
                    f"--cascade requires --serve-e2e on every cascade "
                    f"model (the gate consumes the fused program's "
                    f"on-device detections); model {mid!r} is not e2e")
        # escalation reuses the small model's staged buffers: both engines
        # must agree on the bucket of every orientation
        for h, w in ((100, 200), (200, 100)):
            if se.bucket_key(h, w) != be.bucket_key(h, w):
                raise ValueError(
                    f"cascade models disagree on bucket geometry "
                    f"({small}: {se.bucket_key(h, w)} vs {big}: "
                    f"{be.bucket_key(h, w)} for a {h}x{w} image) — "
                    f"escalation cannot reuse staged pixels; align "
                    f"SCALES and strides")
        self._lock = threading.Lock()
        self.counters = {"answered_small": 0, "escalated": 0,
                         "forced_big": 0, "gate_batches": 0,
                         "escalation_rejected": 0}
        self.hists = {"cascade/gate_time": Hist(),
                      "cascade/hardness": Hist()}
        # the gate consumes the small model's detections: its first
        # dispatches count in that model's registry
        self._registry = se.registry
        self._fn = build_device_hardness()
        self.capture = None
        se.cascade = self

    # -- the gate on the device ------------------------------------------

    def _dispatch_gate(self, dets, dvalid):
        """The gate on the device detections → (hardness (B,) numpy,
        wall seconds, its readback included), first dispatches counted by
        the registry."""
        reg = self._registry
        shape = tuple(dets.shape)
        first = reg.note_dispatch(self.KIND, shape)
        t0 = time.perf_counter()
        with torch.inference_mode():
            hard = self._fn(dets, dvalid).cpu().numpy()  # (B,) readback
        dt = time.perf_counter() - t0
        if first:
            reg.record_compile_seconds(self.KIND, shape, dt)
        return hard, dt

    def gate_batch(self, dets, dvalid, reqs) -> None:
        """The small engine's hook in its e2e forward: stamp each future
        with its image's hardness and its request, and observe the gate's
        cost."""
        hard, dt = self._dispatch_gate(dets, dvalid)
        tel = telemetry.get()
        self.hists["cascade/gate_time"].observe(dt)
        tel.observe("cascade/gate_time", dt)
        with self._lock:
            self.counters["gate_batches"] += 1
        tel.counter("cascade/gate_batches")
        for b, r in enumerate(reqs):
            h = float(hard[b])
            r.future.hardness = h
            r.future.request = r
            self.hists["cascade/hardness"].observe(h)

    def should_escalate(self, hardness: float) -> bool:
        """thresh 0 escalates everything (>=), thresh 1 nothing (the bound
        is never reached)."""
        return hardness >= self._thresh_raw

    def warmup(self) -> int:
        """First-dispatch the gate before traffic, on zero detections of
        the steady-state shape (one program for both buckets).  Returns
        the registry programs it added."""
        eng = self.small_entry.engine
        mpi = int(self.small_entry.cfg.TEST.MAX_PER_IMAGE)
        dev = torch.device(getattr(eng.predictor, "device", "cpu"))
        before = self._registry.counters["programs"]
        self._dispatch_gate(
            torch.zeros((eng.opts.batch_size, mpi, 6), device=dev),
            torch.zeros((eng.opts.batch_size, mpi), dtype=torch.bool,
                        device=dev))
        return self._registry.counters["programs"] - before

    # -- routing ---------------------------------------------------------

    def submit(self, image, deadline_ms=None, stream=None,
               model_id=None) -> CascadeFuture:
        """Route one request.  ``KeyError`` for an unknown model id (the
        frontend's 404); the engines' admission errors pass through."""
        entry = self.pool.entry(model_id)
        mid = entry.model_id
        if mid == self.big:
            fut = entry.engine.submit(image, deadline_ms=deadline_ms,
                                      stream=stream)
            return CascadeFuture(self, fut, "direct", mid,
                                 reason="addressed")
        if entry.fidelity == "full":
            with self._lock:
                self.counters["forced_big"] += 1
            telemetry.get().counter("cascade/forced_big")
            fut = self.big_entry.engine.submit(
                image, deadline_ms=deadline_ms, stream=stream)
            return CascadeFuture(self, fut, "direct", self.big,
                                 reason="fidelity")
        if mid != self.small:
            fut = entry.engine.submit(image, deadline_ms=deadline_ms,
                                      stream=stream)
            return CascadeFuture(self, fut, "direct", mid, reason="bypass")
        fut = entry.engine.submit(image, deadline_ms=deadline_ms,
                                  stream=stream)
        return CascadeFuture(self, fut, "gate", mid,
                             deadline_ms=deadline_ms)

    # -- decision bookkeeping (called by CascadeFuture, once each) -------

    def _escalate(self, req, deadline_ms=None):
        fut = self.big_entry.engine.submit_staged(
            req.image, req.raw_hw, req.ratio, req.im_info, req.orig_hw,
            deadline_ms=deadline_ms, stream=req.stream)
        tel = telemetry.get()
        with self._lock:
            self.counters["escalated"] += 1
            rate = self._rate_locked()
        tel.counter("cascade/escalated")
        tel.gauge("cascade/escalation_rate", rate)
        return fut

    def _note_answered_small(self):
        tel = telemetry.get()
        with self._lock:
            self.counters["answered_small"] += 1
            rate = self._rate_locked()
        tel.counter("cascade/answered_small")
        tel.gauge("cascade/escalation_rate", rate)

    def _note_escalation_rejected(self):
        with self._lock:
            self.counters["escalation_rejected"] += 1
        telemetry.get().counter("cascade/escalation_rejected")

    def _rate_locked(self) -> float:
        dec = self.counters["answered_small"] + self.counters["escalated"]
        return self.counters["escalated"] / max(1, dec)

    # -- introspection ---------------------------------------------------

    def metrics(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
            rate = self._rate_locked()
        out = {"small": self.small, "big": self.big,
               "thresh": self.thresh,
               "counters": counters,
               "escalation_rate": round(rate, 4)}
        stats = {}
        for q, tag in ((0.5, "p50"), (0.99, "p99")):
            v = self.hists["cascade/gate_time"].quantile(q)
            if v is not None:
                stats[f"gate_time_{tag}_ms"] = round(v * 1e3, 3)
            h = self.hists["cascade/hardness"].quantile(q)
            if h is not None:
                stats[f"hardness_{tag}"] = round(h, 4)
        out["latency"] = stats
        return out
