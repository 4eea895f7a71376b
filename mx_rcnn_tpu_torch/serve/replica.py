"""Replica side of the multi-replica serving plane (counterpart of
``mx_rcnn_tpu/serve/replica.py``).

One replica is one supervised process (``python -m mx_rcnn_tpu_torch.serve
--replica-index I --unix-socket S``) running the ordinary ``Predictor`` →
``ServeEngine`` → HTTP stack on its own CUDA context.  This module holds
what runs inside it, and the in-process hot reload of a single server:

* :func:`serve_replica` — the child's main loop: HTTP up first (liveness
  answers while warmup runs), then warmup and readiness, then park until
  SIGTERM.
* :func:`reload_engine_params` — the weight swap: quiesce → load →
  ``Predictor.update_params`` → canary → resume.  ``update_params``
  copies into the model's own tensors, so the swap changes no program key
  (``recompiles_during_swap`` is 0); the rollback copies back a snapshot
  of every parameter and buffer taken before the swap, bitwise.
* :func:`scan_checkpoints` / :class:`CheckpointWatcher` — polling of the
  port's checkpoint layout (``train/checkpoint.py``: ``{prefix}-{E:04d}
  .npz`` and ``{prefix}-steps/step-{key:012d}.npz``), feeding reload
  targets to whoever rolls them (the supervisor across replicas, or the
  single server's watcher).
* :class:`ReplicaFaults` and :class:`NetFaults` — fault injection driven
  by environment variables, so tests and ``chip_smoke.py`` inject kill -9,
  hangs, slow starts, corrupt checkpoints and network faults without
  touching the code under test.

Fault-injection variables (each a comma-separated list of
``INDEX[:VALUE]`` tokens; a token applies to the replica whose
``--replica-index`` matches):

* ``MXR_FAULT_REPLICA_KILL_AFTER="0:5"`` — SIGKILL itself after 5 served
  2xx ``/predict`` replies.
* ``MXR_FAULT_REPLICA_HANG_AFTER="1:3"`` — wedge every later handler
  (probes included) after 3 served replies: alive to ``waitpid``, dead to
  the probes.
* ``MXR_FAULT_REPLICA_SLOW_START_S="0:8"`` — sleep 8 s between liveness
  and readiness.
* ``MXR_FAULT_REPLICA_CORRUPT_CKPT="0"`` — NaN every float leaf of every
  reloaded checkpoint, so the canary rejects it and the swap rolls back.
* ``MXR_FAULT_NET_DROP="1:4"`` — after 4 ``/predict`` requests every
  handler blackholes (a partition: probes time out).
* ``MXR_FAULT_NET_RESET="0:3-6"`` — ``/predict`` requests 3..6 (1-based;
  ``"0:3"`` means 3 onward) get their connection reset.
* ``MXR_FAULT_NET_DELAY_MS="2:250"`` — every ``/predict`` is delayed
  250 ms.

Device groups: the supervisor puts a replica's ``--replica-devices`` group
in ``MXR_REPLICA_DEVICES``; :func:`apply_replica_devices` maps it to
``CUDA_VISIBLE_DEVICES`` before the process first touches CUDA.  Not
ported yet: the fabric's ``join`` (ROADMAP.md A.7.5, raises by name) and
the trace context of ``tracectx.configure_from_env`` (A.7.9).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.data.image import stage_raw_to_bucket
from mx_rcnn_tpu_torch.kernels import nms_cuda
from mx_rcnn_tpu_torch.logger import logger
from mx_rcnn_tpu_torch.serve.frontend import make_server
from mx_rcnn_tpu_torch.serve.warmup import warmup
from mx_rcnn_tpu_torch.train.checkpoint import (CheckpointManager,
                                                denormalize_for_save)
from mx_rcnn_tpu_torch.train.resilience import decode_step_key

ENV_KILL_AFTER = "MXR_FAULT_REPLICA_KILL_AFTER"
ENV_HANG_AFTER = "MXR_FAULT_REPLICA_HANG_AFTER"
ENV_SLOW_START = "MXR_FAULT_REPLICA_SLOW_START_S"
ENV_CORRUPT_CKPT = "MXR_FAULT_REPLICA_CORRUPT_CKPT"
ENV_NET_DROP = "MXR_FAULT_NET_DROP"
ENV_NET_RESET = "MXR_FAULT_NET_RESET"
ENV_NET_DELAY = "MXR_FAULT_NET_DELAY_MS"
# set by the supervisor on each child; the injectors match against it
ENV_REPLICA_INDEX = "MXR_REPLICA_INDEX"
# the child's --replica-devices group, mapped to CUDA_VISIBLE_DEVICES
ENV_REPLICA_DEVICES = "MXR_REPLICA_DEVICES"

# how long the batch on the device may take to finish before a reload
# aborts (only a wedged dispatcher trips it)
RELOAD_DRAIN_TIMEOUT_S = 60.0


def apply_replica_devices(env=os.environ) -> Optional[str]:
    """``MXR_REPLICA_DEVICES`` → ``CUDA_VISIBLE_DEVICES`` in ``env``; call
    before the process first touches CUDA.  Returns the group (None when
    unset: the child sees every card, the one-card plane's case)."""
    group = env.get(ENV_REPLICA_DEVICES, "").strip()
    if not group:
        return None
    env["CUDA_VISIBLE_DEVICES"] = group
    return group


def _fault_value(env_name: str, index: int,
                 env=os.environ) -> Optional[str]:
    """The VALUE of the ``INDEX[:VALUE]`` token matching ``index`` in
    ``env_name`` ("" for a bare INDEX token), or None."""
    for tok in env.get(env_name, "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        idx, _, value = tok.partition(":")
        try:
            if int(idx) == index:
                return value
        except ValueError:
            logger.warning("bad %s token %r (want INDEX[:VALUE])",
                           env_name, tok)
    return None


class ReplicaFaults:
    """The ``MXR_FAULT_REPLICA_*`` state of one replica index, wired into
    the frontend's ``request_hook`` / ``gate`` and the reload.  Without a
    matching token every method is a no-op."""

    def __init__(self, index: int, env=os.environ):
        self.index = index

        def _num(name, cast):
            v = _fault_value(name, index, env)
            return None if v in (None, "") else cast(v)

        self.kill_after = _num(ENV_KILL_AFTER, int)
        self.hang_after = _num(ENV_HANG_AFTER, int)
        self.slow_start_s = _num(ENV_SLOW_START, float) or 0.0
        self.corrupt_ckpt = _fault_value(ENV_CORRUPT_CKPT, index,
                                         env) is not None
        self._served = 0
        self._hung = False
        self._lock = threading.Lock()

    def request_hook(self, status: int):
        """After each ``/predict`` reply: count the 2xx ones and fire the
        kill or the hang once the count is reached."""
        with self._lock:
            if 200 <= status < 300:
                self._served += 1
            served = self._served
        if self.kill_after is not None and served >= self.kill_after:
            logger.warning("FAULT replica %d: SIGKILL self after %d "
                           "served requests", self.index, served)
            os.kill(os.getpid(), signal.SIGKILL)
        if self.hang_after is not None and served >= self.hang_after:
            self._hung = True

    def gate(self):
        """Before any HTTP handling: a hung replica wedges every handler
        thread, probes included, which only the supervisor's probe
        timeouts can catch."""
        if self._hung:
            logger.warning("FAULT replica %d: hanging handler thread",
                           self.index)
            time.sleep(3600.0)

    def slow_start(self):
        if self.slow_start_s > 0:
            logger.warning("FAULT replica %d: slow start %.1fs (alive, "
                           "not ready)", self.index, self.slow_start_s)
            time.sleep(self.slow_start_s)


class NetFaults:
    """The ``MXR_FAULT_NET_*`` state of one member index, the frontend's
    ``net_faults`` (``intercept(path, handler)`` before any handling).
    Without a matching token ``enabled`` is False and the frontend is not
    given it."""

    def __init__(self, index: int, env=os.environ):
        self.index = index

        def _num(name, cast):
            v = _fault_value(name, index, env)
            return None if v is None else cast(v) if v != "" else 0
        self.drop_after = _num(ENV_NET_DROP, int)
        self.delay_ms = _num(ENV_NET_DELAY, float) or 0.0
        self.reset_from = None
        self.reset_to = None
        reset = _fault_value(ENV_NET_RESET, index, env)
        if reset:
            lo, _, hi = reset.partition("-")
            self.reset_from = int(lo)
            self.reset_to = int(hi) if hi else None
        self._predicts = 0
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return (self.drop_after is not None or self.delay_ms > 0
                or self.reset_from is not None)

    def intercept(self, path: str, handler) -> bool:
        """True when a fault consumed the request (blackholed or reset);
        False to go on handling it (perhaps delayed)."""
        p = path.partition("?")[0]
        with self._lock:
            if p == "/predict":
                self._predicts += 1
            n = self._predicts
        if self.drop_after is not None and n > self.drop_after:
            logger.warning("FAULT net %d: blackholing %s (partition)",
                           self.index, p)
            time.sleep(3600.0)
            return True
        if p != "/predict":
            return False
        if (self.reset_from is not None and n >= self.reset_from
                and (self.reset_to is None or n <= self.reset_to)):
            logger.warning("FAULT net %d: resetting /predict #%d",
                           self.index, n)
            self._reset_connection(handler)
            return True
        if self.delay_ms > 0:
            time.sleep(self.delay_ms / 1e3)
        return False

    @staticmethod
    def _reset_connection(handler):
        """Abort the connection with an RST (``SO_LINGER`` 0), so the
        client sees ``ConnectionResetError`` rather than an HTTP error."""
        import socket
        import struct
        handler.close_connection = True
        try:
            handler.connection.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER,
                struct.pack("ii", 1, 0))
        except OSError:
            pass
        try:
            handler.connection.close()
        except OSError:
            pass


def poison_params(params):
    """The corrupt-checkpoint injection: NaN every float leaf (dicts
    nested or flat, and bare numbers), the structure intact, so the swap
    itself succeeds and only the canary catches it."""
    if isinstance(params, dict):
        return {k: poison_params(v) for k, v in params.items()}
    arr = np.asarray(params)
    if np.issubdtype(arr.dtype, np.floating):
        return np.full_like(arr, np.nan)
    return params


# -- checkpoint discovery (the port's npz layout) -------------------------

def scan_checkpoints(prefix: str) -> Optional[dict]:
    """The newest committed checkpoint under the file prefix ``prefix`` as
    a reload target ``{"prefix", "kind", "epoch", "consumed"}``: epoch
    files ``{prefix}-{E:04d}.npz`` and step files ``{prefix}-steps/
    step-{key:012d}.npz``, the furthest position winning as in
    ``CheckpointManager.latest_resume_point`` (a finished epoch beats its
    own mid-epoch saves).  Only final names count: ``atomic_savez`` writes
    under ``{path}.tmp.{pid}.{tid}`` and renames, so a file still being
    written never matches, and neither does a ``.state.npz``."""
    mgr = CheckpointManager(prefix)
    cands = [(e, 0, "epoch") for e in mgr.available_epochs()]
    cands += [(*decode_step_key(k), "step") for k in mgr._step_keys()]
    if not cands:
        return None
    e, c, kind = max(cands)
    return {"prefix": prefix, "kind": kind, "epoch": e, "consumed": c}


def target_key(target: dict) -> tuple:
    """The identity of a reload target for dedup and the bad list."""
    return (target["epoch"], target["consumed"], target["kind"])


def load_serving_params(target: dict, cfg) -> dict:
    """A reload target's flat parameters, de-normalized for inference: an
    epoch file as saved; a step checkpoint holds the raw training
    parametrisation, so ``denormalize_for_save`` folds the bbox stats in
    (without it served boxes would decode against the normalised
    targets)."""
    mgr = CheckpointManager(target["prefix"])
    if target["kind"] == "step":
        payload = mgr.load_step_checkpoint(int(target["epoch"]),
                                           int(target["consumed"]))
        return denormalize_for_save(payload["params"], cfg)
    if target["kind"] != "epoch":
        raise ValueError(f"reload target kind must be 'epoch' or 'step', "
                         f"got {target['kind']!r}")
    return mgr.load_epoch(int(target["epoch"]), cfg, for_training=False)[0]


class CheckpointWatcher:
    """Polls a checkpoint prefix and calls ``reload_fn(target)`` when a
    newer generation appears.  A failed target (load error, canary
    rejection) goes on a bad list and is never retried: the next good save
    supersedes it.  :meth:`poll_once` is the test surface; :meth:`start`
    runs it on a daemon thread."""

    def __init__(self, prefix: str, reload_fn: Callable[[dict], bool],
                 interval_s: float = 5.0, scan_fn=None):
        self.prefix = prefix
        self.reload_fn = reload_fn
        self.interval_s = interval_s
        self._scan = scan_fn or scan_checkpoints
        self._last: Optional[tuple] = None
        self._bad: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def prime(self):
        """Mark what is on disk now as served (the weights the server booted
        from), so the first poll does not reload it onto itself."""
        tgt = self._scan(self.prefix)
        if tgt is not None:
            self._last = target_key(tgt)
        return tgt

    def poll_once(self):
        """One scan and perhaps one reload: None when nothing is new, else
        ``(target, ok)``."""
        tgt = self._scan(self.prefix)
        if tgt is None:
            return None
        key = target_key(tgt)
        if key == self._last or key in self._bad:
            return None
        if self._last is not None and key < self._last:
            return None  # never roll backward off a stale listing
        logger.info("checkpoint watcher: new generation %s under %s",
                    key, self.prefix)
        ok = bool(self.reload_fn(tgt))
        if ok:
            self._last = key
        else:
            self._bad.add(key)
            telemetry.get().counter("replica/reload_bad_target")
            logger.warning("checkpoint watcher: target %s rejected — "
                           "skipping it until a newer save appears", key)
        return tgt, ok

    def start(self) -> "CheckpointWatcher":
        assert self._thread is None, "watcher already started"
        self.prime()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.poll_once()
                except Exception:  # noqa: BLE001 — keep watching
                    logger.exception("checkpoint watcher poll failed")

        self._thread = threading.Thread(target=loop, name="ckpt-watcher",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# -- the hot swap ------------------------------------------------------------

def golden_image(h: int, w: int) -> np.ndarray:
    """The canary's input: a horizontal gradient (a constant image can
    hide a scale-dependent blow-up)."""
    row = np.linspace(32, 224, w).astype(np.uint8)
    return np.ascontiguousarray(
        np.broadcast_to(row[None, :, None], (h, w, 3)))


def _nonfinite(named) -> Optional[str]:
    """The name of the first float tensor of ``(name, tensor)`` pairs that
    holds a non-finite value, with one synchronisation for all."""
    named = [(n, t) for n, t in named if t.is_floating_point()]
    if not named:
        return None
    bad = torch.stack([(~torch.isfinite(t)).any() for _, t in named])
    hits = bad.nonzero()
    return named[int(hits[0, 0])][0] if len(hits) else None


def canary_probe(engine, predictor) -> tuple:
    """A golden batch through the program the engine dispatches, at the
    warmed landscape bucket: ``predict_serve_e2e`` (the NMS pair twice)
    in ``serve_e2e`` mode, else ``predict_staged`` (the proposal NMS
    once), on one ``put_staged`` copy, as the engine's batches.  Fails on
    any non-finite float output.  The e2e call also hands back its forward
    outputs: its detections zero the padded rows, so NaN scores (which no
    threshold keeps) would leave only finite zeros to check.  The canary
    goes around the engine's registry, so it first-dispatches nothing.
    Returns ``(ok, reason)``."""
    cfg = engine.cfg
    b = engine.opts.batch_size
    staged, raw_hw, ratio, info = stage_raw_to_bucket(
        golden_image(*engine._scale), engine._scale, engine._stride)
    args = predictor.put_staged(np.stack([staged] * b),
                                np.stack([raw_hw] * b),
                                np.asarray([ratio] * b, np.float32),
                                np.stack([info] * b))
    names = ("rois", "roi_valid", "cls_prob", "bbox_deltas")
    if engine.opts.serve_e2e:
        dets, _, fwd = predictor.predict_serve_e2e(
            *args, None, int(cfg.TEST.MAX_PER_IMAGE), float(cfg.TEST.THRESH),
            return_forward=True)
        bad = _nonfinite([("detections", dets)] + list(zip(names, fwd)))
    else:
        bad = _nonfinite(list(zip(names, predictor.predict_staged(*args))))
    if bad is not None:
        return False, f"non-finite {bad} on golden image"
    return True, "ok"


def _launch_counts() -> dict:
    return {"nms_mask": nms_cuda.nms_mask.launches,
            "nms_sweep": nms_cuda.nms_sweep.launches}


def _restore(predictor, snapshot) -> float:
    """Copy the pre-swap parameters and buffers back (bitwise) and drop
    the pyramid cache; returns the wall seconds, synchronised."""
    t0 = time.perf_counter()
    model = predictor.model
    with torch.no_grad():
        for t, old in zip((*model.parameters(), *model.buffers()),
                          snapshot):
            t.copy_(old)
    predictor._feats = None
    predictor._feats_token = None
    if predictor.device.type == "cuda":
        torch.cuda.synchronize(predictor.device)
    return time.perf_counter() - t0


def _reject(engine, target, gen, cause: str, rollback_s: float) -> tuple:
    tel = telemetry.get()
    tel.counter("serve/reload_rollback")
    tel.dump_flight("reload_canary_failed", generation=gen,
                    target=list(target_key(target)), cause=cause)
    logger.error("hot reload of %s REJECTED (%s) — rolled back to "
                 "generation %d", target_key(target), cause,
                 engine.generation)
    info = {"error": cause, "rolled_back": True,
            "rollback_ms": round(rollback_s * 1e3, 3)}
    engine.last_reload = dict(info, ok=False,
                              target=list(target_key(target)))
    return False, info


def reload_engine_params(engine, predictor, cfg, target: dict,
                         load_params_fn=None, faults=None) -> tuple:
    """The weight swap on one engine: quiesce → load → swap → canary →
    resume.  Returns ``(ok, info)``.  On a load error or a failed canary
    the parameters and buffers snapshotted before the swap are copied
    back bitwise (``update_params`` writes into the model's own tensors,
    so the old values exist nowhere else) and the engine resumes on them.
    ``info["recompiles_during_swap"]`` pins the registry contract: 0.

    The engine is quiesced, not drained: requests arriving meanwhile
    queue and flush on the new weights, so a single server answers no 503
    for the swap.  A target carrying ``eval_shard`` (the fleet's quality
    gate) is refused: it belongs to the flywheel (ROADMAP.md A.12), not
    ported; the generation does not advance."""
    tel = telemetry.get()
    t0 = time.monotonic()
    gen = int(target.get("generation", engine.generation + 1))
    if target.get("eval_shard"):
        info = {"error": "the eval_shard quality gate belongs to the fleet "
                         "flywheel (ROADMAP.md A.12), not ported yet",
                "rolled_back": False}
        engine.last_reload = dict(info, ok=False,
                                  target=list(target_key(target)))
        return False, info
    if not engine.quiesce(timeout=RELOAD_DRAIN_TIMEOUT_S):
        engine.resume()
        return False, {"error": "quiesce timed out — dispatcher wedged?",
                       "rolled_back": False}
    recompiles_before = engine.counters["recompiles"]
    model = predictor.model
    try:
        with torch.no_grad():
            snapshot = [t.detach().clone()
                        for t in (*model.parameters(), *model.buffers())]
        try:
            load = load_params_fn or load_serving_params
            params = load(target, cfg)
            if faults is not None and faults.corrupt_ckpt:
                logger.warning("FAULT: poisoning reloaded checkpoint %s with "
                               "NaN", target_key(target))
                params = poison_params(params)
            t_swap = time.perf_counter()
            predictor.update_params(params)
            t_canary = time.perf_counter()
            before = _launch_counts()
            ok, reason = canary_probe(engine, predictor)
            t_done = time.perf_counter()
        except Exception as e:  # noqa: BLE001 — a bad save must not kill serving
            logger.exception("hot reload of %s failed", target_key(target))
            return _reject(engine, target, gen, f"{type(e).__name__}: {e}",
                           _restore(predictor, snapshot))
        if not ok:
            return _reject(engine, target, gen, f"canary failed: {reason}",
                           _restore(predictor, snapshot))
        del snapshot
        after = _launch_counts()
        with engine._lock:
            engine.generation = max(engine.generation, gen)
    finally:
        engine.resume()
    swap_recompiles = engine.counters["recompiles"] - recompiles_before
    tel.counter("serve/reload")
    tel.gauge("serve/generation", engine.generation)
    wall = time.monotonic() - t0
    logger.info("hot reload: generation %d live from %s in %.2fs "
                "(%d recompile(s) during swap)", engine.generation,
                target_key(target), wall, swap_recompiles)
    info = {"generation": engine.generation,
            "target": list(target_key(target)),
            "wall_s": round(wall, 3),
            "update_ms": round((t_canary - t_swap) * 1e3, 3),
            "canary_ms": round((t_done - t_canary) * 1e3, 3),
            "canary_launches": {k: after[k] - before[k] for k in after},
            "recompiles_during_swap": swap_recompiles}
    engine.last_reload = dict(info, ok=True)
    return True, info


def make_reloader(engine, predictor, cfg, load_params_fn=None,
                  faults=None):
    """The frontend's ``POST /admin/reload`` callback: the body is a
    reload target; 200 when the new generation is live, 409 when rejected
    and rolled back, 400 without the target's keys.  Serialised: two
    swaps of one engine would race."""
    lock = threading.Lock()

    def reloader(doc: dict) -> tuple:
        required = {"prefix", "kind", "epoch", "consumed"}
        if not required.issubset(doc):
            return 400, {"error": f"reload target needs {sorted(required)}"}
        with lock:
            ok, info = reload_engine_params(
                engine, predictor, cfg, doc,
                load_params_fn=load_params_fn, faults=faults)
        return (200 if ok else 409), info

    return reloader


# -- the child main loop -----------------------------------------------------

def serve_replica(engine, cfg, sock_path: str, index: int = 0,
                  predictor=None, done: Optional[threading.Event] = None,
                  join: Optional[str] = None) -> None:
    """Run one replica to the end on the Unix socket ``sock_path``: the
    HTTP server first (liveness answers while warmup runs), then warmup
    and readiness, then park until ``done`` (set by the driver's signal
    handler); then stop the server and the engine.  The engine must be
    started; ``predictor`` defaults to ``engine.predictor``.  ``join``
    (registering with a fabric router, over TCP) is the fabric's,
    ROADMAP.md A.7.5, not ported yet."""
    if join:
        raise NotImplementedError(
            "serve_replica(join=...) registers with a fabric router, which "
            "is not ported yet (ROADMAP.md A.7.5)")
    predictor = predictor if predictor is not None else engine.predictor
    faults = ReplicaFaults(index)
    net = NetFaults(index)
    reloader = make_reloader(engine, predictor, cfg, faults=faults)
    server = make_server(engine, unix_socket=sock_path, reloader=reloader,
                         request_hook=faults.request_hook,
                         gate=faults.gate,
                         net_faults=net if net.enabled else None)
    th = threading.Thread(target=server.serve_forever,
                          name=f"replica-{index}-http", daemon=True)
    th.start()
    logger.info("replica %d: live on %s (warming)", index, sock_path)
    try:
        faults.slow_start()
        warmup(engine)  # marks the engine ready: /readyz turns 200
        logger.info("replica %d: ready (generation %d)", index,
                    engine.generation)
        done = done or threading.Event()
        done.wait()
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
