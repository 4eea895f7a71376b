"""Parent side of the multi-replica serving plane: supervision and routing
(counterpart of ``mx_rcnn_tpu/serve/supervisor.py``).

Topology (``python -m mx_rcnn_tpu_torch.serve --replicas N``)::

    clients → router (this module, the parent process, TCP or Unix socket)
                ├── replica 0: python -m mx_rcnn_tpu_torch.serve
                │              --replica-index 0 --unix-socket ...
                ├── replica 1: ...
                └── replica N-1

Children are started with ``subprocess`` (fork and exec, never a bare
fork: a forked child cannot use a CUDA context its parent made; the
parent makes none).  Each child has its own CUDA context, on its device
group (``--replica-devices``) or, with one card, all on device 0.

* **Probes** — liveness (``/healthz``) and readiness (``/readyz``: warmup
  done, admissions open) per replica; a replica is routable once ready,
  and a slow starter is alive, never killed before ``start_timeout_s``.
* **Crash and hang** — ``poll()`` of the process catches a crash (kill
  -9); ``hang_probes`` consecutive probe failures catch a wedged process,
  which is then SIGKILLed.
* **Respawn** — exponential backoff per replica up to
  ``MAX_REPLICA_RESPAWNS``; past it the replica is FAILED with a flight
  dump, and when every replica has failed ``broken`` fires and the driver
  exits nonzero.
* **Retry once** — a request whose replica dies (transport error) or
  sheds (503) is retried once on another replica, under a token-bucket
  budget; with the budget spent, an early 503.
* **Rolling hot reload** — ``reload_to(target)`` rolls a checkpoint
  through the ready replicas one at a time (unroute → wait for the
  router's in-flight requests → ``POST /admin/reload`` → re-route), N-1
  serving throughout.  A replica's canary rejects bad weights; the roll
  then aborts and the replicas already swapped go back to the previous
  target (the boot checkpoint before the first roll, when the plane was
  given one).  The plane's generation only advances, and only on a whole
  roll; a respawned replica is caught up to it.

``poll(now=None)`` is the test surface: tests drive the state machine
with fake clocks, processes and probes; production runs it on the
monitor thread.  ``add_replica`` / ``retire_replica`` (the autoscaler's)
come with ROADMAP.md A.7.6.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.logger import logger
from mx_rcnn_tpu_torch.serve.frontend import (_TCPHTTPServer, _UnixHTTPServer,
                                              _Handler, unix_http_request,
                                              unix_http_request_raw)

# past this many respawns of one replica the failure is systemic (bad
# weights, a broken device, an OOM loop): respawning again would grind
MAX_REPLICA_RESPAWNS = 8

# replica states
STARTING = "starting"   # spawned, alive, not yet ready (warming)
READY = "ready"         # /readyz 200: routable unless mid-reload
BACKOFF = "backoff"     # died; waiting out the respawn backoff
FAILED = "failed"       # systemic limit crossed: no more respawns
STOPPED = "stopped"     # deliberate shutdown

# the package's parent directory: a child runs ``-m mx_rcnn_tpu_torch.serve``
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclass(frozen=True)
class SupervisorOptions:
    probe_interval_s: float = 1.0     # monitor poll period
    probe_timeout_s: float = 5.0      # one probe's HTTP timeout
    hang_probes: int = 3              # consecutive failures = hung
    start_timeout_s: float = 600.0    # spawn → ready ceiling (warmup)
    backoff_base_s: float = 0.5       # first respawn delay
    backoff_max_s: float = 30.0       # backoff ceiling
    max_respawns: int = MAX_REPLICA_RESPAWNS
    stable_s: float = 60.0            # ready this long resets the backoff
    retry_budget: int = 16            # token-bucket burst capacity
    retry_refill_per_s: float = 4.0   # sustained retry rate
    drain_timeout_s: float = 30.0     # router-side in-flight wait (reload)
    reload_timeout_s: float = 120.0   # one replica's /admin/reload ceiling


@dataclass
class ReplicaSpec:
    """How to launch one replica: its argv, Unix socket, index and extra
    environment (its device group)."""
    argv: List[str]
    sock: str
    index: int
    env: Dict[str, str] = field(default_factory=dict)


class ReplicaHandle:
    """The supervision state of one replica slot.  State changes under
    the supervisor's lock; probes and HTTP calls outside it."""

    def __init__(self, spec: ReplicaSpec):
        self.spec = spec
        self.proc = None
        self.state = BACKOFF       # spawn_all() brings it up
        self.routable = False
        self.reloading = False     # mid-swap: a cleared suspicion must not route
        self.generation = 0
        self.respawns = 0          # lifetime respawns (systemic limit)
        self.failures = 0          # consecutive failures (backoff input)
        self.probe_fails = 0       # consecutive probe misses (hang)
        self.inflight = 0          # router requests forwarded, unanswered
        self.spawn_t = 0.0
        self.ready_t = 0.0
        self.next_spawn_t = 0.0    # eligible to respawn from
        self.last_exit = None

    @property
    def index(self) -> int:
        return self.spec.index

    @property
    def pid(self):
        return getattr(self.proc, "pid", None)


class TokenBucket:
    """The retry budget: ``capacity`` tokens refilled at ``refill_per_s``,
    so a flapping replica pushes a bounded retry rate into the rest."""

    def __init__(self, capacity: int, refill_per_s: float):
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._tokens = float(capacity)
        self._t = None
        self._lock = threading.Lock()

    def take(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._t is not None and now > self._t:
                self._tokens = min(self.capacity, self._tokens
                                   + (now - self._t) * self.refill_per_s)
            self._t = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


def build_child_argv(argv: List[str], sock: str, index: int) -> List[str]:
    """The parent's argv (``argv[0]`` the program name) → one child's:
    ``python -m mx_rcnn_tpu_torch.serve``, the parent-only transport and
    watch flags stripped, everything else kept (model, checkpoint, engine
    knobs, ``--device``, ``--replicas`` for the telemetry world size),
    then the child's ``--unix-socket`` and ``--replica-index`` (which
    sends the child's ``main`` down the replica path)."""
    strip = {"--port": 1, "--host": 1, "--unix-socket": 1,
             "--watch-checkpoints": 1, "--watch-interval-s": 1,
             "--replica-devices": 1,
             # the router's and the capacity authority's flags, as the JAX
             # supervisor strips them
             "--fabric": 0, "--join": 1, "--advertise": 1,
             "--pool-file": 1, "--hedge-after-ms": 1,
             "--partition-floor": 1,
             "--autoscale": 0, "--autoscale-min": 1,
             "--autoscale-max": 1, "--autoscale-target-depth": 1,
             "--autoscale-interval-s": 1, "--autoscale-standby": 1}
    out = [sys.executable, "-m", "mx_rcnn_tpu_torch.serve"]
    i = 1
    while i < len(argv):
        arg = argv[i]
        name = arg.split("=", 1)[0]
        if name in strip:
            i += 1 + (0 if "=" in arg else strip[name])
            continue
        out.append(arg)
        i += 1
    out += ["--unix-socket", sock, "--replica-index", str(index)]
    return out


def replica_specs(argv: List[str], n: int, sock_dir: str,
                  devices: str = "") -> List[ReplicaSpec]:
    """One spec per replica: sockets under ``sock_dir``, device groups
    split from the ``--replica-devices`` semicolon list (group i → the
    child's ``MXR_REPLICA_DEVICES``)."""
    groups = [g.strip() for g in devices.split(";")] if devices else []
    specs = []
    for i in range(n):
        sock = os.path.join(sock_dir, f"replica_{i}.sock")
        env = {"MXR_REPLICA_INDEX": str(i)}
        if i < len(groups) and groups[i]:
            env["MXR_REPLICA_DEVICES"] = groups[i]
        specs.append(ReplicaSpec(build_child_argv(argv, sock, i),
                                 sock, i, env))
    return specs


class ReplicaSupervisor:
    """Owns N :class:`ReplicaHandle` slots.  ``spawn_fn(spec) → proc``,
    ``probe_fn(handle, path) → (status, doc)`` and ``reload_fn(handle,
    target) → (status, doc)`` are injectable for tests; the defaults are
    ``subprocess.Popen`` and Unix-socket HTTP.  ``boot_target``: the
    checkpoint the replicas boot from, as a reload target, the one a
    rejected first roll goes back to (None: a first roll rejected after a
    swap leaves the plane mixed, as the JAX supervisor does)."""

    def __init__(self, specs: List[ReplicaSpec],
                 opts: Optional[SupervisorOptions] = None,
                 spawn_fn: Optional[Callable] = None,
                 probe_fn: Optional[Callable] = None,
                 reload_fn: Optional[Callable] = None,
                 boot_target: Optional[dict] = None):
        self.opts = opts or SupervisorOptions()
        self.handles = [ReplicaHandle(s) for s in specs]
        self._spawn_fn = spawn_fn or self._default_spawn
        self._probe_fn = probe_fn or self._default_probe
        self._reload_fn = reload_fn or self._default_reload
        self._lock = threading.Lock()
        self._gen_lock = threading.Lock()
        self._roll_lock = threading.Lock()  # one rolling reload at a time
        self.generation = 0
        self._target: Optional[dict] = boot_target  # this generation's
        self._prev_target: Optional[dict] = None    # and the one before
        self.broken = threading.Event()  # every replica FAILED
        self.counters = {"spawn": 0, "respawn": 0, "systemic": 0,
                         "hang_kill": 0, "reload": 0, "reload_rollback": 0,
                         "retry": 0, "retry_ok": 0,
                         "retry_budget_exhausted": 0, "no_ready": 0,
                         "transport_error": 0}
        self.retry_bucket = TokenBucket(self.opts.retry_budget,
                                        self.opts.retry_refill_per_s)
        self._stop = threading.Event()
        self._wake = threading.Event()  # the router's nudge: poll soon
        self._thread: Optional[threading.Thread] = None

    # -- defaults (production wiring) --------------------------------------

    def _default_spawn(self, spec: ReplicaSpec):
        env = dict(os.environ, **spec.env)
        path = env.get("PYTHONPATH")
        env["PYTHONPATH"] = _ROOT + (os.pathsep + path if path else "")
        return subprocess.Popen(spec.argv, env=env)

    def _default_probe(self, handle: ReplicaHandle, path: str):
        return unix_http_request(handle.spec.sock, "GET", path,
                                 timeout=self.opts.probe_timeout_s)

    def _default_reload(self, handle: ReplicaHandle, target: dict):
        return unix_http_request(handle.spec.sock, "POST", "/admin/reload",
                                 target, timeout=self.opts.reload_timeout_s)

    # -- lifecycle ---------------------------------------------------------

    def spawn_all(self, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        for h in self.handles:
            self._spawn(h, now)

    def start(self) -> "ReplicaSupervisor":
        assert self._thread is None, "supervisor already started"
        self.spawn_all()

        def monitor():
            while not self._stop.is_set():
                self._wake.wait(self.opts.probe_interval_s)
                self._wake.clear()
                if self._stop.is_set():
                    return
                try:
                    self.poll()
                except Exception:  # noqa: BLE001 — supervision must survive
                    logger.exception("supervisor poll failed")

        self._thread = threading.Thread(target=monitor,
                                        name="replica-supervisor",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        self.sweep(graceful_timeout=timeout)

    def sweep(self, graceful_timeout: float = 5.0):
        """Leave no orphan: SIGTERM every live child, SIGKILL the ones
        still alive after ``graceful_timeout``, unlink their sockets.
        Safe to call again, and from atexit and signal paths."""
        with self._lock:
            handles = list(self.handles)
            for h in handles:
                h.state = STOPPED
                h.routable = False
        live = [h for h in handles
                if h.proc is not None and h.proc.poll() is None]
        for h in live:
            try:
                h.proc.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + graceful_timeout
        for h in live:
            try:
                h.proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    h.proc.kill()
                    h.proc.wait(timeout=5.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        for h in handles:
            try:
                os.unlink(h.spec.sock)
            except OSError:
                pass

    # -- state machine -----------------------------------------------------

    def _spawn(self, h: ReplicaHandle, now: float):
        h.proc = self._spawn_fn(h.spec)
        with self._lock:
            h.state = STARTING
            h.routable = False
            h.probe_fails = 0
            h.spawn_t = now
        self.counters["spawn"] += 1
        telemetry.get().counter("replica/spawn")
        logger.info("replica %d: spawned (pid %s)", h.index, h.pid)

    def _declare_dead(self, h: ReplicaHandle, now: float, reason: str,
                      kill: bool = False):
        """Crash, hang or start timeout → BACKOFF (or FAILED past the
        systemic limit)."""
        if kill and h.proc is not None and h.proc.poll() is None:
            try:
                h.proc.kill()
            except OSError:
                pass
            self.counters["hang_kill"] += 1
            telemetry.get().counter("replica/hang_kill")
        rc = h.proc.poll() if h.proc is not None else None
        with self._lock:
            h.routable = False
            h.last_exit = rc
            h.failures += 1
            h.probe_fails = 0
            # the next process boots on the original weights: forget the
            # generation so that _on_ready catches it up
            h.generation = 0
            if h.respawns >= self.opts.max_respawns:
                h.state = FAILED
                systemic = True
            else:
                h.state = BACKOFF
                delay = min(self.opts.backoff_base_s
                            * (2.0 ** (h.failures - 1)),
                            self.opts.backoff_max_s)
                h.next_spawn_t = now + delay
                systemic = False
        tel = telemetry.get()
        tel.counter("replica/down")
        tel.dump_flight("replica_down", index=h.index, cause=reason,
                        exit_code=rc, respawns=h.respawns)
        if systemic:
            self.counters["systemic"] += 1
            tel.counter("replica/systemic")
            tel.dump_flight("replica_systemic", index=h.index,
                            respawns=h.respawns, cause=reason)
            logger.error("replica %d: FAILED after %d respawns (%s) — "
                         "systemic, not respawning", h.index, h.respawns,
                         reason)
            if all(x.state == FAILED for x in self.handles):
                logger.error("every replica has failed — serving plane "
                             "is down")
                self.broken.set()
        else:
            logger.warning("replica %d: down (%s, exit %s) — respawn in "
                           "%.1fs (attempt %d/%d)", h.index, reason, rc,
                           max(0.0, h.next_spawn_t - now),
                           h.failures, self.opts.max_respawns)

    def _on_ready(self, h: ReplicaHandle, now: float):
        with self._lock:
            h.state = READY
            h.routable = True
            h.ready_t = now
            h.probe_fails = 0
        logger.info("replica %d: ready (%.1fs after spawn)", h.index,
                    now - h.spawn_t)
        # a respawned replica boots on the original weights: catch it up
        # to the plane's generation before clients see its boxes
        target = self._target
        if target is not None and h.generation < self.generation:
            self._reload_one(h, dict(target, generation=self.generation))

    def note_suspect(self, h: ReplicaHandle):
        """Router feedback: a forward to this replica failed in transport.
        Unroute it now and nudge the monitor; the process poll and the
        probes confirm or clear it."""
        with self._lock:
            if h.state == READY:
                h.routable = False
                h.probe_fails = max(h.probe_fails, 1)
        self._wake.set()

    def poll(self, now: Optional[float] = None):
        """One supervision step over every replica (the monitor thread's,
        every ``probe_interval_s``; tests call it with a fake clock).
        Probe I/O runs outside the lock."""
        now = time.monotonic() if now is None else now
        with self._lock:
            handles = list(self.handles)
        for h in handles:
            with self._lock:
                state = h.state
            if state in (FAILED, STOPPED):
                continue
            rc = h.proc.poll() if h.proc is not None else -1
            if state in (STARTING, READY) and rc is not None:
                self._declare_dead(h, now, reason=f"exit {rc}")
                continue
            if state == STARTING:
                status = self._try_probe(h, "/readyz")
                if status == 200:
                    self._on_ready(h, now)
                elif now - h.spawn_t > self.opts.start_timeout_s:
                    self._declare_dead(h, now, reason="start timeout",
                                       kill=True)
            elif state == READY:
                status = self._try_probe(h, "/healthz")
                if status == 200:
                    with self._lock:
                        h.probe_fails = 0
                        # stable long enough: forgive the backoff history
                        if h.failures and now - h.ready_t > self.opts.stable_s:
                            h.failures = 0
                        if (not h.routable and h.state == READY
                                and not h.reloading):
                            h.routable = True  # suspicion cleared
                else:
                    with self._lock:
                        h.probe_fails += 1
                        fails = h.probe_fails
                    if fails >= self.opts.hang_probes:
                        self._declare_dead(
                            h, now, kill=True,
                            reason=f"hung ({fails} probe timeouts)")
            elif state == BACKOFF and now >= h.next_spawn_t:
                with self._lock:
                    h.respawns += 1
                self.counters["respawn"] += 1
                telemetry.get().counter("replica/respawn")
                self._spawn(h, now)
        tel = telemetry.get()
        tel.gauge("replica/ready", self.ready_count())
        tel.gauge("replica/generation", self.generation)

    def _try_probe(self, h: ReplicaHandle, path: str) -> Optional[int]:
        try:
            status, _ = self._probe_fn(h, path)
            return status
        except Exception:  # noqa: BLE001 — any probe failure is a miss
            return None

    # -- routing support ---------------------------------------------------

    def ready_handles(self) -> List[ReplicaHandle]:
        with self._lock:
            return [h for h in self.handles
                    if h.state == READY and h.routable]

    def ready_count(self) -> int:
        return len(self.ready_handles())

    # -- rolling hot reload ------------------------------------------------

    def _wait_inflight_drained(self, h: ReplicaHandle) -> bool:
        deadline = time.monotonic() + self.opts.drain_timeout_s
        while h.inflight > 0:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        return True

    def _reload_one(self, h: ReplicaHandle, target: dict) -> bool:
        """Unroute → wait for the router's in-flight requests → swap →
        re-route.  The replica's own quiesce covers requests already in
        its engine; this covers the ones on the wire."""
        with self._lock:
            h.routable = False
            h.reloading = True
        try:
            self._wait_inflight_drained(h)
            try:
                status, doc = self._reload_fn(h, target)
            except Exception as e:  # noqa: BLE001 — a rejection
                status, doc = 0, {"error": f"{type(e).__name__}: {e}"}
            if status == 200:
                with self._lock:
                    h.generation = int(target.get("generation",
                                                  h.generation))
                self.counters["reload"] += 1
                telemetry.get().counter("replica/reload")
                logger.info("replica %d: generation %s live "
                            "(%s recompiles during swap)", h.index,
                            doc.get("generation"),
                            doc.get("recompiles_during_swap"))
                return True
            logger.error("replica %d: reload rejected (%s): %s", h.index,
                         status, doc.get("error", doc))
            return False
        finally:
            with self._lock:
                h.reloading = False
                if h.state == READY:
                    h.routable = True

    def reload_to(self, target: dict) -> bool:
        """Roll ``target`` through every ready replica one at a time, N-1
        serving throughout.  On a rejection: abort, take the replicas
        already swapped back to the previous target, leave the generation
        as it was.  The generation only advances, on a whole roll."""
        with self._roll_lock:
            with self._gen_lock:
                gen = self.generation + 1
            target = dict(target, generation=gen)
            swapped: List[ReplicaHandle] = []
            victims = [h for h in self.handles if h.state == READY]
            if not victims:
                logger.warning("reload_to: no ready replicas to roll")
                return False
            for h in victims:
                if h.state != READY:
                    continue  # died mid-roll; caught up on respawn
                if self._reload_one(h, target):
                    swapped.append(h)
                    continue
                # the replica rolled itself back; undo the swapped ones so
                # the plane stays on one generation
                self.counters["reload_rollback"] += 1
                tel = telemetry.get()
                tel.counter("replica/reload_rollback")
                tel.dump_flight("reload_roll_aborted", index=h.index,
                                generation=gen)
                prev = self._target
                if prev is not None:
                    back = dict(prev, generation=self.generation)
                    for hs in swapped:
                        self._reload_one(hs, back)
                elif swapped:
                    logger.error(
                        "reload_to: generation %d rejected on replica %d "
                        "after %d replica(s) swapped, and there is no "
                        "earlier target to roll back to — the plane is "
                        "mixed until the next good save", gen, h.index,
                        len(swapped))
                return False
            with self._gen_lock:
                self.generation = max(self.generation, gen)
            self._prev_target, self._target = self._target, target
            # a replica that respawned during the roll booted on the boot
            # weights and was not a victim: catch it up now
            for h in self.handles:
                if h.state == READY and h.generation < gen:
                    self._reload_one(h, target)
            telemetry.get().gauge("replica/generation", self.generation)
            logger.info("rolling reload complete: generation %d live on "
                        "%d replica(s)", self.generation, len(swapped))
            return True

    # -- introspection -----------------------------------------------------

    def metrics(self) -> dict:
        with self._lock:
            replicas = {
                str(h.index): {
                    "state": h.state, "pid": h.pid,
                    "routable": h.routable, "generation": h.generation,
                    "respawns": h.respawns, "inflight": h.inflight,
                    "probe_fails": h.probe_fails,
                    "last_exit": h.last_exit,
                } for h in self.handles}
        return {"generation": self.generation,
                "ready": self.ready_count(),
                "replicas": replicas,
                "counters": dict(self.counters),
                "broken": self.broken.is_set()}


class ReplicaRouter:
    """Round robin over the supervisor's ready replicas, retrying once on
    another replica under the retry budget.  Forwarding passes bytes
    through (no image re-encode); ``forward_fn(handle, method, path,
    body, timeout) → (status, bytes, ctype)`` is injectable."""

    def __init__(self, sup: ReplicaSupervisor, forward_fn=None,
                 timeout_s: float = 600.0):
        self.sup = sup
        self.timeout_s = timeout_s
        self._forward = forward_fn or self._default_forward
        self._rr = 0
        self._rr_lock = threading.Lock()

    def _default_forward(self, handle, method, path, body, timeout):
        return unix_http_request_raw(handle.spec.sock, method, path,
                                     body=body, timeout=timeout)

    def _pick(self, exclude=()):
        ready = [h for h in self.sup.ready_handles() if h not in exclude]
        if not ready:
            return None
        with self._rr_lock:
            h = ready[self._rr % len(ready)]
            self._rr += 1
        return h

    def route_predict(self, body: bytes) -> tuple:
        """One client request → (status, body_bytes, ctype).  A transport
        failure or a shed (503) retries once on another replica under the
        budget; no ready replica at all is an early 503."""
        sup = self.sup
        h = self._pick()
        if h is None:
            sup.counters["no_ready"] += 1
            telemetry.get().counter("replica/no_ready")
            return self._shed(f"no ready replicas "
                              f"(0/{len(sup.handles)} up) — retry with "
                              f"backoff")
        status, raw, ctype, transport_err = self._forward_to(h, body)
        if transport_err is None and status != 503:
            return status, raw, ctype
        if not sup.retry_bucket.take():
            sup.counters["retry_budget_exhausted"] += 1
            telemetry.get().counter("replica/retry_budget_exhausted")
            return self._shed("replica failed and the retry budget is "
                              "exhausted — retry with backoff")
        sup.counters["retry"] += 1
        telemetry.get().counter("replica/retry")
        h2 = self._pick(exclude=(h,))
        if h2 is None:
            if transport_err is not None:
                return self._shed(f"replica {h.index} failed "
                                  f"({transport_err}) and no alternate is "
                                  f"ready — retry with backoff")
            return status, raw, ctype  # a lone replica's own 503 stands
        status2, raw2, ctype2, err2 = self._forward_to(h2, body)
        if err2 is None:
            sup.counters["retry_ok"] += 1
            telemetry.get().counter("replica/retry_ok")
            return status2, raw2, ctype2
        return 502, json.dumps(
            {"error": f"both replicas failed: {transport_err or status}; "
                      f"then {err2}"}).encode(), "application/json"

    def _forward_to(self, h, body):
        """(status, raw, ctype, transport_error), counting the request in
        flight so that a rolling reload can wait it out."""
        h.inflight += 1
        try:
            status, raw, ctype = self._forward(h, "POST", "/predict",
                                               body, self.timeout_s)
            return status, raw, ctype, None
        except Exception as e:  # noqa: BLE001 — a dead or hung replica
            self.sup.counters["transport_error"] += 1
            telemetry.get().counter("replica/transport_error")
            self.sup.note_suspect(h)
            return None, b"", "", f"{type(e).__name__}: {e}"
        finally:
            h.inflight -= 1

    @staticmethod
    def _shed(msg: str) -> tuple:
        return (503, json.dumps({"error": msg}).encode(),
                "application/json")

    def metrics(self) -> dict:
        """The supervisor's state, each ready replica's own ``/metrics``
        (fetched live) and the counters summed over them."""
        out = {"supervisor": self.sup.metrics()}
        agg: Dict[str, float] = {}
        per = {}
        for h in self.sup.ready_handles():
            try:
                status, doc = unix_http_request(h.spec.sock, "GET",
                                                "/metrics", timeout=5.0)
            except Exception as e:  # noqa: BLE001 — a replica mid-death
                per[str(h.index)] = {"error": f"{type(e).__name__}: {e}"}
                continue
            if status == 200 and isinstance(doc, dict):
                per[str(h.index)] = doc
                for k, v in (doc.get("counters") or {}).items():
                    if isinstance(v, (int, float)):
                        agg[k] = agg.get(k, 0) + v
        out["engines"] = per
        out["aggregate_counters"] = agg
        out["generation"] = self.sup.generation
        return out


class _RouterHandler(_Handler):
    """The router's HTTP: ``/predict`` forwards bytes, ``/healthz`` is the
    router's liveness, ``/readyz`` means at least one replica is
    routable, ``/metrics`` the plane's view.  It has no engine."""
    router: ReplicaRouter = None

    def do_GET(self):
        path, _, _ = self.path.partition("?")
        sup = self.router.sup
        if path == "/healthz":
            self._reply(200, {"status": "ok", "role": "router",
                              "ready_replicas": sup.ready_count()})
        elif path == "/readyz":
            n = sup.ready_count()
            self._reply(200 if n > 0 else 503,
                        {"ready": n > 0, "ready_replicas": n,
                         "replicas": len(sup.handles),
                         "generation": sup.generation})
        elif path == "/metrics":
            self._reply(200, self.router.metrics())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/predict":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        status, raw, ctype = self.router.route_predict(body)
        self._reply_raw(status, raw, ctype or "application/json")


def make_router_server(router: ReplicaRouter, port: Optional[int] = None,
                       host: str = "127.0.0.1",
                       unix_socket: Optional[str] = None):
    """The plane's front door: ``make_server``'s transports, driven by a
    :class:`ReplicaRouter` instead of an engine."""
    if (port is None) == (unix_socket is None):
        raise ValueError("pass exactly one of port / unix_socket")

    class Handler(_RouterHandler):
        pass

    Handler.router = router
    if unix_socket is not None:
        return _UnixHTTPServer(unix_socket, Handler)
    return _TCPHTTPServer((host, port), Handler)
