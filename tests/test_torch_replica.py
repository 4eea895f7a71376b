"""The replica plane of the PyTorch port against the JAX package, on the
CPU.

* **Decisions on the same scripts.** The port's ``ReplicaSupervisor``,
  ``ReplicaRouter``, ``TokenBucket``, ``CheckpointWatcher``, the fault
  parsers and ``poison_params`` are run on the fake clocks, processes,
  probes, reloads and forwards of ``tests/test_replica.py`` beside the
  JAX objects, and every observable (states, generations, routability,
  backoff instants, counters, the reload calls and their targets, the
  statuses and bodies) must be equal.  ``build_child_argv`` and
  ``replica_specs`` equal the JAX ones after the program head (the port's
  children run ``python -m mx_rcnn_tpu_torch.serve``).
* **The checkpoint scan.** The port's ``scan_checkpoints`` on its npz
  layout (epoch files, ``.state.npz``, ``-steps/``, ``.tmp.`` files, an
  empty steps folder) picks the ``(epoch, consumed, kind)`` the JAX scan
  picks on the orbax folders of the same positions (each folder made with
  ``mkdir`` and one payload file, no orbax).
* **Real processes.** ``python -m mx_rcnn_tpu_torch.serve --replicas 2
  --watch-checkpoints P --device cpu`` on the tiny ResNet-50 config:
  a rolling reload under traffic with every reply 200, then kill -9 of
  replica 0 (``MXR_FAULT_REPLICA_KILL_AFTER``) retried on replica 1,
  replica 0 respawned and caught up to the plane's generation; and a
  corrupt checkpoint on replica 1 (``MXR_FAULT_REPLICA_CORRUPT_CKPT``)
  that aborts the roll and takes replica 0 back to the boot checkpoint.
  Every wait has a deadline.
"""

import dataclasses
import itertools
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.serve import replica as jrp
from mx_rcnn_tpu.serve import supervisor as jsv

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.eval.tester import Predictor
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.ops.postprocess import (decode_image_boxes,
                                               detections_to_records,
                                               per_class_nms)
from mx_rcnn_tpu_torch.serve import encode_image_payload, unix_http_request
from mx_rcnn_tpu_torch.serve import replica as rp
from mx_rcnn_tpu_torch.serve import supervisor as sv
from mx_rcnn_tpu_torch.train.checkpoint import epoch_path, save_params_npz
from mx_rcnn_tpu_torch.utils.convert_jax import random_params
from tests.test_torch_serve_slice import (TINY_FLAGS, assert_records_match,
                                          tiny)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = {"prefix": "/ck", "kind": "epoch", "epoch": 3, "consumed": 0}
CKPT_FLAGS = TINY_FLAGS + ["--cfg", "network__PIXEL_STDS=(127.0,127.0,127.0)"]
BOTH = (jsv, sv)


# -- fakes (tests/test_replica.py's, for either module) ---------------------

class FakeProc:
    """A ``subprocess.Popen`` stand-in the supervisor polls, kills and
    waits on."""

    _pids = itertools.count(1000)

    def __init__(self, stubborn=False):
        self.pid = next(FakeProc._pids)
        self.returncode = None
        self.killed = False
        self.terminated = False
        self.stubborn = stubborn  # ignores SIGTERM

    def poll(self):
        return self.returncode

    def die(self, rc=1):
        self.returncode = rc

    def kill(self):
        self.killed = True
        self.returncode = -9

    def terminate(self):
        self.terminated = True
        if not self.stubborn:
            self.returncode = -15

    def wait(self, timeout=None):
        if self.returncode is None:
            raise subprocess.TimeoutExpired("fake", timeout)
        return self.returncode


class Harness:
    """A supervisor of module ``mod`` over fake processes with scripted
    probes and reloads."""

    def __init__(self, mod, n=2, stubborn=False, specs=None, sup_kw=None,
                 **opt_kw):
        self.mod = mod
        self.procs = {}           # index -> [FakeProc, ...] (respawns)
        self.ready = {}           # index -> /readyz answers 200
        self.healthy = {}         # index -> /healthz status | Exception
        self.reloads = []         # (index, target) in call order
        self.reload_status = 200  # int, or callable(handle, target) -> int

        def spawn(spec):
            p = FakeProc(stubborn=stubborn)
            self.procs.setdefault(spec.index, []).append(p)
            return p

        def probe(handle, path):
            if path == "/readyz":
                return (200 if self.ready.get(handle.index) else 503), {}
            st = self.healthy.get(handle.index, 200)
            if isinstance(st, Exception):
                raise st
            return st, {}

        def reload_fn(handle, target):
            self.reloads.append((handle.index, dict(target)))
            st = (self.reload_status(handle, target)
                  if callable(self.reload_status) else self.reload_status)
            if st == 200:
                return st, {"generation": target.get("generation"),
                            "recompiles_during_swap": 0}
            return st, {"error": "canary failed: injected"}

        if specs is None:
            specs = [mod.ReplicaSpec(argv=["serve"], sock=f"/nonexistent/r{i}"
                                     f".sock", index=i) for i in range(n)]
        self.sup = mod.ReplicaSupervisor(
            specs, mod.SupervisorOptions(**opt_kw),
            spawn_fn=spawn, probe_fn=probe, reload_fn=reload_fn,
            **(sup_kw or {}))

    def proc(self, i):
        return self.procs[i][-1]

    def up(self, n=None, now=1.0):
        self.sup.spawn_all(now=0.0)
        for i in range(n if n is not None else len(self.sup.handles)):
            self.ready[i] = True
        self.sup.poll(now=now)

    def observe(self) -> dict:
        """Everything the scripts can see, the pids left out (they come
        from one counter)."""
        common = set(jsv.ReplicaSupervisor([]).counters) & set(
            sv.ReplicaSupervisor([]).counters)
        return {
            "generation": self.sup.generation,
            "ready": self.sup.ready_count(),
            "broken": self.sup.broken.is_set(),
            "counters": {k: v for k, v in self.sup.counters.items()
                         if k in common},
            "handles": [(h.state, h.routable, h.reloading, h.generation,
                         h.respawns, h.failures, h.probe_fails,
                         h.next_spawn_t, h.last_exit)
                        for h in self.sup.handles],
            "procs": {i: [(p.killed, p.terminated, p.returncode) for p in ps]
                      for i, ps in self.procs.items()},
            "reloads": self.reloads,
        }


# -- the scripts (tests/test_replica.py's), each returning what it saw ------

def s_ready_and_slow_starter(mod):
    hz = Harness(mod, n=2)
    hz.sup.spawn_all(now=0.0)
    hz.sup.poll(now=1.0)
    assert all(h.state == mod.STARTING for h in hz.sup.handles)
    hz.ready[0] = True
    hz.sup.poll(now=2.0)
    assert hz.sup.handles[0].state == mod.READY
    assert hz.sup.handles[1].state == mod.STARTING  # warming, alive
    return hz.observe()


def s_start_timeout(mod):
    hz = Harness(mod, n=1, start_timeout_s=10.0)
    hz.sup.spawn_all(now=0.0)
    hz.sup.poll(now=11.0)
    assert hz.proc(0).killed and hz.sup.handles[0].state == mod.BACKOFF
    return hz.observe()


def s_backoff_schedule(mod):
    hz = Harness(mod, n=1, backoff_base_s=0.5, backoff_max_s=4.0,
                 max_respawns=100)
    sup, h = hz.sup, hz.sup.handles[0]
    now = 0.0
    sup.spawn_all(now=now)
    delays = []
    for _ in range(5):
        hz.proc(0).die(9)
        sup.poll(now=now)
        delays.append(h.next_spawn_t - now)
        sup.poll(now=h.next_spawn_t - 0.01)
        assert h.state == mod.BACKOFF
        now = h.next_spawn_t
        sup.poll(now=now)
        assert h.state == mod.STARTING
    assert delays == [0.5, 1.0, 2.0, 4.0, 4.0]
    return dict(hz.observe(), delays=delays)


def s_systemic_limit(mod):
    hz = Harness(mod, n=1, backoff_base_s=0.0, max_respawns=2)
    sup, h = hz.sup, hz.sup.handles[0]
    sup.spawn_all(now=0.0)
    now = 0.0
    while h.state != mod.FAILED:
        hz.proc(0).die(9)
        now += 1.0
        sup.poll(now=now)
        now += 1.0
        sup.poll(now=now)
    sup.poll(now=now + 100.0)  # FAILED is terminal
    assert len(hz.procs[0]) == 3 and sup.broken.is_set()
    return hz.observe()


def s_hang_kill(mod):
    hz = Harness(mod, n=1, hang_probes=3)
    hz.up(now=1.0)
    hz.healthy[0] = TimeoutError("probe timed out")
    seen = []
    for t in (2.0, 3.0, 4.0):
        hz.sup.poll(now=t)
        seen.append((hz.sup.handles[0].state, hz.sup.handles[0].probe_fails))
    assert hz.proc(0).killed and hz.sup.counters["hang_kill"] == 1
    return dict(hz.observe(), seen=seen)


def s_stable_and_suspect(mod):
    hz = Harness(mod, n=1, stable_s=10.0)
    sup, h = hz.sup, hz.sup.handles[0]
    sup.spawn_all(now=0.0)
    hz.proc(0).die(1)
    sup.poll(now=0.0)
    sup.poll(now=h.next_spawn_t)
    hz.ready[0] = True
    sup.poll(now=1.0)
    sup.note_suspect(h)
    seen = [h.routable]
    sup.poll(now=2.0)
    seen.append((h.routable, h.failures))
    sup.poll(now=20.0)
    assert h.failures == 0
    return dict(hz.observe(), seen=seen)


def s_roll_one_at_a_time(mod):
    hz = Harness(mod, n=2)
    hz.up()
    assert hz.sup.reload_to(dict(TARGET))
    assert [i for i, _ in hz.reloads] == [0, 1]
    assert hz.sup.reload_to(dict(TARGET, epoch=4))
    assert hz.sup.generation == 2
    return hz.observe()


def s_roll_rejected_rolls_back(mod):
    hz = Harness(mod, n=2)
    hz.up()
    assert hz.sup.reload_to(dict(TARGET))
    hz.reload_status = (
        lambda h, t: 409 if (h.index == 1 and t["epoch"] == 4) else 200)
    assert not hz.sup.reload_to(dict(TARGET, epoch=4))
    assert hz.sup.generation == 1
    assert hz.reloads[-1] == (0, dict(TARGET, generation=1))
    return hz.observe()


def s_first_roll_rejected_without_target(mod):
    hz = Harness(mod, n=2)
    hz.up()
    hz.reload_status = lambda h, t: 409 if h.index == 1 else 200
    assert not hz.sup.reload_to(dict(TARGET))
    return hz.observe()  # replica 0 stays swapped: the plane is mixed


def s_crash_mid_roll_catches_up(mod):
    hz = Harness(mod, n=2, backoff_base_s=0.5)
    hz.up()

    def die_during_first_swap(h, target):
        if h.index == 0 and not hz.proc(1).poll():
            hz.proc(1).die(9)
            hz.sup.poll(now=10.0)
        return 200

    hz.reload_status = die_during_first_swap
    assert hz.sup.reload_to(dict(TARGET))
    h1 = hz.sup.handles[1]
    hz.sup.poll(now=h1.next_spawn_t)
    hz.sup.poll(now=h1.next_spawn_t + 1.0)
    assert h1.generation == 1
    return hz.observe()


def s_respawn_catches_up(mod):
    hz = Harness(mod, n=2, backoff_base_s=0.5)
    hz.up()
    assert hz.sup.reload_to(dict(TARGET))
    hz.proc(1).die(9)
    hz.sup.poll(now=5.0)
    h1 = hz.sup.handles[1]
    hz.sup.poll(now=h1.next_spawn_t)
    hz.sup.poll(now=h1.next_spawn_t + 1.0)
    assert h1.state == mod.READY and h1.generation == 1
    assert hz.reloads[-1] == (1, dict(TARGET, generation=1))
    return hz.observe()


def _router(mod, hz, fwd):
    return mod.ReplicaRouter(hz.sup, forward_fn=fwd)


def s_router_no_ready(mod):
    hz = Harness(mod, n=2)  # never spawned: nothing routable
    out = _router(mod, hz, None).route_predict(b"{}")
    return dict(hz.observe(), out=out)


def s_router_transport_retry(mod):
    hz = Harness(mod, n=2)
    hz.up()
    calls = []

    def fwd(h, method, path, body, timeout):
        calls.append(h.index)
        if len(calls) == 1:
            raise ConnectionRefusedError("replica died")
        return 200, b'{"ok":1}', "application/json"

    out = _router(mod, hz, fwd).route_predict(b"{}")
    assert out[0] == 200 and calls[0] != calls[1]
    return dict(hz.observe(), out=out, calls=calls)


def s_router_shed_retry(mod):
    hz = Harness(mod, n=2)
    hz.up()
    calls = []

    def fwd(h, method, path, body, timeout):
        calls.append(h.index)
        if len(calls) == 1:
            return 503, b'{"error":"draining"}', "application/json"
        return 200, b'{"ok":1}', "application/json"

    out = _router(mod, hz, fwd).route_predict(b"{}")
    return dict(hz.observe(), out=out, calls=calls)


def s_router_budget_spent(mod):
    hz = Harness(mod, n=2)
    hz.up()
    hz.sup.retry_bucket = mod.TokenBucket(0, 0.0)

    def fwd(h, method, path, body, timeout):
        raise ConnectionRefusedError("dead")

    out = _router(mod, hz, fwd).route_predict(b"{}")
    assert out[0] == 503 and b"retry budget" in out[1]
    return dict(hz.observe(), out=out)


def s_router_both_fail(mod):
    hz = Harness(mod, n=2)
    hz.up()

    def fwd(h, method, path, body, timeout):
        raise ConnectionRefusedError("dead")

    out = _router(mod, hz, fwd).route_predict(b"{}")
    assert out[0] == 502 and b"both replicas failed" in out[1]
    return dict(hz.observe(), out=out)


def s_router_lone_503(mod):
    hz = Harness(mod, n=1)
    hz.up()
    out = _router(mod, hz, lambda *a: (503, b'{"error":"queue full"}',
                                       "application/json")
                  ).route_predict(b"{}")
    assert out == (503, b'{"error":"queue full"}', "application/json")
    return dict(hz.observe(), out=out)


def s_router_round_robin_and_retry_flow(mod):
    """A longer flow: twelve requests over two replicas, the second dying
    at request 5 and the monitor noticing at 8; the budget at 2 tokens
    and 1 a second."""
    hz = Harness(mod, n=2, retry_budget=2, retry_refill_per_s=1.0)
    hz.up()
    dead = {"v": False}

    def fwd(h, method, path, body, timeout):
        if h.index == 1 and dead["v"]:
            raise ConnectionResetError("gone")
        return 200, json.dumps({"r": h.index}).encode(), "application/json"

    router = _router(mod, hz, fwd)
    outs = []
    for i in range(12):
        if i == 5:
            dead["v"] = True
            hz.proc(1).die(9)
        if i == 8:
            hz.sup.poll(now=3.0)
        outs.append(router.route_predict(b"{}"))
    return dict(hz.observe(), outs=outs)


SCRIPTS = [s_ready_and_slow_starter, s_start_timeout, s_backoff_schedule,
           s_systemic_limit, s_hang_kill, s_stable_and_suspect,
           s_roll_one_at_a_time, s_roll_rejected_rolls_back,
           s_first_roll_rejected_without_target,
           s_crash_mid_roll_catches_up, s_respawn_catches_up,
           s_router_no_ready, s_router_transport_retry, s_router_shed_retry,
           s_router_budget_spent, s_router_both_fail, s_router_lone_503,
           s_router_round_robin_and_retry_flow]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__[2:])
def test_supervisor_and_router_decide_as_jax(script):
    want, got = (script(mod) for mod in BOTH)
    assert got == want


def test_sweep_terminates_kills_and_unlinks(tmp_path):
    seen = []
    for mod in BOTH:
        specs = [mod.ReplicaSpec(argv=["x"], sock=str(tmp_path / f"r{i}.sock"),
                                 index=i) for i in range(2)]
        hz = Harness(mod, specs=specs, stubborn=True)
        hz.up()
        for s in specs:
            open(s.sock, "w").close()
        hz.sup.sweep(graceful_timeout=0.0)
        assert not any(os.path.exists(s.sock) for s in specs)
        hz.sup.sweep(graceful_timeout=0.0)  # again: a no-op
        seen.append(hz.observe())
    assert seen[0] == seen[1]
    assert all(p == [(True, True, -9)] for p in seen[1]["procs"].values())


def test_boot_target_takes_a_rejected_first_roll_back():
    """The port's ``boot_target`` (the checkpoint the plane booted from):
    a first roll rejected on replica 1 takes replica 0 back to it, where
    the JAX supervisor, which has no earlier target, leaves the plane
    mixed (``s_first_roll_rejected_without_target``)."""
    boot = dict(TARGET, epoch=1)
    hz = Harness(sv, n=2, sup_kw={"boot_target": boot})
    hz.up()
    hz.reload_status = lambda h, t: 409 if (h.index == 1
                                            and t["epoch"] == 3) else 200
    assert not hz.sup.reload_to(dict(TARGET))
    assert hz.reloads == [(0, dict(TARGET, generation=1)),
                          (1, dict(TARGET, generation=1)),
                          (0, dict(boot, generation=0))]
    assert hz.sup.generation == 0
    assert [h.generation for h in hz.sup.handles] == [0, 0]
    assert hz.sup.counters["reload_rollback"] == 1
    assert hz.sup.ready_count() == 2


def test_token_bucket_as_jax():
    script = [(0.0, 5)] + [(t, 2) for t in (0.5, 1.0, 1.2, 3.0, 100.0)]
    seen = []
    for mod in BOTH:
        tb = mod.TokenBucket(3, 2.0)
        seen.append([tb.take(now=t) for t, n in script for _ in range(n)])
    assert seen[0] == seen[1]
    assert seen[1][:5] == [True, True, True, False, False]


ARGV = ["serve", "--network", "resnet101", "--prefix", "m/e2e", "--epoch",
        "3", "--port", "8000", "--host=0.0.0.0", "--replicas", "2",
        "--watch-checkpoints", "m/e2e", "--watch-interval-s", "2",
        "--replica-devices", "0;1", "--serve-batch", "4", "--serve-e2e",
        "--device", "cpu", "--unix-socket=/x.sock"]


def test_build_child_argv_and_specs_as_jax(tmp_path):
    got = sv.build_child_argv(ARGV, "/tmp/r0.sock", 0)
    want = jsv.build_child_argv(ARGV, "/tmp/r0.sock", 0)
    assert got[:3] == [sys.executable, "-m", "mx_rcnn_tpu_torch.serve"]
    assert want[:2] == [sys.executable, "serve"]
    assert got[3:] == want[2:]
    assert "--device" in got and "--watch-checkpoints" not in got
    assert got[-4:] == ["--unix-socket", "/tmp/r0.sock", "--replica-index",
                        "0"]
    for devices in ("0,1;2,3", "", "4"):
        port = sv.replica_specs(ARGV, 3, str(tmp_path), devices=devices)
        ref = jsv.replica_specs(ARGV, 3, str(tmp_path), devices=devices)
        assert [(s.sock, s.index, s.env, s.argv[3:]) for s in port] == \
            [(s.sock, s.index, s.env, s.argv[2:]) for s in ref]


def test_replica_devices_become_cuda_visible_devices():
    env = {"MXR_REPLICA_DEVICES": "2,3"}
    assert rp.apply_replica_devices(env) == "2,3"
    assert env["CUDA_VISIBLE_DEVICES"] == "2,3"
    env = {"CUDA_VISIBLE_DEVICES": "0"}
    assert rp.apply_replica_devices(env) is None
    assert env == {"CUDA_VISIBLE_DEVICES": "0"}


def test_watcher_as_jax():
    """Dedup, the bad list and never backward, on one script of scanned
    targets and accept / reject answers."""
    script = [(1, True), (1, True), (2, True), (2, True), (3, False),
              (3, True), (4, True), (2, True), (5, False), (4, True),
              (6, True)]
    seen = []
    for mod in (jrp, rp):
        cur = {"t": None}
        calls = []

        def reload_fn(target):
            calls.append(dict(target))
            return cur["ok"]

        w = mod.CheckpointWatcher("p", reload_fn,
                                  scan_fn=lambda prefix: cur["t"])
        cur["t"] = None
        out = [w.prime(), w.poll_once()]
        cur["t"] = {"prefix": "p", "kind": "epoch", "epoch": 0,
                    "consumed": 0}
        w.prime()
        for epoch, ok in script:
            cur["t"] = dict(cur["t"], epoch=epoch)
            cur["ok"] = ok
            out.append(w.poll_once())
        seen.append((out, calls))
    assert seen[0] == seen[1]
    assert [c["epoch"] for c in seen[1][1]] == [1, 2, 3, 4, 5, 6]


ENVS = [
    {},
    {"MXR_FAULT_REPLICA_KILL_AFTER": "0:5",
     "MXR_FAULT_REPLICA_HANG_AFTER": "1:3",
     "MXR_FAULT_REPLICA_SLOW_START_S": "1:2.5",
     "MXR_FAULT_REPLICA_CORRUPT_CKPT": "2"},
    {"MXR_FAULT_REPLICA_KILL_AFTER": "0:9,1:4, 2:7 ,"},
    {"MXR_FAULT_REPLICA_KILL_AFTER": "banana,1:6",
     "MXR_FAULT_REPLICA_CORRUPT_CKPT": "0,1"},
    {"MXR_FAULT_NET_DROP": "1:4", "MXR_FAULT_NET_RESET": "0:3-6,2:3",
     "MXR_FAULT_NET_DELAY_MS": "2:250,0:"},
    {"MXR_FAULT_NET_RESET": "1:5", "MXR_FAULT_NET_DROP": "0"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_fault_env_parsing_as_jax(env):
    for index in range(3):
        fields = ("kill_after", "hang_after", "slow_start_s", "corrupt_ckpt")
        got, want = (mod.ReplicaFaults(index, env=env) for mod in (rp, jrp))
        assert [getattr(got, f) for f in fields] == \
            [getattr(want, f) for f in fields]
        fields = ("drop_after", "delay_ms", "reset_from", "reset_to",
                  "enabled")
        got, want = (mod.NetFaults(index, env=env) for mod in (rp, jrp))
        assert [getattr(got, f) for f in fields] == \
            [getattr(want, f) for f in fields]
        for name in (rp.ENV_KILL_AFTER, rp.ENV_NET_RESET):
            assert rp._fault_value(name, index, env) == \
                jrp._fault_value(name, index, env)


def test_poison_params_as_jax():
    nested = {"a": {"w": np.ones((2, 2), np.float32),
                    "h": np.full(3, 2.0, np.float16)},
              "idx": np.arange(3, dtype=np.int32), "n": 2, "x": 1.5}
    flat = {"backbone/conv1/kernel": np.ones((3, 3, 3, 8), np.float32),
            "step": np.int64(4)}
    for params in (nested, flat):
        got, want = rp.poison_params(params), jrp.poison_params(params)
        got_l = jsv_leaves(got)
        want_l = jsv_leaves(want)
        assert [k for k, _ in got_l] == [k for k, _ in want_l]
        for (_, g), (_, w) in zip(got_l, want_l):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            assert np.asarray(g).dtype == np.asarray(w).dtype
    assert not np.isnan(nested["a"]["w"]).any()  # the input untouched


def jsv_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in jsv_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix, tree)]


# -- the checkpoint scan on both layouts -------------------------------------

SCANS = {
    "empty": {},
    "epochs_and_in_progress": {"epochs": [1, 2], "tmp_epochs": [3]},
    "a_step_beyond": {"epochs": [1, 2], "steps": [(2, 5), (1, 9)]},
    "a_finished_epoch_beats_its_steps": {"epochs": [1, 2, 3],
                                         "steps": [(2, 5), (2, 900)]},
    "steps_only": {"steps": [(1, 7), (1, 9)], "tmp_steps": [(1, 12)]},
    "state_files_and_empty_steps": {"epochs": [4], "state_only": [5],
                                    "empty_steps": True},
    "in_progress_only": {"tmp_epochs": [1], "tmp_steps": [(0, 3)],
                         "empty_steps": True},
    "big_keys": {"epochs": [12], "steps": [(12, 123456)]},
}


def jax_layout(root, epochs=(), steps=(), tmp_epochs=(), tmp_steps=(),
               state_only=(), empty_steps=False):
    """The orbax folders of these positions, each an int-named folder with
    one payload file; a save in progress is orbax's tmp folder."""
    root.mkdir(parents=True)

    def committed(path):
        path.mkdir()
        (path / "params.npz").write_bytes(b"x")

    for e in epochs:
        committed(root / str(e))
    for e in tmp_epochs:
        (root / f"{e}.orbax-checkpoint-tmp-7").mkdir()
    if steps or tmp_steps or empty_steps:
        (root / "steps").mkdir()
    for e, c in steps:
        committed(root / "steps" / str(e * 10 ** 7 + c))
    for e, c in tmp_steps:
        (root / "steps" / f"{e * 10 ** 7 + c}.orbax-checkpoint-tmp-7").mkdir()
    return str(root)


def port_layout(folder, epochs=(), steps=(), tmp_epochs=(), tmp_steps=(),
                state_only=(), empty_steps=False):
    """``CheckpointManager``'s files of these positions (names only: the
    scan reads none): each epoch's ``.npz`` and ``.state.npz``, step
    files, and ``atomic_savez``'s temporary names of saves in progress."""
    folder.mkdir(parents=True)
    prefix = folder / "e2e"
    for e in epochs:
        (folder / f"e2e-{e:04d}.npz").write_bytes(b"x")
        (folder / f"e2e-{e:04d}.state.npz").write_bytes(b"x")
    for e in tmp_epochs:
        (folder / f"e2e-{e:04d}.npz.tmp.41.42").write_bytes(b"x")
    for e in state_only:
        (folder / f"e2e-{e:04d}.state.npz").write_bytes(b"x")
    steps_dir = folder / "e2e-steps"
    if steps or tmp_steps or empty_steps:
        steps_dir.mkdir()
    for e, c in steps:
        (steps_dir / f"step-{e * 10 ** 7 + c:012d}.npz").write_bytes(b"x")
    for e, c in tmp_steps:
        (steps_dir / f"step-{e * 10 ** 7 + c:012d}.npz.tmp.41.42"
         ).write_bytes(b"x")
    return str(prefix)


@pytest.mark.parametrize("case", sorted(SCANS))
def test_scan_checkpoints_picks_the_jax_position(tmp_path, case):
    spec = SCANS[case]
    want = jrp.scan_checkpoints(jax_layout(tmp_path / "orbax", **spec))
    prefix = port_layout(tmp_path / "port", **spec)
    got = rp.scan_checkpoints(prefix)
    if want is None:
        assert got is None
    else:
        assert got == dict(want, prefix=prefix)
    assert rp.scan_checkpoints(str(tmp_path / "missing" / "e2e")) is None


# -- real processes ------------------------------------------------------------

def wait_for(cond, what, timeout=180.0):
    deadline = time.monotonic() + timeout
    while True:
        try:
            if cond():
                return
        except OSError:
            pass
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.1)


def router_metrics(sock):
    status, doc = unix_http_request(sock, "GET", "/metrics", timeout=30)
    assert status == 200
    return doc


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Two seeded generations of the tiny model, the port's records of the
    second one in host-NMS mode on ``IMAGE`` (row 0)."""
    cfg = tiny(generate_config)
    model = build_model(cfg)
    gens = [random_params(model, seed=s) for s in (0, 1)]
    pred = Predictor(model, gens[1], cfg, device="cpu")
    from mx_rcnn_tpu_torch.data.image import stage_raw_to_bucket
    s, hw, r, info = stage_raw_to_bucket(IMAGE, cfg.tpu.SCALES[0], 16)
    batch = pred.batch_put({"images": np.stack([s, s]),
                            "raw_hw": np.stack([hw, hw]),
                            "prep_ratio": np.stack([r, r]),
                            "im_info": np.stack([info, info])})
    with torch.inference_mode():
        rois, valid, scores, deltas, _ = [
            t.numpy() for t in pred.predict(batch["images"],
                                            batch["im_info"])]
    te = cfg.TEST
    boxes = decode_image_boxes(rois[0], deltas[0], info)
    records = detections_to_records(per_class_nms(
        scores[0], boxes, valid[0], cfg.NUM_CLASSES, te.THRESH, te.NMS,
        te.MAX_PER_IMAGE))
    assert records
    return gens, records


IMAGE = np.random.RandomState(5).randint(0, 255, (70, 110, 3), np.uint8)


def start_plane(tmp_path, gens, env):
    prefix = str(tmp_path / "ck" / "c4")
    save_params_npz(epoch_path(prefix, 1), gens[0])
    sock = str(tmp_path / "router.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.serve", "--device", "cpu",
         "--replicas", "2", "--prefix", prefix, "--epoch", "1",
         "--watch-checkpoints", prefix, "--watch-interval-s", "0.2",
         "--unix-socket", sock, "--serve-batch", "2", "--max-delay-ms", "5"]
        + CKPT_FLAGS,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(os.environ, OMP_NUM_THREADS="2", **env))
    wait_for(lambda: proc.poll() is not None or unix_http_request(
        sock, "GET", "/readyz", timeout=5)[1]["ready_replicas"] == 2,
        "both replicas ready")
    assert proc.poll() is None, proc.stdout.read().decode()
    return proc, prefix, sock


def stop_plane(proc, pids):
    try:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for pid in pids:  # the children were swept
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    return rc


def predict(sock):
    return unix_http_request(sock, "POST", "/predict",
                             encode_image_payload(IMAGE), timeout=120)


def test_plane_rolling_reload_then_kill9_failover(tmp_path, weights):
    """A rolling reload to epoch 2 under one client's traffic: every reply
    200, generation 1, no first dispatch in either replica; then, under
    four clients, replica 0 kills itself after its 12th reply: a request
    that finds it dead is retried on replica 1, and replica 0 is respawned
    and caught up to generation 1.  SIGTERM: exit 0, no child left."""
    gens, records = weights
    proc, prefix, sock = start_plane(
        tmp_path, gens, {rp.ENV_KILL_AFTER: "0:12"})
    pids = []
    try:
        first = router_metrics(sock)["supervisor"]["replicas"]
        pids += [first[i]["pid"] for i in ("0", "1")]
        statuses, stop = [], threading.Event()

        def client(cap):
            while not stop.is_set() and len(statuses) < cap:
                statuses.append(predict(sock)[0])

        # at most 10 requests: replica 0 stays below its 12
        th = threading.Thread(target=client, args=(10,), daemon=True)
        th.start()
        wait_for(lambda: len(statuses) >= 2, "traffic before the save")
        save_params_npz(epoch_path(prefix, 2), gens[1])
        wait_for(lambda: unix_http_request(sock, "GET", "/readyz")[1][
            "generation"] == 1, "the rolling reload")
        stop.set()
        th.join(120)
        assert not th.is_alive()
        assert statuses and set(statuses) == {200}, statuses
        m = router_metrics(sock)
        c = m["supervisor"]["counters"]
        assert (c["reload"], c["reload_rollback"]) == (2, 0)
        for doc in m["engines"].values():
            assert doc["generation"] == 1
            assert doc["reload"]["recompiles_during_swap"] == 0
            assert doc["counters"]["recompiles"] == 2
        status, resp = predict(sock)
        assert status == 200
        assert_records_match(resp["detections"], records, "generation 1")

        # the kill: four clients until a request finds replica 0 dead (its
        # reply sent, the next ones sent at once: one lands on the corpse
        # before the monitor's next poll)
        statuses.clear()
        stop.clear()
        clients = [threading.Thread(target=client, args=(80,), daemon=True)
                   for _ in range(4)]
        for t in clients:
            t.start()
        wait_for(lambda: router_metrics(sock)["supervisor"]["counters"][
            "transport_error"] or len(statuses) >= 80, "the kill")
        stop.set()
        for t in clients:
            t.join(120)
            assert not t.is_alive()
        c = router_metrics(sock)["supervisor"]["counters"]
        assert c["transport_error"] >= 1 and c["retry_ok"] >= 1, c
        assert set(statuses) <= {200, 503}, statuses
        assert statuses.count(200) >= len(statuses) - 1, statuses

        def caught_up():
            rep = router_metrics(sock)["supervisor"]["replicas"]["0"]
            return (rep["state"] == "ready" and rep["routable"]
                    and rep["respawns"] == 1 and rep["generation"] == 1)

        wait_for(caught_up, "replica 0 respawned and caught up")
        m = router_metrics(sock)
        assert m["supervisor"]["ready"] == 2
        assert m["engines"]["0"]["generation"] == 1
        assert m["engines"]["0"]["reload"]["target"] == [2, 0, "epoch"]
        pids.append(m["supervisor"]["replicas"]["0"]["pid"])
        for _ in range(2):  # both replicas: generation 1's records
            status, resp = predict(sock)
            assert status == 200
            assert_records_match(resp["detections"], records,
                                 "after the respawn")
    finally:
        rc = stop_plane(proc, pids)
    assert rc == 0, proc.stdout.read().decode()[-3000:]


def test_plane_corrupt_checkpoint_aborts_the_roll(tmp_path, weights):
    """``MXR_FAULT_REPLICA_CORRUPT_CKPT`` on replica 1: replica 0 swaps to
    epoch 2, replica 1's canary rejects it, the roll aborts and replica 0
    goes back to the boot checkpoint (epoch 1); the plane's generation
    stays 0 and it serves on."""
    gens, _ = weights
    proc, prefix, sock = start_plane(
        tmp_path, gens, {rp.ENV_CORRUPT_CKPT: "1"})
    pids = []
    try:
        m = router_metrics(sock)
        pids += [m["supervisor"]["replicas"][i]["pid"] for i in ("0", "1")]
        status, before = predict(sock)
        assert status == 200
        save_params_npz(epoch_path(prefix, 2), gens[1])
        wait_for(lambda: router_metrics(sock)["supervisor"]["counters"][
            "reload_rollback"] == 1, "the aborted roll")
        wait_for(lambda: router_metrics(sock)["supervisor"]["ready"] == 2,
                 "both replicas routable again")
        m = router_metrics(sock)
        sup = m["supervisor"]
        assert sup["generation"] == 0 and sup["counters"]["reload"] == 2
        assert [sup["replicas"][i]["generation"] for i in "01"] == [0, 0]
        r0, r1 = m["engines"]["0"]["reload"], m["engines"]["1"]["reload"]
        assert r0["ok"] and r0["target"] == [1, 0, "epoch"]
        assert not r1["ok"] and "canary failed" in r1["error"]
        for _ in range(4):  # both replicas: the boot weights' records
            status, resp = predict(sock)
            assert status == 200
            assert_records_match(resp["detections"], before["detections"],
                                 "after the rollback")
    finally:
        rc = stop_plane(proc, pids)
    assert rc == 0, proc.stdout.read().decode()[-3000:]


class _StubFuture:
    queue_wait_s = 0.001
    batch_row = 0

    def result(self, timeout=None):
        return [{"cls": 1, "score": 0.5, "bbox": [0.0, 0.0, 1.0, 1.0]}]


class _StubEngine:
    def submit(self, img, deadline_ms=None):
        return _StubFuture()

    def queue_depth(self):
        return 0


def test_frontend_fault_hooks(tmp_path):
    """``gate`` before every request, ``net_faults`` below it (here the
    reset of ``/predict`` #1: the client sees a broken connection, the
    engine nothing), ``request_hook`` after each ``/predict`` reply."""
    from mx_rcnn_tpu_torch.serve import make_server

    seen = []
    net = rp.NetFaults(0, env={rp.ENV_NET_RESET: "0:1-1"})
    assert net.enabled and (net.reset_from, net.reset_to) == (1, 1)
    sock = str(tmp_path / "f.sock")
    server = make_server(_StubEngine(), unix_socket=sock,
                         gate=lambda: seen.append("gate"),
                         request_hook=lambda st: seen.append(st),
                         net_faults=net)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        body = encode_image_payload(np.zeros((4, 4, 3), np.uint8))
        with pytest.raises((ConnectionError, OSError)):
            unix_http_request(sock, "POST", "/predict", body, timeout=10)
        assert seen == ["gate"]
        status, doc = unix_http_request(sock, "POST", "/predict", body,
                                        timeout=10)
        assert status == 200 and doc["detections"]
        assert seen == ["gate", "gate", 200]
        assert unix_http_request(sock, "GET", "/healthz")[0] == 200
        assert unix_http_request(sock, "POST", "/predict", {"x": 1})[0] == 400
        # a malformed payload is a 400, counted by the hook; /admin/reload
        # without a reloader is a 404 and no /predict
        assert unix_http_request(sock, "POST", "/admin/reload", {})[0] == 404
        assert seen == ["gate", "gate", 200, "gate", "gate", 400, "gate"]
    finally:
        server.shutdown()
        server.server_close()
