"""The port's fault-tolerance pieces (``train/resilience.py``,
``train/checkpoint.py:CheckpointManager``, the sentinel and the ``skip``
policy of ``train/train_step.py``) against the JAX package, on the CPU.

* ``ResilienceOptions``' validation and ``from_args``, the drivers' flags
  and defaults, the step keys, ``retry_io``'s delays and final raise
  (``time.sleep`` patched), ``PreemptionGuard``'s first and second signal
  and its inert form off the main thread, ``dump_nan_diagnostics``' keys
  and ``inject_roidb_faults``' records: each equal to the JAX package's.
* ``CheckpointManager``: parameters, momentum, step and generator state
  round-trip bitwise; the window of two step checkpoints; a save killed
  between the write and the rename leaves the previous checkpoint
  loadable; ``latest_resume_point`` answers as the JAX manager does on
  the same sequences of saves; a missing epoch lists those present; the
  epoch ``.npz`` is byte for byte the earlier ``save_params_npz`` file and
  loads in the JAX ``load_params_npz``.
* The step under ``skip`` against the JAX ``make_train_step(sentinel=True,
  skip_nonfinite=True)`` on the tiny detector of ``tests/test_fit_resume.py``
  (ResNet-50, 64×96, ``MAX_GT=4``, float32): a NaN batch reports
  ``all_finite`` 0 in both and keeps every parameter bitwise (the port its
  momentum too); a finite batch reports 1 and gives the port's update
  without the sentinel, bitwise.  One image a step.

Tolerances: none; every comparison is exact.
"""

import argparse
import dataclasses
import json
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.tools import common as j_common
from mx_rcnn_tpu.train import checkpoint as j_checkpoint
from mx_rcnn_tpu.train import create_train_state as j_create_train_state
from mx_rcnn_tpu.train import make_train_step as j_make_train_step
from mx_rcnn_tpu.train import resilience as j_res
from mx_rcnn_tpu.train.train_step import _all_finite as j_all_finite

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.tools import common
from mx_rcnn_tpu_torch.train import checkpoint
from mx_rcnn_tpu_torch.train import resilience as res
from mx_rcnn_tpu_torch.train.optim import (export_momentum, fixed_param_mask,
                                          import_momentum)
from mx_rcnn_tpu_torch.train.train_step import (_all_finite,
                                                create_train_state,
                                                make_train_step)
from mx_rcnn_tpu_torch.utils import convert_jax
from tests.test_torch_train_step import flatten

torch.set_num_threads(2)

B, H, W, G = 1, 64, 96, 4


def tiny(gen):
    """``tests/test_fit_resume.py:tiny_cfg``, float32."""
    cfg = gen("resnet50", "PascalVOC", TRAIN__RPN_PRE_NMS_TOP_N=200,
              TRAIN__RPN_POST_NMS_TOP_N=32, TRAIN__BATCH_ROIS=16)
    net = dataclasses.replace(cfg.network, ANCHOR_SCALES=(2, 4),
                              PIXEL_STDS=(127.0, 127.0, 127.0))
    tpu = dataclasses.replace(cfg.tpu, SCALES=((H, W),), MAX_GT=G,
                              COMPUTE_DTYPE="float32")
    return cfg.replace(network=net, tpu=tpu)


# -- options, flags and keys ---------------------------------------------------

ARGVS = [[], ["--save-every-n-steps", "5"], ["--auto-resume"],
         ["--nan-policy", "skip"], ["--nan-policy", "halt"],
         ["--save-every-n-steps", "2", "--auto-resume", "--nan-policy",
          "rollback"]]


def parsed(add, argv):
    p = argparse.ArgumentParser()
    add(p)
    return p.parse_args(argv)


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_options_from_args_match_jax(argv):
    mine = res.ResilienceOptions.from_args(parsed(res.add_resilience_args,
                                                  argv))
    ref = j_res.ResilienceOptions.from_args(parsed(j_res.add_resilience_args,
                                                   argv))
    # the port's fields are the flag-derived ones; the JAX class also
    # carries the I/O retry budget, which no flag sets
    fields = [f.name for f in dataclasses.fields(mine)]
    assert fields == ["save_every_n_steps", "auto_resume", "nan_policy"]
    assert dataclasses.asdict(mine) == {f: getattr(ref, f) for f in fields}
    assert (ref.max_io_retries, ref.io_backoff_s) == (res.IO_RETRIES,
                                                      res.IO_BACKOFF_S)
    for prop in ("enabled", "sentinel", "skip_nonfinite"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    # the training drivers' parsers: the same four flags and defaults
    t_args = common.add_common_args(argparse.ArgumentParser(),
                                    train=True).parse_args(argv)
    j_parser = argparse.ArgumentParser()
    j_common.add_common_args(j_parser, train=True)
    j_args = j_parser.parse_args(argv)
    for name in ("resume", "save_every_n_steps", "auto_resume", "nan_policy"):
        assert getattr(t_args, name) == getattr(j_args, name), name


def test_options_validation_matches_jax():
    for mod in (res, j_res):
        assert mod.NAN_POLICIES == ("off", "halt", "skip", "rollback")
        with pytest.raises(ValueError, match="nan_policy"):
            mod.ResilienceOptions(nan_policy="sometimes")
        with pytest.raises(ValueError, match="save_every_n_steps"):
            mod.ResilienceOptions(save_every_n_steps=-1)
        with pytest.raises(SystemExit):
            parsed(mod.add_resilience_args, ["--nan-policy", "sometimes"])
        off = mod.ResilienceOptions.from_args(argparse.Namespace())
        assert not off.enabled and not off.sentinel
    assert not res.ResilienceOptions(nan_policy="halt").skip_nonfinite


def test_step_keys_match_jax():
    for epoch, consumed in ((0, 0), (0, 1), (3, 17), (12, 10 ** 7 - 1),
                            (999, 5)):
        key = res.encode_step_key(epoch, consumed)
        assert key == j_res.encode_step_key(epoch, consumed)
        assert res.decode_step_key(key) == j_res.decode_step_key(key) == \
            (epoch, consumed)
    for bad in (-1, 10 ** 7):
        for mod in (res, j_res):
            with pytest.raises(ValueError, match="outside"):
                mod.encode_step_key(0, bad)


@pytest.mark.parametrize("failures", [0, 2, 5])
def test_retry_io_matches_jax(monkeypatch, tmp_path, failures):
    """Delays ``backoff · 2**attempt``, one ``checkpoint/retry`` a retry,
    the last error raised after ``retries``; errors outside
    (``OSError``, ``TimeoutError``) are not retried.  The port's budget is
    its constants, the JAX function's defaults."""
    delays = []
    monkeypatch.setattr(time, "sleep", delays.append)
    tel = telemetry.configure(str(tmp_path), stream=False)

    def run(mod):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) <= failures:
                raise (TimeoutError if len(calls) % 2 else OSError)("disk")
            return "done"

        delays.clear()
        try:
            out = mod.retry_io(fn, "save")
        except (OSError, TimeoutError) as e:
            out = type(e).__name__
        return out, len(calls), list(delays)

    try:
        mine, ref = run(res), run(j_res)
        assert mine == ref
        assert tel.summary()["counters"].get("checkpoint/retry", 0) == \
            min(failures, 3)
        for mod in (res, j_res):
            with pytest.raises(ValueError):
                mod.retry_io(lambda: int("x"), "save")
    finally:
        telemetry.shutdown()
    if failures == 2:
        assert mine == ("done", 3, [0.5, 1.0])
    if failures == 5:
        assert mine == ("OSError", 4, [0.5, 1.0, 2.0])


@pytest.mark.parametrize("mod", [res, j_res], ids=["port", "jax"])
def test_preemption_guard_first_and_second_signal(mod, tmp_path):
    """The first SIGTERM only sets the flag (and dumps the flight recorder
    in the port); the second restores the previous handler and delivers
    the signal to it; the handlers are restored on exit."""
    got = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: got.append(s))
    if mod is res:
        telemetry.configure(str(tmp_path), stream=False)
    try:
        with mod.PreemptionGuard() as guard:
            assert not guard.requested
            signal.raise_signal(signal.SIGTERM)
            assert guard.requested and got == []
            signal.raise_signal(signal.SIGTERM)
            assert got == [signal.SIGTERM]
        handler = signal.getsignal(signal.SIGTERM)
        assert handler is not guard._handler
        if mod is res:
            lines = (tmp_path / "flight_0.jsonl").read_text().splitlines()
            assert json.loads(lines[-1])["fields"] == {
                "reason": "preempt_signal", "signal": "SIGTERM"}
    finally:
        if mod is res:
            telemetry.shutdown()
        signal.signal(signal.SIGTERM, prev)


def test_preemption_guard_off_the_main_thread_is_inert():
    before = signal.getsignal(signal.SIGTERM)
    seen = []

    def body():
        with res.PreemptionGuard() as guard:
            seen.append((guard.requested, signal.getsignal(signal.SIGTERM)))

    t = threading.Thread(target=body)
    t.start()
    t.join(10)
    assert seen == [(False, before)]
    assert res.preemption_agreed(True) and not res.preemption_agreed(False)


def test_nan_dump_matches_jax(tmp_path):
    scalars = {"total_loss": float("nan"), "RPNAcc": 0.5}
    docs = []
    for mod, d in ((res, "port"), (j_res, "jax")):
        path = mod.dump_nan_diagnostics(str(tmp_path / d), 2, 7, 41, scalars)
        assert os.path.basename(path) == "nan_dump_e2_b7.json"
        with open(path) as f:
            docs.append(json.load(f))
        assert mod.dump_nan_diagnostics(None, 2, 7, 41, scalars) is None
    assert docs[0].keys() == docs[1].keys()
    for k in ("epoch", "consumed", "step"):
        assert docs[0][k] == docs[1][k]
    assert docs[0]["metrics"].keys() == docs[1]["metrics"].keys()


def test_fault_injection_matches_jax(monkeypatch):
    def roidb():
        return [{"image": f"img{i}.jpg", "image_array": np.zeros((2, 2, 3)),
                 "boxes": np.zeros((1, 4))} for i in range(6)]

    monkeypatch.delenv(res.ENV_BAD_RECORD, raising=False)
    monkeypatch.delenv(res.ENV_NAN_STEP, raising=False)
    plain = roidb()
    assert res.inject_roidb_faults(plain) is plain
    assert res.nan_injection_step() is None
    monkeypatch.setenv(res.ENV_BAD_RECORD, "1,-1,9")
    monkeypatch.setenv(res.ENV_NAN_STEP, "3")
    mine, ref = res.inject_roidb_faults(roidb()), j_res.inject_roidb_faults(
        roidb())
    assert [sorted(r) for r in mine] == [sorted(r) for r in ref]
    assert [r["image"] for r in mine] == [r["image"] for r in ref]
    assert [i for i, r in enumerate(mine) if "image_array" not in r] == \
        [1, 3, 5]
    assert res.nan_injection_step() == j_res.nan_injection_step() == 3


# -- CheckpointManager --------------------------------------------------------------

def flat_params(seed):
    rng = np.random.RandomState(seed)
    keys = {"backbone/conv1/kernel": (3, 3, 3, 4), "rpn/conv/bias": (4,),
            "rcnn/bbox_pred/kernel": (8, 84), "rcnn/bbox_pred/bias": (84,)}
    return {k: rng.randn(*s).astype(np.float32) for k, s in keys.items()}


def test_step_checkpoint_round_trip_and_window(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "run" / "e2e"))
    assert mgr.latest_step_checkpoint() is None
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)
    for i, (ep, cons) in enumerate(((0, 2), (0, 4), (1, 2), (1, 4))):
        params, mom = flat_params(i), flat_params(10 + i)
        mom.pop("rcnn/bbox_pred/bias")  # a frozen leaf has no momentum
        mgr.save_step(ep, cons, params, momentum=mom, step=7 + i,
                      schedule_count=i,
                      generator_state=gen.get_state().numpy())
    assert sorted(os.listdir(mgr.step_dir)) == [
        "step-000010000002.npz", "step-000010000004.npz"]
    assert mgr.latest_step_checkpoint() == (1, 4)
    got = mgr.load_step_checkpoint(1, 4)
    for k, v in flat_params(3).items():
        np.testing.assert_array_equal(got["params"][k], v)
    assert got["momentum"].keys() == set(flat_params(13)) - {
        "rcnn/bbox_pred/bias"}
    for k, v in got["momentum"].items():
        np.testing.assert_array_equal(v, flat_params(13)[k])
    assert (got["step"], got["epoch"], got["consumed"],
            got["schedule_count"]) == (10, 1, 4, 3)
    again = torch.Generator().set_state(torch.from_numpy(got["generator"]))
    assert torch.equal(torch.rand(7, generator=again),
                       torch.rand(7, generator=gen))
    with pytest.raises(FileNotFoundError, match=r"present: \[\(1, 2\), "
                                                r"\(1, 4\)\]"):
        mgr.load_step_checkpoint(0, 2)


def test_epoch_checkpoint_round_trip_and_interchange(tmp_path):
    """The epoch file is byte for byte the flat ``np.savez`` the port wrote
    before, loads in the JAX ``load_params_npz``, and its training state
    gives the raw parameters, momentum, step and generator back bitwise."""
    cfg = tiny(generate_config)
    params, mom = flat_params(0), flat_params(1)
    prefix = str(tmp_path / "e2e")
    mgr = checkpoint.CheckpointManager(prefix)
    gen = torch.Generator().manual_seed(9)
    mgr.save_epoch(3, params, cfg, momentum=mom, step=12,
                   generator_state=gen.get_state().numpy())
    folded = checkpoint.denormalize_for_save(params, cfg)
    np.savez(str(tmp_path / "old.npz"), **folded)
    assert (tmp_path / "old.npz").read_bytes() == \
        (tmp_path / "e2e-0003.npz").read_bytes()
    ref = flatten(jax.device_get(j_checkpoint.load_params_npz(
        checkpoint.epoch_path(prefix, 3))))
    assert ref.keys() == folded.keys()
    for k in ref:
        np.testing.assert_array_equal(ref[k], folded[k])
    r_params, r_mom, r_step, r_gen = mgr.load_epoch(3, cfg)
    for k in params:
        np.testing.assert_array_equal(r_params[k], params[k])
    for k in mom:
        np.testing.assert_array_equal(r_mom[k], mom[k])
    assert r_step == 12
    np.testing.assert_array_equal(r_gen, gen.get_state().numpy())
    # without the state file: the unfolded epoch file, no momentum
    os.remove(mgr.state_path(3))
    u_params, u_mom, u_step, u_gen = mgr.load_epoch(3, cfg)
    assert (u_mom, u_step, u_gen) == (None, 0, None)
    want = checkpoint.normalize_for_train(folded, cfg)
    for k in want:
        np.testing.assert_array_equal(u_params[k], want[k])
    assert mgr.load_epoch(3, cfg, for_training=False)[0].keys() == \
        folded.keys()
    mgr.save_epoch(1, params, cfg)
    assert mgr.available_epochs() == [1, 3] and mgr.latest_epoch() == 3
    with pytest.raises(FileNotFoundError, match=r"epochs present: \[1, 3\]"):
        mgr.load_epoch(2, cfg)


def test_killed_save_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    """A save that dies between the write and the rename (``os.replace``
    interrupted) leaves the earlier checkpoint the latest, and loadable;
    a temporary file left by a killed process is never listed."""
    cfg = tiny(generate_config)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "e2e"))
    mgr.save_step(0, 2, flat_params(0), step=2)
    mgr.save_epoch(1, flat_params(0), cfg, step=4)
    real = os.replace

    def killed(src, dst):
        raise KeyboardInterrupt("killed before the rename")

    monkeypatch.setattr(checkpoint.os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        mgr.save_step(1, 3, flat_params(1), step=7)
    with pytest.raises(KeyboardInterrupt):
        mgr.save_epoch(2, flat_params(1), cfg, step=8)
    monkeypatch.setattr(checkpoint.os, "replace", real)
    (tmp_path / "e2e-0002.npz.tmp.1.2").write_bytes(b"torn")
    (tmp_path / "e2e-steps" / "step-000010000003.npz.tmp.1.2").write_bytes(
        b"torn")
    assert mgr.latest_step_checkpoint() == (0, 2)
    assert mgr.available_epochs() == [1]
    assert mgr.latest_resume_point() == ("epoch", 1, 0)
    np.testing.assert_array_equal(
        mgr.load_step_checkpoint(0, 2)["params"]["rpn/conv/bias"],
        flat_params(0)["rpn/conv/bias"])
    assert mgr.load_epoch(1, cfg)[2] == 4


SEQUENCES = {
    "none": [],
    "epoch only": [("epoch", 1)],
    "step only": [("step", 0, 3)],
    "stale step then epoch": [("step", 0, 3), ("epoch", 1)],
    "epoch then step": [("epoch", 1), ("step", 1, 2)],
    "steps across epochs": [("step", 0, 3), ("epoch", 1), ("step", 1, 1),
                            ("step", 1, 5), ("epoch", 2), ("step", 2, 4)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_latest_resume_point_matches_jax(tmp_path, name):
    cfg, jcfg = tiny(generate_config), tiny(j_generate_config)
    mine = checkpoint.CheckpointManager(str(tmp_path / "port" / "e2e"))
    ref = j_checkpoint.CheckpointManager(str(tmp_path / "jax"))
    p = flat_params(0)
    tree = {"rpn": {"conv": {"bias": p["rpn/conv/bias"]}}}
    for op in SEQUENCES[name]:
        if op[0] == "epoch":
            mine.save_epoch(op[1], p, cfg)
            ref.save_epoch(op[1], tree, jcfg)
        else:
            mine.save_step(op[1], op[2], p)
            ref.save_step(op[1], op[2], tree, jcfg)
    assert mine.latest_resume_point() == ref.latest_resume_point()
    assert mine.latest_step_checkpoint() == ref.latest_step_checkpoint()
    assert mine.latest_epoch() == ref.latest_epoch()


# -- the step's sentinel and the skip policy against the JAX step ------------------

def make_batch(seed=0, nan=False):
    rng = np.random.RandomState(seed)
    gtb = np.zeros((B, G, 4), np.float32)
    gtc = np.zeros((B, G), np.int32)
    gtv = np.zeros((B, G), bool)
    for b in range(B):
        for i in range(2):
            x1, y1 = rng.randint(0, W - 40), rng.randint(0, H - 40)
            gtb[b, i] = (x1, y1, x1 + rng.randint(16, 39),
                         y1 + rng.randint(16, 39))
            gtc[b, i] = rng.randint(1, 21)
            gtv[b, i] = True
    images = rng.randn(B, H, W, 3).astype(np.float32)
    if nan:
        images = images * np.float32("nan")
    return dict(images=images,
                im_info=np.tile(np.asarray([[H, W, 1.0]], np.float32),
                                (B, 1)),
                gt_boxes=gtb, gt_classes=gtc, gt_valid=gtv)


def port_state(cfg, params, momentum=None):
    model = build_model(cfg)
    convert_jax.load_jax_params(model, params)
    state = create_train_state(cfg, model, steps_per_epoch=10)
    if momentum is not None:
        import_momentum(model, state.optimizer, momentum)
    return state


@pytest.mark.parametrize("leaf,value", [
    (None, None), (0, float("nan")), (1, float("inf")), (2, -float("inf")),
    (1, 3.0e38), ("loss", float("nan")), ("loss", float("inf"))])
def test_all_finite_matches_jax(leaf, value):
    """The sentinel's flag on the loss and three gradient leaves, one
    element (or the loss) set to ``value``: equal to the JAX
    ``_all_finite``; a huge finite gradient raises no alarm."""
    rng = np.random.RandomState(0)
    grads = [rng.randn(*shape).astype(np.float32)
             for shape in ((7, 5, 3, 3), (4097,), (2, 3))]
    total = np.float32(1.5)
    if leaf == "loss":
        total = np.float32(value)
    elif leaf is not None:
        grads[leaf].reshape(-1)[grads[leaf].size // 2] = value
    mine = _all_finite(torch.tensor(total), [torch.from_numpy(g)
                                             for g in grads])
    ref = j_all_finite(jax.numpy.asarray(total),
                       [jax.numpy.asarray(g) for g in grads])
    assert mine.dim() == 0 and mine.dtype == torch.bool
    assert bool(mine) == bool(ref) == (leaf is None or value == 3.0e38)


def test_skip_step_keeps_params_and_momentum_as_jax_does():
    jcfg, cfg = tiny(j_generate_config), tiny(generate_config)
    jmodel = j_build_model(jcfg)
    # the port's seeded weights, as the JAX package's nested tree
    flat = convert_jax.random_params(build_model(cfg), seed=0)
    params = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = params
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = v

    # the JAX step under skip: all_finite 0 and every leaf kept; 1 on a
    # finite batch
    jstate, tx, mask = j_create_train_state(jcfg, params, steps_per_epoch=10)
    jstep = j_make_train_step(jmodel, tx, trainable_mask=mask, donate=False,
                              sentinel=True, skip_nonfinite=True)
    after, jm = jstep(jstate, make_batch(1, nan=True), jax.random.PRNGKey(1))
    assert float(jm["all_finite"]) == 0.0
    kept = flatten(jax.device_get(after.params))
    for k in flat:
        np.testing.assert_array_equal(kept[k], flat[k], err_msg=k)
    _, jm = jstep(jstate, make_batch(2), jax.random.PRNGKey(2))
    assert float(jm["all_finite"]) == 1.0

    # the port, its momentum set (seeded), then the NaN batch
    trained = {k for k, t in fixed_param_mask(
        flat, cfg.network.FIXED_PARAMS).items() if t}
    rng = np.random.RandomState(7)
    mom = {k: rng.randn(*flat[k].shape).astype(np.float32) * 1e-3
           for k in sorted(trained)}
    state = port_state(cfg, flat, mom)
    skip_step = make_train_step(cfg, sentinel=True, skip_nonfinite=True)
    gen = torch.Generator().manual_seed(0)
    before = convert_jax.export_jax_params(state.model)
    nan_b = {k: torch.from_numpy(v) for k, v in make_batch(3, nan=True)
             .items()}
    state, m = skip_step(state, nan_b, generator=gen)
    assert float(m["all_finite"]) == 0.0
    assert not np.isfinite(float(m["total_loss"]))
    assert (state.step, state.schedule_count) == (1, 1)
    now = convert_jax.export_jax_params(state.model)
    for k in before:
        np.testing.assert_array_equal(now[k], before[k], err_msg=k)
    now_m = export_momentum(state.model, state.optimizer)
    assert now_m.keys() == trained
    for k in mom:
        np.testing.assert_array_equal(now_m[k], mom[k], err_msg=k)

    # a finite batch: the sentinel and the guard change nothing
    fin = {k: torch.from_numpy(v) for k, v in make_batch(4).items()}
    plain = port_state(cfg, before, mom)
    plain.schedule_count = state.schedule_count
    plain_step = make_train_step(cfg)
    _, pm = plain_step(plain, fin, generator=torch.Generator().manual_seed(5))
    state, m = skip_step(state, fin, generator=torch.Generator().manual_seed(5))
    assert float(m["all_finite"]) == 1.0 and "all_finite" not in pm
    assert float(m["total_loss"]) == float(pm["total_loss"])
    got, want = (convert_jax.export_jax_params(s.model) for s in (state,
                                                                   plain))
    got_m, want_m = (export_momentum(s.model, s.optimizer)
                     for s in (state, plain))
    assert any(not np.array_equal(got[k], before[k]) for k in trained)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in want_m:
        np.testing.assert_array_equal(got_m[k], want_m[k], err_msg=k)
    with pytest.raises(ValueError, match="sentinel"):
        make_train_step(cfg, skip_nonfinite=True)
