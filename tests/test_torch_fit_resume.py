"""``fit`` that survives interruption (``train/trainer.py`` with
``train/resilience.py``), on the CPU.

On the tiny detector of ``tests/test_fit_resume.py`` (ResNet-50, 64×96,
``MAX_GT=4``, ``TRAIN.BATCH_ROIS=16``; float32), one image a step, every
comparison bitwise against the uninterrupted run:

* a SIGTERM after step 3 of 4 (under ``skip``, step checkpoints every 2),
  then ``auto_resume``, at 0 and 2 loader workers (with the prefetch
  thread): the final parameters and momentum, the epoch ``.npz``; the
  preempted epoch leaves no prefetch thread and every ring slot free;
* the same through ``CappedLoader`` (``--num-steps``): its shrunk resumed
  epoch ends where the capped run ends;
* an epoch ``--resume`` across two epochs (the JAX ``test_fit_resume``
  case), momentum, step and generator restored, across an ``LR_STEP``
  drop at the resume point;
* ``MXR_FAULT_BAD_RECORD`` through ``get_train_roidb``: the same records
  corrupted as the JAX ``get_train_roidb``, substituted as the JAX loader
  substitutes them, counted by ``loader/bad_record``.

On a one-convolution stand-in model (the policies and the schedule,
cheaply): the LR at every step of an epoch resume and of a mid-epoch
auto-resume across an ``LR_STEP`` drop equals the uninterrupted run's,
and, where no drop has passed at the resume epoch, the JAX
``make_lr_schedule`` at the counts the JAX ``fit`` uses (reset to 0, or to
``consumed``); where one has, the port keeps it and the JAX package does
not (ROADMAP.md C.5), which a test of its own states; ``halt`` raises and
dumps; ``rollback`` restores the latest step checkpoint, the uninterrupted
run's state there bitwise, and trains on finite, and without one it
raises; a due save under the
sentinel fetches first; a preemption on a save boundary saves once; a
loader without ``skip_next`` is refused; ``CappedLoader``'s
``advance_epochs``/``skip_next`` against the JAX ``CappedLoader``.

Tolerances: none; every comparison is exact.
"""

import dataclasses
import os
import shutil
import signal

import numpy as np
import pytest
import torch
import torch.nn as nn

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data import SyntheticDataset as JSynthetic
from mx_rcnn_tpu.data import loader as j_loader
from mx_rcnn_tpu.tools import common as j_common
from mx_rcnn_tpu.train import make_lr_schedule as j_make_lr_schedule

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data import loader as t_loader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.tools import common
from mx_rcnn_tpu_torch.train import optim, trainer
from mx_rcnn_tpu_torch.train.checkpoint import (CheckpointManager,
                                                denormalize_for_save,
                                                epoch_path, load_params_npz)
from mx_rcnn_tpu_torch.train.optim import export_momentum
from mx_rcnn_tpu_torch.train.resilience import (ENV_BAD_RECORD, ENV_NAN_STEP,
                                                NonFiniteLossError,
                                                ResilienceOptions)
from mx_rcnn_tpu_torch.utils.convert_jax import (export_jax_params,
                                                 random_params)
from tests.test_torch_loader_workers import (jax_cfg, port_cfg, snapshot,
                                             tiny_roidb)
from tests.test_torch_prefetch import prefetch_threads, wait_until
from tests.test_torch_resilience import tiny

torch.set_num_threads(2)

H, W = 64, 96
SKIP = ResilienceOptions(save_every_n_steps=2, nan_policy="skip")


def detector_roidb(n_images):
    ds = SyntheticDataset(num_images=n_images, num_classes=21, height=H,
                          width=W, max_objects=3)
    return ds.filter_roidb(ds.append_flipped_images(ds.gt_roidb()))


def state_of(st):
    return (export_jax_params(st.model), export_momentum(st.model,
                                                         st.optimizer))


def assert_state_equal(got, want):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


class Snapshots:
    """``fit``'s step function wrapped to record the parameters and the
    momentum after every step (reading them back synchronises)."""

    def __init__(self, monkeypatch):
        self.after = []
        real = trainer.make_train_step

        def make(*a, **kw):
            fn = real(*a, **kw)

            def step(state, batch, **k):
                out = fn(state, batch, **k)
                self.after.append(state_of(state))
                return out

            return step

        monkeypatch.setattr(trainer, "make_train_step", make)


def preempt_after(n):
    """A ``batch_end_callback`` that sends SIGTERM to this process after
    step ``n`` (``frequent=1``: called after every step)."""
    def cb(epoch, step, metrics):
        if step == n:
            signal.raise_signal(signal.SIGTERM)
    return cb


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """A detector checkpoint is ~230 MB: leave none behind."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def detector():
    cfg = tiny(generate_config)
    model = build_model(cfg)
    return cfg, model, random_params(model, seed=1)


@pytest.fixture(scope="module")
def uninterrupted(detector):
    """One epoch of 4 steps (4 records, batch 1, seed 4) under ``skip``:
    the final state and the state after each step."""
    cfg, model, params = detector
    with pytest.MonkeyPatch.context() as mp:
        snaps = Snapshots(mp)
        loader = t_loader.AnchorLoader(detector_roidb(2), cfg, 1, seed=4)
        st = trainer.fit(cfg, model, params, loader, end_epoch=1,
                         device="cpu", frequent=1,
                         resilience=ResilienceOptions(nan_policy="skip"))
    assert len(snaps.after) == 4 and st.step == 4
    return {"final": state_of(st), "after": snaps.after}


@pytest.mark.parametrize("workers", [0, 2])
def test_preempt_then_auto_resume_is_bitwise(detector, uninterrupted,
                                             tmp_path, workers):
    cfg, model, params = detector
    cfg = port_cfg_like(cfg, workers)
    prefix = str(tmp_path / "e2e")
    loader = t_loader.AnchorLoader(detector_roidb(2), cfg, 1, seed=4)
    handler = signal.getsignal(signal.SIGTERM)
    try:
        st = trainer.fit(cfg, model, params, loader, end_epoch=1,
                         prefix=prefix, device="cpu", frequent=1,
                         resilience=SKIP, batch_end_callback=preempt_after(3))
        assert st.step == 3
        mgr = CheckpointManager(prefix)
        assert mgr.latest_resume_point() == ("step", 0, 3)
        assert mgr.available_epochs() == []
        assert signal.getsignal(signal.SIGTERM) is handler
        # the preempted epoch was closed: no producer, no ticket held
        assert wait_until(lambda: not prefetch_threads())
        if workers:
            pool = loader._pool
            assert wait_until(lambda: pool._free.qsize() == pool.n_slots)
            assert not pool._pending
        loader.close_workers()
        # a new process: a new loader, its RNG at its seed
        loader = t_loader.AnchorLoader(detector_roidb(2), cfg, 1, seed=4)
        seen = []
        st = trainer.fit(cfg, model, params, loader, end_epoch=1,
                         prefix=prefix, device="cpu", frequent=1,
                         resilience=dataclasses.replace(SKIP,
                                                        auto_resume=True),
                         batch_end_callback=lambda e, s, m: seen.append(s))
    finally:
        loader.close_workers()
    assert seen == [4] and st.step == 4 and st.schedule_count == 4
    assert_state_equal(state_of(st), uninterrupted["final"])
    saved = load_params_npz(epoch_path(prefix, 1))
    assert_state_equal((saved,), (denormalize_for_save(
        uninterrupted["final"][0], cfg),))


def port_cfg_like(cfg, workers):
    return cfg.replace(tpu=dataclasses.replace(
        cfg.tpu, LOADER_WORKERS=workers, PREFETCH=2 if workers else 0,
        PREFETCH_WATCHDOG_S=30.0))


def test_capped_loader_resume_is_bitwise(detector, uninterrupted, tmp_path):
    """``--num-steps 3`` of the 4-step epoch, preempted after step 2: the
    resumed epoch skips 2 batches and yields 1, ending with the capped
    run's state (the uninterrupted run's after step 3)."""
    cfg, model, params = detector
    prefix = str(tmp_path / "e2e")

    def capped():
        return common.CappedLoader(t_loader.AnchorLoader(detector_roidb(2),
                                                         cfg, 1, seed=4), 3)

    st = trainer.fit(cfg, model, params, capped(), end_epoch=1,
                     prefix=prefix, device="cpu", frequent=1,
                     resilience=SKIP, batch_end_callback=preempt_after(2))
    assert st.step == 2
    st = trainer.fit(cfg, model, params, capped(), end_epoch=1, prefix=prefix,
                     device="cpu", frequent=1,
                     resilience=dataclasses.replace(SKIP, auto_resume=True))
    assert st.step == 3
    assert_state_equal(state_of(st), uninterrupted["after"][2])


def test_epoch_resume_across_an_lr_drop_is_bitwise(detector, tmp_path,
                                                   monkeypatch):
    """Two epochs of 2 steps (1 image flipped, batch 1, no shuffle, the JAX
    ``test_fit_resume`` case) with ``LR_STEP=(1,)``; ``--resume
    --begin_epoch 1`` from the first run's epoch-1 checkpoint repeats its
    second epoch bitwise, at the dropped rate."""
    cfg, model, params = detector
    cfg = cfg.replace(TRAIN=dataclasses.replace(cfg.TRAIN, LR_STEP=(1,)))
    lrs = record_lrs(monkeypatch)
    prefix = str(tmp_path / "e2e")
    roidb = detector_roidb(1)
    st = trainer.fit(cfg, model, params,
                     t_loader.AnchorLoader(roidb, cfg, 1, shuffle=False),
                     end_epoch=2, prefix=prefix, device="cpu", frequent=1)
    want, want_lr = state_of(st), list(lrs)
    assert want_lr == [cfg.TRAIN.LR] * 2 + [cfg.TRAIN.LR * 0.1] * 2
    lrs.clear()
    st = trainer.fit(cfg, model, params,
                     t_loader.AnchorLoader(roidb, cfg, 1, shuffle=False),
                     begin_epoch=1, end_epoch=2, prefix=prefix, device="cpu",
                     frequent=1, resume=True)
    assert (st.step, st.schedule_count) == (4, 2)
    assert lrs == want_lr[2:]
    assert_state_equal(state_of(st), want)
    # frozen leaves never moved
    for k, t in st.mask.items():
        if not t:
            np.testing.assert_array_equal(want[0][k], params[k])


def test_bad_record_through_get_train_roidb_matches_jax(monkeypatch):
    """``MXR_FAULT_BAD_RECORD`` corrupts the same filtered records as the
    JAX ``get_train_roidb``; the port's loader substitutes them as the JAX
    loader does, and counts them."""
    monkeypatch.setenv(ENV_BAD_RECORD, "2,5")
    ds = SyntheticDataset(num_images=4, num_classes=5, height=H, width=W)
    mine = common.get_train_roidb(ds, port_cfg())
    ref = j_common.get_train_roidb(
        JSynthetic(num_images=4, num_classes=5, height=H, width=W), jax_cfg())
    bad = [i for i, r in enumerate(mine) if "image_array" not in r]
    assert bad == [2, 5] == [i for i, r in enumerate(ref)
                             if "image_array" not in r]
    want = snapshot(j_loader.AnchorLoader(ref, jax_cfg(), 2, seed=3))
    tel = telemetry.configure("", stream=False)
    try:
        got = snapshot(t_loader.AnchorLoader(mine, port_cfg(), 2, seed=3))
        assert tel.summary()["counters"]["loader/bad_record"] == 2
    finally:
        telemetry.shutdown()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


# -- a stand-in model: the policies and the schedule ------------------------------

class StandIn(nn.Module):
    """One convolution under the RPN's name; its loss draws one uniform
    from the generator, so the sampling stream is checked too, and is NaN
    when the images are."""

    def __init__(self):
        super().__init__()
        self.rpn = nn.Module()
        self.rpn.rpn_conv_3x3 = nn.Conv2d(3, 2, 1)

    def forward(self, images, im_info, gt_boxes, gt_classes, gt_valid,
                draws=None, generator=None):
        u = torch.rand((), generator=generator)
        out = self.rpn.rpn_conv_3x3(images.permute(0, 3, 1, 2))
        return (out * (1.0 + u)).square().mean(), {}


class StandInLoader:
    """``steps`` batches an epoch; each epoch's images drawn from the
    loader's RandomState, so ``advance_epochs`` and ``skip_next`` matter;
    the ``put`` hook is stored, not run (the batches are tensors)."""

    def __init__(self, steps=3, seed=0):
        self.steps_per_epoch, self.batch_size = steps, 2
        self._rng = np.random.RandomState(seed)
        self._skip = 0
        self.put = None
        self.closed = 0

    def _epoch(self):
        return [self._rng.randn(2, 4, 4, 3).astype(np.float32)
                for _ in range(self.steps_per_epoch)]

    def advance_epochs(self, n):
        for _ in range(n):
            self._epoch()

    def skip_next(self, n):
        self._skip = n

    def __iter__(self):
        imgs, self._skip = self._epoch()[self._skip:], 0
        try:
            for im in imgs:
                yield {"images": torch.from_numpy(im),
                       **{k: torch.zeros(2) for k in ("im_info", "gt_boxes",
                                                      "gt_classes",
                                                      "gt_valid")}}
        finally:
            self.closed += 1


class NoSkipLoader(StandInLoader):
    skip_next = property()  # hasattr() is False


def stand_in_cfg(**train):
    cfg = generate_config("resnet50", "PascalVOC")
    return cfg.replace(TRAIN=dataclasses.replace(cfg.TRAIN, LR=0.1, **train))


def stand_in_params():
    return random_params(StandIn(), seed=0)


def record_lrs(monkeypatch):
    lrs = []
    real = trainer.make_train_step

    def make(*a, **kw):
        fn = real(*a, **kw)

        def step(state, batch, **k):
            out = fn(state, batch, **k)
            lrs.append(state.optimizer.param_groups[0]["lr"])
            return out

        return step

    monkeypatch.setattr(trainer, "make_train_step", make)
    return lrs


def stand_in_fit(cfg, loader, prefix, **kw):
    return trainer.fit(cfg, StandIn(), stand_in_params(), loader,
                       prefix=prefix, device="cpu", frequent=1, **kw)


@pytest.mark.parametrize("lr_step", [(1,), (2,), (1, 3), (0, 1, 2)])
def test_lr_at_every_resumed_step(monkeypatch, tmp_path, lr_step):
    """Three epochs of 3 steps; an epoch resume at epoch 1 and a mid-epoch
    auto-resume at (1, 2) run each step at the uninterrupted run's rate,
    and finish with its parameters bitwise."""
    train = dict(LR_STEP=lr_step, LR_FACTOR=0.1)
    cfg = stand_in_cfg(**train)
    jcfg = j_generate_config("resnet50", "PascalVOC")
    jcfg = jcfg.replace(TRAIN=dataclasses.replace(jcfg.TRAIN, LR=0.1,
                                                  **train))
    lrs = record_lrs(monkeypatch)
    st = stand_in_fit(cfg, StandInLoader(), str(tmp_path / "a" / "e2e"),
                      end_epoch=3,
                      resilience=ResilienceOptions(save_every_n_steps=1))
    want, want_p = list(lrs), export_jax_params(st.model)
    # epoch resume: epoch 1's checkpoint, schedule count from 0
    lrs.clear()
    loader = StandInLoader()
    loader.advance_epochs(1)
    st = stand_in_fit(cfg, loader, str(tmp_path / "a" / "e2e"),
                      begin_epoch=1, end_epoch=3, resume=True)
    assert lrs == want[3:]
    assert_state_equal((export_jax_params(st.model),), (want_p,))
    j_sched = j_make_lr_schedule(jcfg, 3, begin_epoch=1)
    # JAX's fit resets the count to 0 here; where no drop has passed, its
    # schedule is the port's (where one has, see
    # test_resumed_lr_keeps_the_drops_the_run_passed)
    passed = any(0 < e <= 1 for e in lr_step)
    if not passed:
        np.testing.assert_allclose(lrs, [float(j_sched(c))
                                         for c in range(6)], rtol=1e-6)
    # mid-epoch auto-resume at (1, 2): stop the first run there
    lrs.clear()
    prefix = str(tmp_path / "b" / "e2e")
    stand_in_fit(cfg, StandInLoader(), prefix, end_epoch=3,
                 resilience=ResilienceOptions(save_every_n_steps=1),
                 batch_end_callback=lambda e, s, m: e == 1 and s == 2 and
                 signal.raise_signal(signal.SIGTERM))
    assert lrs == want[:5]
    lrs.clear()
    st = stand_in_fit(cfg, StandInLoader(), prefix, end_epoch=3,
                      resilience=ResilienceOptions(auto_resume=True))
    assert lrs == want[5:]
    assert (st.step, st.schedule_count) == (9, 6)
    assert_state_equal((export_jax_params(st.model),), (want_p,))
    # JAX's fit restarts the count at consumed = 2 against epoch 1's basis
    if not passed:
        np.testing.assert_allclose(lrs, [float(j_sched(c))
                                         for c in range(2, 6)], rtol=1e-6)


@pytest.mark.parametrize("origin,begin", [(0, 1), (0, 2), (0, 3), (1, 3),
                                          (2, 2)])
@pytest.mark.parametrize("lr_step", [(1,), (2,), (1, 3), (0, 1, 2)])
def test_resumed_lr_keeps_the_drops_the_run_passed(origin, begin, lr_step):
    """The port's one departure from the JAX schedule (ROADMAP.md C.5): a
    run begun at ``origin`` and resumed at ``begin`` starts at ``LR ·
    LR_FACTOR ** (drops in (origin, begin])``, the reference's
    ``lr_epoch_diff`` rule, so the resumed schedule at count ``c`` is the
    uninterrupted JAX schedule from ``origin`` at ``c + (begin − origin)
    · steps_per_epoch``.  The JAX package's resumed runs go back to
    ``LR`` instead.  Exact up to the float products' order (rtol 1e-6)."""
    train = dict(LR_STEP=lr_step, LR_FACTOR=0.1)
    cfg = stand_in_cfg(**train)
    jcfg = j_generate_config("resnet50", "PascalVOC")
    jcfg = jcfg.replace(TRAIN=dataclasses.replace(jcfg.TRAIN, LR=0.1,
                                                  **train))
    mine = optim.make_lr_schedule(cfg, 3, begin, origin)
    whole = j_make_lr_schedule(jcfg, 3, begin_epoch=origin)
    shift = (begin - origin) * 3
    np.testing.assert_allclose([mine(c) for c in range(12)],
                               [float(whole(c + shift)) for c in range(12)],
                               rtol=1e-6)
    resumed_jax = j_make_lr_schedule(jcfg, 3, begin_epoch=begin)
    assert float(resumed_jax(0)) == pytest.approx(0.1)
    assert mine(0) == pytest.approx(
        0.1 * 0.1 ** sum(origin < e <= begin for e in lr_step))


def test_halt_dumps_and_raises(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV_NAN_STEP, "1")
    prefix = str(tmp_path / "run" / "e2e")
    loader = StandInLoader()
    with pytest.raises(NonFiniteLossError, match="batch 2 .*dumped"):
        stand_in_fit(stand_in_cfg(), loader, prefix, end_epoch=1,
                     resilience=ResilienceOptions(nan_policy="halt"))
    assert os.listdir(tmp_path / "run") == ["nan_dump_e0_b2.json"]
    assert loader.closed == 1  # the epoch's iterator was closed


def test_rollback_restores_the_step_checkpoint(monkeypatch, tmp_path):
    """Step checkpoints every step, NaN images at batch 2 (step 3): the
    state goes back to the uninterrupted run's after step 2, bitwise, and
    steps 4-5 train on from it, finite."""
    cfg = stand_in_cfg()
    snaps = Snapshots(monkeypatch)
    stand_in_fit(cfg, StandInLoader(steps=5), None, end_epoch=1)
    want = snaps.after[1]
    monkeypatch.setenv(ENV_NAN_STEP, "2")
    snaps.after.clear()
    seen = []
    tel = telemetry.configure(str(tmp_path / "tel"), stream=False)
    rolled = []
    real = trainer.load_jax_params

    def load(model, params):
        real(model, params)
        rolled.append(export_jax_params(model))

    monkeypatch.setattr(trainer, "load_jax_params", load)
    try:
        st = stand_in_fit(cfg, StandInLoader(steps=5), str(tmp_path / "e2e"),
                          end_epoch=1,
                          resilience=ResilienceOptions(save_every_n_steps=1,
                                                       nan_policy="rollback"),
                          batch_end_callback=lambda e, s, m: seen.append(m))
        counters = tel.summary()["counters"]
    finally:
        telemetry.shutdown()
    assert [m["all_finite"] for m in seen] == [1.0, 1.0, 0.0, 1.0, 1.0]
    assert counters["train/nan_detected"] == counters["train/nan_rollback"] \
        == 1
    assert len(rolled) == 2  # fit's own load, then the rollback's
    assert_state_equal((rolled[1],), (want[0],))
    assert not np.isfinite(snaps.after[2][0]["rpn/rpn_conv_3x3/kernel"]).all()
    assert st.step == 4 and st.schedule_count == 4
    final = export_jax_params(st.model)
    assert all(np.isfinite(v).all() for v in final.values())
    assert not np.array_equal(final["rpn/rpn_conv_3x3/kernel"],
                              want[0]["rpn/rpn_conv_3x3/kernel"])


def test_rollback_without_a_step_checkpoint_raises(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV_NAN_STEP, "0")
    with pytest.raises(NonFiniteLossError, match="no step checkpoint"):
        stand_in_fit(stand_in_cfg(), StandInLoader(), str(tmp_path / "e2e"),
                     end_epoch=1,
                     resilience=ResilienceOptions(nan_policy="rollback"))
    with pytest.raises(NonFiniteLossError, match="no step checkpoint"):
        stand_in_fit(stand_in_cfg(), StandInLoader(), None, end_epoch=1,
                     resilience=ResilienceOptions(nan_policy="rollback"))


def test_skip_under_nan_counts_and_keeps_going(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV_NAN_STEP, "1")
    tel = telemetry.configure(str(tmp_path), stream=False)
    seen = []
    try:
        st = stand_in_fit(stand_in_cfg(), StandInLoader(), None, end_epoch=1,
                          resilience=ResilienceOptions(nan_policy="skip"),
                          batch_end_callback=lambda e, s, m: seen.append(m))
        counters = tel.summary()["counters"]
    finally:
        telemetry.shutdown()
    assert [m["all_finite"] for m in seen] == [1.0, 0.0, 1.0]
    assert counters["train/nan_detected"] == counters["train/nan_skipped"] \
        == 1
    assert st.step == 3
    assert all(np.isfinite(v).all()
               for v in export_jax_params(st.model).values())


def test_due_save_fetches_first_and_a_position_saves_once(monkeypatch,
                                                          tmp_path):
    """``frequent`` 100: under the sentinel the fetches come only with the
    due saves (2, 4) and the epoch end; a preemption at a save boundary
    writes that position once."""
    saves = []
    real = CheckpointManager.save_step

    def counting(self, ep, cons, *a, **kw):
        saves.append((ep, cons))
        return real(self, ep, cons, *a, **kw)

    monkeypatch.setattr(CheckpointManager, "save_step", counting)
    fetched = []
    st = trainer.fit(stand_in_cfg(), StandIn(), stand_in_params(),
                     StandInLoader(steps=5), end_epoch=1,
                     prefix=str(tmp_path / "e2e"), device="cpu", frequent=100,
                     resilience=ResilienceOptions(save_every_n_steps=2,
                                                  nan_policy="halt"),
                     batch_end_callback=lambda e, s, m: fetched.append(s))
    assert fetched == [2, 4, 5] and saves == [(0, 2), (0, 4)]
    saves.clear()
    loader = StandInLoader(steps=5)
    st = trainer.fit(stand_in_cfg(), StandIn(), stand_in_params(), loader,
                     end_epoch=1, prefix=str(tmp_path / "f"), device="cpu",
                     frequent=1,
                     resilience=ResilienceOptions(save_every_n_steps=2),
                     batch_end_callback=preempt_after(2))
    assert saves == [(0, 2)] and st.step == 2 and loader.closed == 1


def test_mid_epoch_resume_needs_skip_next(tmp_path):
    prefix = str(tmp_path / "e2e")
    stand_in_fit(stand_in_cfg(), StandInLoader(), prefix, end_epoch=1,
                 resilience=ResilienceOptions(save_every_n_steps=2),
                 batch_end_callback=preempt_after(2))
    with pytest.raises(ValueError, match="skip_next"):
        stand_in_fit(stand_in_cfg(), NoSkipLoader(), prefix, end_epoch=1,
                     resilience=ResilienceOptions(auto_resume=True))
    with pytest.raises(ValueError, match="prefix"):
        stand_in_fit(stand_in_cfg(), StandInLoader(), None, end_epoch=1,
                     resilience=ResilienceOptions(auto_resume=True))
    with pytest.raises(ValueError, match="prefix"):
        stand_in_fit(stand_in_cfg(), StandInLoader(), None, end_epoch=1,
                     resume=True)


@pytest.mark.parametrize("advance,skip", [(0, 0), (1, 0), (0, 2), (1, 3),
                                          (2, 1)])
def test_capped_loader_fast_forward_matches_jax(advance, skip):
    """``CappedLoader(n=3)`` over the 8-batch loader: ``advance_epochs`` and
    ``skip_next`` give the JAX ``CappedLoader``'s batches bitwise, the
    resumed epoch shrunk to ``3 − skip``, the next one whole again."""
    roidb = tiny_roidb()

    def run(capped):
        capped.advance_epochs(advance)
        capped.skip_next(skip)
        return snapshot(capped, epochs=2)

    want = run(j_common.CappedLoader(
        j_loader.AnchorLoader(roidb, jax_cfg(), 2, seed=6), 3))
    got = run(common.CappedLoader(
        t_loader.AnchorLoader(roidb, port_cfg(), 2, seed=6), 3))
    assert len(got) == len(want) == 3 - skip + 3
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
