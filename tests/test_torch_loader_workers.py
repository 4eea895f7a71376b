"""The port's host input pipeline (``data/loader.py`` + ``data/workers.py``)
against the JAX package, on the CPU, at the tiny config of
``tests/test_loader_workers.py`` (64×96, ``MAX_GT=4``), forked workers.

* The port's ``AnchorLoader`` and ``ROIIter`` at 0, 1 and 2 workers give
  the JAX package's serial device-prep loaders' batches bitwise, over two
  epochs and through a mid-epoch resume (``advance_epochs`` + ``skip_next``).
* Fault contracts: a worker crashing once is respawned and the epoch is
  unchanged, as are the later epochs when it dies with tickets in flight;
  one crashing always raises "systemic"; a slow worker keeps
  the order; a bad record is substituted as the JAX
  ``_load_record_isolated`` substitutes it, serially and inside a worker,
  and ``MAX_CONSECUTIVE_BAD_RECORDS`` of them raise "systemic".
* The ring is reused across epochs and gone after ``close_workers``; the
  serving ``prepare`` is ``stage_raw_to_bucket`` bitwise.

Every blocking wait is bounded: the loaders' watchdog is 30 s here, and
``prepare`` is given a timeout.
"""

import dataclasses
import os

import numpy as np
import pytest

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data import loader as j_loader

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data import loader as t_loader
from mx_rcnn_tpu_torch.data import workers as workers_mod
from mx_rcnn_tpu_torch.data.image import stage_raw_to_bucket
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset

WATCHDOG_S = 30.0


def tiny(gen, **kw):
    cfg = gen("resnet50", "PascalVOC", TRAIN__RPN_PRE_NMS_TOP_N=200,
              TRAIN__RPN_POST_NMS_TOP_N=4, TRAIN__BATCH_ROIS=16,
              tpu__SCALES=((64, 96),), tpu__MAX_GT=4,
              tpu__PREFETCH_WATCHDOG_S=WATCHDOG_S, **kw)
    return cfg.replace(network=dataclasses.replace(
        cfg.network, ANCHOR_SCALES=(2, 4), PIXEL_STDS=(127.0, 127.0, 127.0)))


def port_cfg(workers=0, **kw):
    return tiny(generate_config, tpu__LOADER_WORKERS=workers, **kw)


def jax_cfg(**kw):
    return tiny(j_generate_config, tpu__DEVICE_PREP=True, **kw)


def tiny_roidb(n_images=8, proposals=False):
    """Synthetic records at 64×96 and their mirrors, two of them turned
    portrait, one larger than the bucket (pre-shrunk); with ``proposals``
    1-6 boxes each (above the cap of 4 for some)."""
    roidb = SyntheticDataset(num_images=n_images, num_classes=5, height=64,
                             width=96).gt_roidb()
    roidb = [dict(r) for r in roidb]
    for rec in roidb[:2]:  # portrait: transpose pixels and boxes
        rec["image_array"] = np.ascontiguousarray(
            rec["image_array"].transpose(1, 0, 2))
        rec["boxes"] = rec["boxes"][:, [1, 0, 3, 2]].copy()
        rec["height"], rec["width"] = rec["width"], rec["height"]
    big = roidb[2]
    big["image_array"] = np.repeat(np.repeat(big["image_array"], 2, 0), 2, 1)
    big["boxes"] = big["boxes"] * 2
    big["height"], big["width"] = 128, 192
    mirrored = []
    for rec in roidb:
        m = dict(rec)
        b = rec["boxes"].copy()
        m["boxes"] = np.stack([rec["width"] - 1 - b[:, 2], b[:, 1],
                               rec["width"] - 1 - b[:, 0], b[:, 3]], 1)
        m["flipped"] = True
        mirrored.append(m)
    roidb += mirrored
    if proposals:
        rng = np.random.RandomState(7)
        for rec in roidb:
            k = rng.randint(1, 7)
            x1 = rng.randint(0, 40, size=(k, 1)).astype(np.float32)
            y1 = rng.randint(0, 30, size=(k, 1)).astype(np.float32)
            rec["proposals"] = np.concatenate([x1, y1, x1 + 20, y1 + 20], 1)
    return roidb


def snapshot(loader, epochs=1):
    out = []
    for _ in range(epochs):
        out.extend({k: np.array(v) for k, v in b.items()} for b in loader)
    return out


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert list(a) == list(b), i
        for k in a:
            assert a[k].dtype == b[k].dtype, (i, k)
            np.testing.assert_array_equal(a[k], b[k],
                                          err_msg=f"batch {i} key {k}")


def run_port(loader, epochs=1, setup=None):
    try:
        if setup is not None:
            setup(loader)
        return snapshot(loader, epochs)
    finally:
        loader.close_workers()


LOADERS = {"anchor": (t_loader.AnchorLoader, j_loader.AnchorLoader, False),
           "roi": (t_loader.ROIIter, j_loader.ROIIter, True)}


@pytest.mark.parametrize("kind", sorted(LOADERS))
@pytest.mark.parametrize("workers", [0, 1, 2])
@pytest.mark.parametrize("seed", [3, 11])
def test_loader_matches_jax_serial_loader(kind, workers, seed):
    """Two epochs: the same plan (shuffle, wrap, aspect groups), staged
    bytes (pre-shrink included), sidecars, gt and proposals, whatever the
    worker count."""
    port_cls, jax_cls, props = LOADERS[kind]
    roidb = tiny_roidb(proposals=props)
    want = snapshot(jax_cls(roidb, jax_cfg(), 2, shuffle=True, seed=seed),
                    epochs=2)
    got = run_port(port_cls(roidb, port_cfg(workers), 2, shuffle=True,
                            seed=seed), epochs=2)
    assert_batches_equal(got, want)
    assert any(b["flip"].any() for b in got)
    assert {b["images"].shape[1:3] for b in got} == {(64, 96), (96, 64)}
    if props:
        assert any(b["roi_valid"].all() for b in got)


@pytest.mark.parametrize("workers", [0, 2])
def test_mid_epoch_resume_matches_jax_tail(workers):
    roidb = tiny_roidb()
    want = snapshot(j_loader.AnchorLoader(roidb, jax_cfg(), 2, seed=5),
                    epochs=2)
    steps = len(want) // 2

    def resume(ld):
        ld.advance_epochs(1)  # resume inside epoch 1 (0-based)
        ld.skip_next(2)

    got = run_port(t_loader.AnchorLoader(roidb, port_cfg(workers), 2, seed=5),
                   setup=resume)
    assert_batches_equal(got, want[steps + 2:])
    with pytest.raises(ValueError, match="exceeds"):
        ld = t_loader.AnchorLoader(roidb, port_cfg(), 2, seed=5)
        ld.skip_next(steps + 1)
        iter(ld)


def test_worker_crash_once_is_respawned(monkeypatch, tmp_path):
    roidb = tiny_roidb()
    want = snapshot(t_loader.AnchorLoader(roidb, port_cfg(0), 2, seed=2))
    monkeypatch.setenv("MXR_FAULT_WORKER_CRASH_IDX", "3")
    monkeypatch.setenv("MXR_FAULT_WORKER_CRASH_ONCE",
                       str(tmp_path / "crashed.marker"))
    ld = t_loader.AnchorLoader(roidb, port_cfg(2), 2, seed=2)
    try:
        got = snapshot(ld)
        assert ld._pool.respawns >= 1
        assert (tmp_path / "crashed.marker").exists()
    finally:
        ld.close_workers()
    assert_batches_equal(got, want)


def test_worker_crash_with_tickets_in_flight_keeps_later_epochs(
        monkeypatch, tmp_path):
    """A worker dies with the ring full of tickets; the epochs after the
    respawn, which reuse its slots, stay the serial producer's bitwise.
    Every task is queued under the pool's lock, so that a respawn cannot
    reissue a task that its submitter then queues a second time (the
    duplicate would write into a slot a later ticket owns)."""
    roidb = tiny_roidb()
    want = snapshot(t_loader.AnchorLoader(roidb, port_cfg(0), 2, seed=9),
                    epochs=3)
    monkeypatch.setenv("MXR_FAULT_WORKER_CRASH_IDX", "5")
    monkeypatch.setenv("MXR_FAULT_WORKER_CRASH_ONCE",
                       str(tmp_path / "crashed.marker"))
    ld = t_loader.AnchorLoader(roidb, port_cfg(2), 2, seed=9)
    locked = []
    try:
        pool = ld._ensure_pool()
        for q in pool._task_qs:
            def put(msg, _put=q.put):
                if msg is not None:  # not close()'s sentinel
                    locked.append(pool._lock.locked())
                return _put(msg)
            q.put = put
        got = snapshot(ld, epochs=3)
        assert pool.respawns >= 1
        assert pool._free.qsize() == pool.n_slots and not pool._pending
    finally:
        ld.close_workers()
    assert locked and all(locked)
    assert_batches_equal(got, want)


def test_worker_crash_always_raises_systemic(monkeypatch):
    monkeypatch.setenv("MXR_FAULT_WORKER_CRASH_IDX", "3")
    monkeypatch.setattr(workers_mod, "MAX_WORKER_RESPAWNS", 2)
    ld = t_loader.AnchorLoader(tiny_roidb(), port_cfg(2), 2, seed=2)
    try:
        with pytest.raises(RuntimeError, match="systemic"):
            snapshot(ld)
    finally:
        ld.close_workers()


def test_order_holds_under_a_slow_worker(monkeypatch):
    roidb = tiny_roidb()
    want = snapshot(t_loader.AnchorLoader(roidb, port_cfg(0), 2, seed=6))
    monkeypatch.setenv("MXR_FAULT_WORKER_SLOW", "0:0.03")
    got = run_port(t_loader.AnchorLoader(roidb, port_cfg(2), 2, seed=6))
    assert_batches_equal(got, want)


def shm_path(name):
    return os.path.join(workers_mod._SHM_DIR, name.lstrip("/"))


def test_ring_reused_across_epochs_and_freed_by_close():
    ld = t_loader.AnchorLoader(tiny_roidb(), port_cfg(2), 2, seed=4)
    try:
        snapshot(ld)
        pool = ld._pool
        name = pool.shm_name
        assert os.path.exists(shm_path(name))
        assert pool.ring_bytes == 6 * 64 * 96 * 3  # max(2N + 2, 4) slots
        snapshot(ld)
        assert ld._pool is pool and pool.shm_name == name
        assert pool._free.qsize() == pool.n_slots and not pool._pending
        procs = list(pool._procs)
    finally:
        ld.close_workers()
    assert ld._pool is None
    assert not any(p.is_alive() for p in procs)
    assert not os.path.exists(shm_path(name))


def test_ring_that_does_not_fit_raises_with_its_size(monkeypatch):
    monkeypatch.setattr(workers_mod, "shm_free_bytes", lambda: 1000)
    with pytest.raises(RuntimeError, match=r"of 73728 bytes .* 1000 bytes "
                                           r"free"):
        workers_mod.WorkerPool(port_cfg(), num_workers=1)  # 4 slots


def corrupt(roidb, i):
    """Record ``i`` reads a file that does not exist (both packages
    raise), replaced in a copy of the list before any loader sees it."""
    bad = {k: v for k, v in roidb[i].items() if k != "image_array"}
    bad["image"] = "/nonexistent/missing.png"
    roidb = list(roidb)
    roidb[i] = bad
    return roidb


@pytest.mark.parametrize("kind", sorted(LOADERS))
@pytest.mark.parametrize("workers", [0, 2])
def test_bad_record_substituted_as_jax_substitutes_it(kind, workers,
                                                      tmp_path):
    """The in-order plan with record 3 bad: the port's batches equal the
    JAX ``_load_record_isolated`` samples of the same plan (record 4 in
    its place, and with it record 4's proposals), and one
    ``loader/bad_record`` is counted."""
    port_cls, jax_cls, props = LOADERS[kind]
    roidb = corrupt(tiny_roidb(proposals=props), 3)
    jcfg = jax_cfg()
    j, sample = j_loader._load_record_isolated(roidb, 3, jcfg, (64, 96))
    assert j == 4
    want = snapshot(jax_cls(roidb, jcfg, 2, shuffle=False))
    sink = telemetry.configure(str(tmp_path), stream=False)
    try:
        got = run_port(port_cls(roidb, port_cfg(workers), 2, shuffle=False))
        counted = sink.summary()["counters"].get("loader/bad_record")
    finally:
        telemetry.shutdown()
    assert counted == 1
    assert_batches_equal(got, want)
    order = [int(i) for chunk, _ in port_cls(
        roidb, port_cfg(), 2, shuffle=False)._epoch_plan() for i in chunk]
    b, r = divmod(order.index(3), 2)
    for k, v in sample.items():
        np.testing.assert_array_equal(got[b][k][r], v)


@pytest.mark.parametrize("workers", [0, 2])
def test_consecutive_bad_records_raise_systemic(workers, monkeypatch):
    monkeypatch.setattr(t_loader, "MAX_CONSECUTIVE_BAD_RECORDS", 3)
    roidb = tiny_roidb()
    for i in range(len(roidb)):
        roidb = corrupt(roidb, i)
    with pytest.raises(RuntimeError, match="systemic"):
        run_port(t_loader.AnchorLoader(roidb, port_cfg(workers), 2))
    state = [0]
    with pytest.raises(RuntimeError, match="3 consecutive"):
        t_loader._load_record_isolated(roidb, 0, port_cfg(), (64, 96),
                                       state=state)
    assert state == [3]


def test_prepare_matches_stage_raw_to_bucket():
    cfg = port_cfg()
    pool = workers_mod.WorkerPool(cfg, num_workers=1)
    try:
        rng = np.random.RandomState(0)
        for shape in [(50, 70, 3), (70, 50, 3), (130, 200, 3)]:
            img = rng.randint(0, 256, shape, np.uint8)
            got = pool.prepare(img, cfg.tpu.SCALES[0], timeout=30)
            want = stage_raw_to_bucket(img, cfg.tpu.SCALES[0], 16)
            assert len(got) == len(want) == 4
            for a, b in zip(got, want):
                assert np.asarray(a).dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a, b)
    finally:
        pool.close()
    assert not os.path.exists(shm_path(pool.shm_name))
