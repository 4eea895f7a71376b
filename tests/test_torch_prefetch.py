"""The prefetch thread (``data/loader.py:_Prefetcher``) and its hooks, on
the CPU.

* The producer's exception is raised on the consumer's side; a stalled
  producer trips the watchdog (1 s here) with a ``prefetch_watchdog``
  flight dump; ``close()`` joins the thread; depth 0 reads on the
  consumer's thread.
* ``CappedLoader`` closes the epoch it cuts short: no producer thread is
  left, and with workers every ring slot is back; ``close_workers`` leaves
  no process and no segment.
* ``fit`` (``device="cpu"``) copies each batch once, through the loader's
  ``put`` hook on the prefetch thread; ``pred_eval`` with the prefetch
  thread gives the serial loop's detections bitwise; both refuse a loader
  without a ``put`` hook; the loaders read on the consumer's thread unless
  given a depth (the port's ``tpu.PREFETCH`` default is 0).
* The serve engine's prep pool: host-NMS requests staged in the workers
  answer as those staged on the caller's thread; ``serve_e2e`` stages on
  the caller's thread; ``stop()`` ends the workers and unlinks the ring.

Every blocking wait has a bound.
"""

import dataclasses
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data import loader as t_loader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.eval import tester
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.tools.common import CappedLoader
from mx_rcnn_tpu_torch.train import trainer
from mx_rcnn_tpu_torch.utils.convert_jax import random_params
from tests import test_torch_eval_slice as eval_slice
from tests import test_torch_serve_engine as serve_engine
from tests import test_torch_train_step as train_step
from tests.test_torch_loader_workers import (port_cfg, shm_path, snapshot,
                                             tiny_roidb)

torch.set_num_threads(2)

BOUND_S = 10.0


def prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "loader-prefetch" and t.is_alive()]


def wait_until(cond, bound=BOUND_S):
    end = time.monotonic() + bound
    while not cond() and time.monotonic() < end:
        time.sleep(0.02)
    return cond()


def test_producer_exception_raised_on_the_consumer_side():
    def gen():
        yield 1
        yield 2
        raise ValueError("record 7 is corrupt")

    got = []
    with pytest.raises(ValueError, match="record 7"):
        for item in t_loader._Prefetcher(gen(), depth=2, watchdog_s=BOUND_S):
            got.append(item)
    assert got == [1, 2]


def test_stalled_producer_trips_the_watchdog(tmp_path):
    release = threading.Event()

    def gen():
        yield 1
        release.wait(BOUND_S)  # stuck, as on a hung filesystem read
        yield 2

    telemetry.configure(str(tmp_path), stream=False)
    p = t_loader._Prefetcher(gen(), depth=2, watchdog_s=1.0)
    try:
        assert p._get() == 1
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="producer thread alive"):
            p._get()
        assert 1.0 <= time.monotonic() - t0 < BOUND_S
    finally:
        release.set()
        p.close()
        telemetry.shutdown()
    assert not p._t.is_alive()
    with open(tmp_path / "flight_0.jsonl") as f:
        assert "prefetch_watchdog" in f.read()


def test_close_joins_the_producer_and_depth_zero_reads_inline():
    p = t_loader._Prefetcher(iter(range(100)), depth=2)
    it = iter(p)
    assert next(it) == 0
    p.close()
    assert not p._t.is_alive()
    threads = []
    it = t_loader._prefetched(iter(range(3)), 0,
                              lambda x: threads.append(
                                  threading.current_thread()) or x * 2, 0.0)
    assert list(it) == [0, 2, 4]
    assert threads == [threading.current_thread()] * 3


@pytest.mark.parametrize("workers", [0, 2])
def test_capped_loader_closes_the_epoch_it_cuts(workers):
    roidb = tiny_roidb()
    inner = t_loader.AnchorLoader(roidb, port_cfg(workers, tpu__PREFETCH=2),
                                  2, seed=1)
    capped = CappedLoader(inner, 2)
    want = snapshot(t_loader.AnchorLoader(roidb, port_cfg(), 2, seed=1))
    try:
        got = snapshot(capped)
        assert len(got) == 2
        for a, b in zip(got, want[:2]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        assert wait_until(lambda: not prefetch_threads())
        if workers:
            pool = inner._pool
            assert wait_until(lambda: pool._free.qsize() == pool.n_slots)
            assert not pool._pending
            name, procs = pool.shm_name, list(pool._procs)
    finally:
        capped.close_workers()
    if workers:
        assert wait_until(lambda: not any(p.is_alive() for p in procs))
        assert not os.path.exists(shm_path(name))


def test_fit_puts_each_batch_once_through_the_hook(monkeypatch):
    cfg = train_step.tiny(generate_config)
    cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, PREFETCH=2))
    ds = SyntheticDataset(num_images=2, num_classes=cfg.NUM_CLASSES,
                          height=train_step.H, width=train_step.W,
                          max_objects=3)
    roidb = ds.filter_roidb(ds.append_flipped_images(ds.gt_roidb()))
    calls = []
    real = trainer.batch_put

    def counting(batch, cfg_, device):
        calls.append(threading.current_thread().name)
        assert isinstance(batch["images"], np.ndarray)  # host, not yet put
        return real(batch, cfg_, device)

    monkeypatch.setattr(trainer, "batch_put", counting)
    # the cap at the epoch's length: every batch produced is consumed
    loader = CappedLoader(t_loader.AnchorLoader(roidb, cfg, 2, seed=0), 2)
    model = build_model(cfg)
    seen = []
    trainer.fit(cfg, model, random_params(model, seed=1), loader,
                end_epoch=1, device="cpu", frequent=1,
                batch_end_callback=lambda ep, step, m: seen.append(m))
    assert len(seen) == 2 and all(np.isfinite(m["total_loss"]) for m in seen)
    assert calls == ["loader-prefetch"] * 2
    assert loader._inner.put is not None
    assert wait_until(lambda: not prefetch_threads())


def test_fit_and_pred_eval_need_a_put_hook():
    """The ``put`` hook is part of the loader contract: a loader without
    one is refused before any work, not fed host batches."""
    batches = [{"images": np.zeros((1, 8, 8, 3), np.uint8)}]
    with pytest.raises(TypeError, match="no put hook"):
        trainer.fit(None, None, {}, batches, device="cpu")
    with pytest.raises(TypeError, match="no put hook"):
        tester.pred_eval(type("P", (), {"cfg": None})(), batches,
                         type("I", (), {"num_classes": 2, "num_images": 1})())


@pytest.mark.parametrize("kind", ["anchor", "test"])
def test_loaders_read_on_the_consumer_thread_by_default(kind):
    """The port's ``tpu.PREFETCH`` defaults to 0 (the JAX package's to 2):
    with it the loaders run their put hook on the consuming thread, and a
    depth given to them starts the prefetch thread."""
    cfg = eval_slice.tiny(generate_config)
    assert cfg.tpu.PREFETCH == 0
    ds = SyntheticDataset(num_images=2, num_classes=cfg.NUM_CLASSES,
                          height=64, width=96, max_objects=2)
    for depth, want in ((None, threading.current_thread().name),
                        (2, "loader-prefetch")):
        if kind == "test":
            loader = t_loader.TestLoader(ds.gt_roidb(), cfg, batch_size=1,
                                         prefetch=depth)
        else:
            c = cfg if depth is None else cfg.replace(
                tpu=dataclasses.replace(cfg.tpu, PREFETCH=depth))
            loader = t_loader.AnchorLoader(ds.gt_roidb(), c, 1, seed=0)
        threads = []
        loader.put = lambda b: threads.append(
            threading.current_thread().name) or b
        assert len(list(loader)) == 2
        assert threads == [want] * 2


def test_pred_eval_with_the_prefetch_thread_matches_serial(tmp_path):
    cfg = eval_slice.tiny(generate_config)
    ds = SyntheticDataset(num_images=4, num_classes=cfg.NUM_CLASSES,
                          height=128, width=192, max_objects=3)
    model = build_model(cfg)
    pred = tester.Predictor(model, random_params(model, seed=2), cfg,
                            device="cpu")
    real_put, threads = pred.batch_put, []

    def put(batch):
        threads.append(threading.current_thread().name)
        return real_put(batch)

    pred.batch_put = put
    out = {}
    for prefetch, inflight in ((0, 0), (2, 0), (2, 2)):
        path = str(tmp_path / f"dets-{prefetch}-{inflight}.pkl")
        threads.clear()
        loader = t_loader.TestLoader(ds.gt_roidb(), cfg, batch_size=2,
                                     prefetch=prefetch)
        stats = tester.pred_eval(pred, loader, ds, det_cache=path,
                                 inflight=inflight)
        assert stats["eval_pipeline"]["loader_wait_s"] >= 0.0
        assert threads == [threading.current_thread().name if prefetch == 0
                           else "loader-prefetch"] * 2
        with open(path, "rb") as f:
            out[prefetch, inflight] = pickle.load(f)
    want = out[0, 0]
    assert sum(len(b) for cls in want[1:] for b in cls) > 0
    for key in ((2, 0), (2, 2)):
        for k in range(1, len(want)):
            for a, b in zip(out[key][k], want[k], strict=True):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", serve_engine.MODES)
def test_serve_prep_pool(mode):
    cfg = serve_engine.tiny_cfg()
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, hw + (3,), np.uint8)
              for hw in ((60, 100), (100, 60), (200, 300), (70, 90))]

    def serve(workers):
        engine = serve_engine.make_engine(cfg, mode, batch_size=2,
                                          prep_workers=workers).start()
        pool, calls = engine._pool, []
        if pool is not None:
            real = pool.prepare
            pool.prepare = lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            futs = [engine.submit(im) for im in images]
            res = [f.result(timeout=BOUND_S) for f in futs]
        finally:
            engine.stop()
        return res, pool, len(calls)

    want, _, _ = serve(0)
    got, pool, calls = serve(2)
    assert got == want
    assert calls == (len(images) if mode == "host_nms" else 0)
    assert wait_until(lambda: pool.alive_workers() == 0)
    assert not os.path.exists(shm_path(pool.shm_name))
