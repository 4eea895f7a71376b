"""The serving layer of the PyTorch port without a model, on the CPU.

The batcher mechanics of ``tests/test_serve.py`` (bucket routing, padding
of partial batches and unmasking of responses, full-beats-partial flush
order, backpressure, deadlines, the stdio statuses) and the engine and
controller tests of ``tests/test_slo.py`` (latency histograms, bucket
policy, admission limit, the control law through the injectable-``now``
``tick``, decisions as telemetry, start/stop) run against the port's
``ServeEngine`` over a fake predictor that returns torch tensors, in both
forward modes where the mode matters.  The port's ``Hist``,
``prometheus_text``, JSONL event stream and ``TraceContext`` are held
against the JAX modules on the same inputs: equal bucket counts and
quantiles, equal exposition bytes, the JAX report fold of the port's
events equal to the port's summary, equal parsed headers.
"""

import dataclasses
import io
import json
import time

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.telemetry import Hist as JHist
from mx_rcnn_tpu.telemetry.obs import prometheus_text as j_prometheus_text
from mx_rcnn_tpu.telemetry.report import aggregate, load_events
from mx_rcnn_tpu.telemetry.tracectx import TraceContext as JTraceContext

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data.image import stage_raw_to_bucket
from mx_rcnn_tpu_torch.serve import (ControllerOptions, DeadlineExceededError,
                                     RejectedError, ServeEngine, ServeOptions,
                                     SLOController, run_stdio, warmup)
from mx_rcnn_tpu_torch.serve.frontend import handle_request_doc
from mx_rcnn_tpu_torch.telemetry import HIST_LE, Hist
from mx_rcnn_tpu_torch.telemetry.obs import engine_summary, prometheus_text
from mx_rcnn_tpu_torch.telemetry.tracectx import TraceContext

torch.set_num_threads(2)

MODES = ["host_nms", "e2e"]


@pytest.fixture(autouse=True)
def _restore_sinks():
    yield
    telemetry.shutdown()


def tiny_cfg():
    """tests/test_serve.py's tiny config."""
    cfg = generate_config("resnet50", "PascalVOC",
                          TEST__RPN_PRE_NMS_TOP_N=300,
                          TEST__RPN_POST_NMS_TOP_N=32)
    net = dataclasses.replace(cfg.network, ANCHOR_SCALES=(2, 4))
    tpu = dataclasses.replace(cfg.tpu, SCALES=((96, 128),), MAX_GT=8)
    return cfg.replace(network=net, tpu=tpu)


class FakePredictor:
    """The predictor surface the engine calls, with torch tensors and no
    model.  Each batch row gets one detection scored by a smooth function
    of its staged pixels' mean, so a response's score tells WHICH image
    filled its row.  ``fail`` makes the next call raise."""

    R = 4

    def __init__(self, cfg, delay_s=0.0):
        self.cfg = cfg
        self.delay_s = delay_s
        self.batches = []  # staged shape of every call, in order
        self.calls = {"put": 0, "predict": 0, "fetch": 0}
        self.fail = None

    @staticmethod
    def row_score(staged):
        # inside (TEST.THRESH, 1), distinct for distinct means
        return float(np.tanh(np.asarray(staged, np.float64).mean() / 100)
                     * 0.4 + 0.5)

    def put_staged(self, staged, raw_hw, ratio, im_info):
        self.calls["put"] += 1
        return (torch.from_numpy(np.asarray(staged)),
                torch.from_numpy(np.asarray(raw_hw)),
                torch.from_numpy(np.asarray(ratio)),
                torch.from_numpy(np.asarray(im_info)))

    def _forward(self, staged):
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail is not None:
            err, self.fail = self.fail, None
            raise err
        self.calls["predict"] += 1
        self.batches.append(tuple(staged.shape))
        return [self.row_score(s.numpy()) for s in staged]

    def predict_staged(self, staged, raw_hw, ratio, im_info):
        scores_b = self._forward(staged)
        b, r, k = staged.shape[0], self.R, self.cfg.NUM_CLASSES
        rois = torch.zeros(b, r, 4)
        rois[:, :, 2:] = 16.0
        valid = torch.zeros(b, r, dtype=torch.bool)
        valid[:, 0] = True
        scores = torch.zeros(b, r, k)
        scores[:, 0, 1] = torch.tensor(scores_b)
        return rois, valid, scores, torch.zeros(b, r, 4 * k), None

    def predict_serve_e2e(self, staged, raw_hw, ratio, im_info, flip,
                          max_per_image, thresh):
        scores_b = self._forward(staged)
        b = staged.shape[0]
        dets = torch.zeros(b, max_per_image, 6)
        dets[:, 0] = torch.tensor([[0.0, 0.0, 16.0, 16.0, s, 1.0]
                                   for s in scores_b])
        valid = torch.zeros(b, max_per_image, dtype=torch.bool)
        valid[:, 0] = True
        return dets, valid

    def fetch(self, t):
        self.calls["fetch"] += 1
        return t.numpy()


def make_engine(cfg, mode="host_nms", **opts):
    defaults = dict(batch_size=4, max_delay_ms=1.0, max_queue=16,
                    serve_e2e=mode == "e2e")
    defaults.update(opts)
    return ServeEngine(FakePredictor(cfg), cfg, ServeOptions(**defaults))


def raw_image(h, w, value):
    return np.full((h, w, 3), value, np.uint8)


def staged_of(img, cfg):
    return stage_raw_to_bucket(img, cfg.tpu.SCALES[0], 16)[0]


# -- batcher mechanics -------------------------------------------------------


def test_bucket_routing_two_orientations():
    cfg = tiny_cfg()
    engine = make_engine(cfg)
    land, port = engine.bucket_key(60, 100), engine.bucket_key(100, 60)
    assert land == (port[1], port[0]) == (96, 128)
    # not started: submissions park in their queues
    engine.submit(raw_image(60, 100, 50))
    engine.submit(raw_image(100, 60, 50))
    engine.submit(raw_image(50, 90, 50))
    m = engine.metrics()
    assert m["queue_depth"] == 3
    assert m["buckets"] == {"96x128": 2, "128x96": 1}
    fut = engine.submit(raw_image(60, 100, 50))
    engine.stop()  # fails whatever is still queued
    with pytest.raises(RejectedError, match="stopped"):
        fut.result(timeout=5)


def test_submit_rejects_bad_images_and_unported_options():
    cfg = tiny_cfg()
    engine = make_engine(cfg)
    with pytest.raises(ValueError, match="RGB"):
        engine.submit(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        engine.submit(np.zeros((4, 4, 3), np.float32))
    engine.stop()
    with pytest.raises(ValueError, match="prep_workers"):
        ServeOptions(prep_workers=-1)
    with pytest.raises(ValueError, match="max_queue"):
        ServeOptions(batch_size=4, max_queue=2)


@pytest.mark.parametrize("mode", MODES)
def test_partial_batch_padded_and_responses_unmasked(mode):
    cfg = tiny_cfg()
    engine = make_engine(cfg, mode, batch_size=4, max_delay_ms=1.0)
    fake = engine.predictor
    imgs = [raw_image(60, 100, v) for v in (40, 120, 200)]
    futs = [engine.submit(im) for im in imgs]  # before start: one batch
    engine.start()
    try:
        results = [f.result(timeout=30) for f in futs]
    finally:
        engine.stop()
    # one call, padded to the full batch with repeats of the last image
    assert fake.batches == [(4, 96, 128, 3)]
    # each response carries its own image's score; the padding rows none
    for img, dets in zip(imgs, results):
        assert len(dets) == 1
        assert abs(dets[0]["score"]
                   - fake.row_score(staged_of(img, cfg))) < 1e-6
    assert engine.counters["served"] == 3
    assert engine.counters["batches"] == 1
    # one transfer, one call, one readback for the batch
    assert fake.calls == {"put": 1, "predict": 1, "fetch": 1}
    c = engine.counters
    assert (c["h2d_transfers"], c["dispatches"], c["readbacks"]) == (1, 1, 1)
    k = cfg.NUM_CLASSES
    row = 7 * cfg.TEST.MAX_PER_IMAGE if mode == "e2e" else \
        FakePredictor.R * (5 + 5 * k)
    assert c["readback_bytes"] == 4 * 4 * row


@pytest.mark.parametrize("mode", MODES)
def test_full_bucket_flushes_before_older_partial(mode):
    cfg = tiny_cfg()
    engine = make_engine(cfg, mode, batch_size=4, max_delay_ms=300.0)
    fake = engine.predictor
    older = engine.submit(raw_image(60, 100, 50))       # landscape, partial
    full = [engine.submit(raw_image(100, 60, 50)) for _ in range(4)]
    engine.start()
    try:
        for f in full:
            f.result(timeout=30)
        older.result(timeout=30)  # flushes at the max-delay deadline
    finally:
        engine.stop()
    # the full portrait bucket flushed first though the landscape request
    # queued first; the partial flushed on its deadline
    assert fake.batches == [(4, 128, 96, 3), (4, 96, 128, 3)]


def test_backpressure_rejects_when_queue_full():
    cfg = tiny_cfg()
    engine = make_engine(cfg, batch_size=2, max_queue=4)
    for _ in range(4):  # not started: nothing drains
        engine.submit(raw_image(60, 100, 50))
    with pytest.raises(RejectedError, match="queue full"):
        engine.submit(raw_image(60, 100, 50))
    assert engine.counters["rejected"] == 1
    assert engine.counters["requests"] == 4
    engine.stop()


def test_request_deadline_expires_without_forward():
    cfg = tiny_cfg()
    engine = make_engine(cfg)
    fake = engine.predictor
    fut = engine.submit(raw_image(60, 100, 50), deadline_ms=1.0)
    time.sleep(0.05)  # expire before the engine drains
    engine.start()
    try:
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=10)
        assert engine.counters["deadline_exceeded"] == 1
        assert fake.batches == []  # no forward for an expired request
    finally:
        engine.stop()


@pytest.mark.parametrize("mode", MODES)
def test_failing_batch_fails_its_futures_and_serving_goes_on(mode):
    """A batch that raises sets the error on every future of the batch —
    no retry and no other route — and the next batch is served."""
    cfg = tiny_cfg()
    engine = make_engine(cfg, mode, batch_size=2, max_delay_ms=1.0)
    fake = engine.predictor
    fake.fail = RuntimeError("kernel launch failed")
    futs = [engine.submit(raw_image(60, 100, v)) for v in (10, 20)]
    engine.start()
    try:
        for f in futs:
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                f.result(timeout=30)
        assert fake.calls["predict"] == 0
        ok = engine.submit(raw_image(60, 100, 30)).result(timeout=30)
    finally:
        engine.stop()
    assert len(ok) == 1 and fake.calls["predict"] == 1
    assert engine.counters["batches"] == 1


def test_drain_and_resume():
    cfg = tiny_cfg()
    engine = make_engine(cfg, batch_size=2, max_delay_ms=1.0).start()
    try:
        engine.mark_ready()
        assert engine.readiness()["ready"]
        fut = engine.submit(raw_image(60, 100, 50))
        assert engine.drain(timeout=10)
        assert fut.done() and not engine.readiness()["ready"]
        with pytest.raises(RejectedError, match="draining"):
            engine.submit(raw_image(60, 100, 50))
        engine.resume()
        assert engine.readiness()["ready"]
        assert len(engine.submit(raw_image(60, 100, 50)).result(30)) == 1
    finally:
        engine.stop()
    assert not engine.readiness()["ready"]


def test_stdio_frontend_statuses():
    cfg = tiny_cfg()
    engine = make_engine(cfg, batch_size=1, max_delay_ms=0.0).start()
    img = raw_image(40, 60, 120)
    inp = io.StringIO("this is not json\n"
                      + json.dumps({"pixels": img.tolist()}) + "\n"
                      + json.dumps({"shape": [2, 2]}) + "\n")
    out = io.StringIO()
    try:
        run_stdio(engine, inp, out)
    finally:
        engine.stop()
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [d["status"] for d in lines] == [400, 200, 400]
    assert lines[1]["detections"] and "queue_wait_ms" in lines[1]


@pytest.mark.parametrize("mode", MODES)
def test_batch_row_reaches_future_and_response(mode):
    """Each request learns the row of the batch it filled, and the
    frontend's 200 doc carries it beside the echoed client trace id."""
    cfg = tiny_cfg()
    engine = make_engine(cfg, mode, batch_size=4, max_delay_ms=1.0)
    futs = [engine.submit(raw_image(60, 100, v)) for v in (40, 120, 200)]
    engine.start()
    try:
        for f in futs:
            f.result(timeout=30)
        status, doc = handle_request_doc(
            engine, {"pixels": raw_image(60, 100, 9).tolist()},
            trace_header="0123456789abcdef0123456789abcdef-00000000000000ab")
    finally:
        engine.stop()
    assert [f.batch_row for f in futs] == [0, 1, 2]
    assert status == 200 and doc["batch_row"] == 0
    assert doc["trace"] == "0123456789abcdef0123456789abcdef"
    assert len(doc["detections"]) == 1


@pytest.mark.parametrize("mode", MODES)
def test_engine_registry_counts_each_program_once(mode):
    """The engine's registry holds one program per (kind, bucket shape):
    warmup first-dispatches both orientations, records their wall time,
    and traffic on the same shapes adds none; ``/metrics`` serves the
    snapshot."""
    cfg = tiny_cfg()
    engine = make_engine(cfg, mode, batch_size=2, max_delay_ms=1.0).start()
    try:
        assert warmup(engine) == 2
        for hw in ((60, 100), (100, 60), (48, 90)):
            engine.submit(raw_image(*hw, 70)).result(timeout=30)
    finally:
        engine.stop()
    kind = "serve_e2e" if mode == "e2e" else "predict"
    snap = engine.metrics()["compile"]
    assert snap["counters"] == {"programs": 2}
    assert {p["kind"] for p in snap["programs"]} == {kind}
    assert {tuple(p["shape"][:4]) for p in snap["programs"]} == \
        {(2, 96, 128, 3), (2, 128, 96, 3)}
    assert snap["compile_seconds"]["count"] == 2
    assert engine.counters["recompiles"] == \
        engine.counters["warmup_programs"] == 2


# -- engine latency / policy surface -----------------------------------------


def test_engine_records_latency_hists_and_metrics():
    cfg = tiny_cfg()
    engine = make_engine(cfg, batch_size=2, max_delay_ms=1.0).start()
    try:
        futs = [engine.submit(raw_image(60, 100, 50)) for _ in range(4)]
        for f in futs:
            f.result(timeout=30)
    finally:
        engine.stop()
    assert engine.hists["serve/request_time"].count == 4
    assert engine.hists["serve/queue_wait"].count == 4
    assert engine.hists["serve/host_prep"].count == 4
    assert engine.hists["serve/service_time"].count >= 1
    hists = engine.latency_hists()
    assert hists["serve/request_time/96x128"].count == 4
    m = engine.metrics()
    assert m["latency"]["request_time_p99_ms"] > 0
    assert m["latency"]["request_time_p50_ms"] <= \
        m["latency"]["request_time_p99_ms"]
    summ = engine_summary(engine)
    assert summ["hists"]["serve/request_time"]["count"] == 4
    assert summ["counters"]["serve/images"] == 4
    txt = prometheus_text({0: summ})
    assert "mxr_serve_request_time_seconds_bucket" in txt
    assert 'mxr_serve_request_time_seconds_count{rank="0"} 4' in txt


def test_bucket_policy_clamps_and_flush_threshold():
    cfg = tiny_cfg()
    engine = make_engine(cfg, batch_size=4, max_delay_ms=300.0)
    fake = engine.predictor
    key = engine.bucket_key(60, 100)
    engine.set_bucket_policy(key, max_batch=99, max_delay_ms=-5)
    assert engine.bucket_policy(key) == (4, 0.0)  # clamped both ways
    engine.set_bucket_policy(key, max_batch=2, max_delay_ms=300.0)
    assert engine.bucket_policy(key) == (2, 300.0)
    # two requests now flush "full", padded to the program's batch of 4
    futs = [engine.submit(raw_image(60, 100, v)) for v in (40, 200)]
    engine.start()
    try:
        for f in futs:
            f.result(timeout=30)
    finally:
        engine.stop()
    assert fake.batches == [(4, 96, 128, 3)]
    assert engine.counters["served"] == 2


def test_admit_limit_sheds_distinct_from_queue_full():
    cfg = tiny_cfg()
    engine = make_engine(cfg, batch_size=2, max_queue=8)
    engine.set_admit_limit(2)
    for _ in range(2):
        engine.submit(raw_image(60, 100, 50))
    with pytest.raises(RejectedError, match="load shed"):
        engine.submit(raw_image(60, 100, 50))
    assert engine.counters["shed"] == 1
    assert engine.counters["rejected"] == 0
    engine.set_admit_limit(None)
    engine.submit(raw_image(60, 100, 50))
    assert engine.counters["requests"] == 3
    engine.stop()


# -- the SLO controller -------------------------------------------------------


def _controller(engine, **kw):
    kw.setdefault("target_p99_ms", 100.0)
    kw.setdefault("min_samples", 4)
    kw.setdefault("relax_after", 1)
    ctrl = SLOController(engine, ControllerOptions(**kw))
    engine.controller = ctrl  # what start() does, without the thread
    return ctrl


def test_controller_tightens_then_relaxes():
    cfg = tiny_cfg()
    engine = make_engine(cfg, batch_size=4, max_delay_ms=20.0)
    key = engine.bucket_key(60, 100)
    engine.submit(raw_image(60, 100, 50))  # make the bucket known
    ctrl = _controller(engine, window_s=10.0)
    for i in range(10):
        engine.hists["serve/request_time"].observe(0.5, now=float(i))
    acted = ctrl.tick(now=10.0)
    assert any(a[0] == "tighten" for a in acted)
    assert engine.bucket_policy(key) == (3, 10.0)  # -1 batch, delay halved
    ctrl.tick(now=10.5)
    assert engine.bucket_policy(key)[0] == 2
    for t in range(11, 30):
        engine.hists["serve/request_time"].observe(0.5, now=float(t))
        ctrl.tick(now=float(t))
    assert engine.bucket_policy(key) == (1, 0.0)
    assert ctrl.tick(now=30.0) == []  # at the floor: no more decisions
    for t in range(100, 110):
        engine.hists["serve/request_time"].observe(0.001, now=float(t))
    for t in range(110, 140):
        ctrl.tick(now=float(t))
    assert engine.bucket_policy(key) == (4, 20.0)
    assert ctrl.decisions > 0 and ctrl.ticks > 0
    engine.stop()


def test_controller_sheds_on_queue_trend_and_recovers(tmp_path):
    telemetry.configure(str(tmp_path), run_meta={"driver": "t"})
    cfg = tiny_cfg()
    engine = make_engine(cfg, batch_size=2, max_queue=16)
    ctrl = _controller(engine, window_s=5.0)
    shed_err = None
    for t in range(4):
        for _ in range(3):
            try:
                engine.submit(raw_image(60, 100, 50))
            except RejectedError as e:
                shed_err = e
        ctrl.tick(now=float(t))
    assert ctrl.state()["shedding"] is True
    assert engine.metrics()["admit_limit"] == 2  # max(batch_size, 0)
    assert shed_err is not None and "load shed" in str(shed_err)
    assert engine.counters["shed"] >= 1
    flight = [json.loads(ln) for ln in
              (tmp_path / "flight_0.jsonl").read_text().splitlines()]
    assert any(e["kind"] == "meta" and e["name"] == "flight_trigger"
               and e["fields"]["reason"] == "slo_shed" for e in flight)
    summ = telemetry.get().summary()
    assert summ["counters"]["slo/shed_on"] == 1
    assert summ["counters"]["slo/decisions"] >= 1
    with engine._lock:
        for q in engine._queues.values():
            q.clear()
    for t in range(100, 104):
        ctrl.tick(now=float(t))
    assert ctrl.state()["shedding"] is False
    assert engine.metrics()["admit_limit"] is None
    assert telemetry.get().summary()["counters"]["slo/shed_off"] == 1
    engine.submit(raw_image(60, 100, 50))
    engine.stop()


def test_controller_decisions_are_telemetry_events(tmp_path):
    """The decisions land in the port's JSONL stream, which the JAX
    package's report tools read and fold."""
    telemetry.configure(str(tmp_path), run_meta={"driver": "t"})
    cfg = tiny_cfg()
    engine = make_engine(cfg, batch_size=4, max_delay_ms=20.0)
    engine.submit(raw_image(60, 100, 50))
    ctrl = _controller(engine)
    for i in range(10):
        engine.hists["serve/request_time"].observe(0.5, now=float(i))
    ctrl.tick(now=10.0)
    telemetry.shutdown()
    events = load_events([str(tmp_path)])
    decisions = [e for e in events
                 if e["kind"] == "meta" and e["name"] == "slo_decision"]
    assert decisions and decisions[0]["fields"]["action"] == "tighten"
    assert decisions[0]["fields"]["bucket"] == "96x128"
    folded = aggregate(events)
    assert folded["counters"]["slo/tighten"] >= 1
    assert "slo/p99_ms" in folded["gauges"]
    m = engine.metrics()
    assert m["controller"]["ticks"] == 1
    assert m["controller"]["target_p99_ms"] == 100.0
    assert m["policy"]
    summ = engine_summary(engine)
    assert "slo/target_p99_ms" in summ["gauges"]
    assert any(k.startswith("slo/bucket_") for k in summ["gauges"])
    engine.stop()


def test_controller_start_stop_restores_policy():
    cfg = tiny_cfg()
    engine = make_engine(cfg, batch_size=4, max_delay_ms=20.0)
    key = engine.bucket_key(60, 100)
    engine.submit(raw_image(60, 100, 50))
    ctrl = SLOController(engine, ControllerOptions(
        target_p99_ms=100.0, interval_s=30.0)).start()  # no tick fires
    assert engine.controller is ctrl
    engine.set_bucket_policy(key, max_batch=1, max_delay_ms=0.0)
    engine.set_admit_limit(2)
    ctrl.stop()
    assert engine.controller is None
    assert engine.bucket_policy(key) == (4, 20.0)
    assert engine.metrics()["admit_limit"] is None
    engine.stop()


# -- telemetry against the JAX modules ---------------------------------------


def _observations():
    rng = np.random.RandomState(3)
    vals = np.concatenate([rng.lognormal(-4, 1.5, 300), [0.0, 1e-9, 1e9],
                           HIST_LE[:6], [HIST_LE[5] * 1.0001]])
    return [float(v) for v in vals]


def test_hist_quantiles_and_to_dict_match_jax():
    """Same observations, same injected clock: identical buckets, sums,
    quantiles, windowed quantiles and merges (exact equality — both are
    the same float arithmetic on the same HIST_LE)."""
    vals = _observations()
    h, jh = Hist(), JHist()
    for i, v in enumerate(vals):
        h.observe(v, now=i * 0.1)
        jh.observe(v, now=i * 0.1)
    assert h.to_dict() == jh.to_dict()
    assert h.buckets[0] >= 2 and h.buckets[-1] == 1
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
        for window in (1.0, 5.0, 100.0):
            now = len(vals) * 0.1
            assert h.window_quantile(q, window, now=now) == \
                jh.window_quantile(q, window, now=now)
    merged = Hist.from_dict(jh.to_dict()).merge(h)
    jmerged = JHist.from_dict(h.to_dict()).merge(jh)
    assert merged.to_dict() == jmerged.to_dict()
    assert Hist().quantile(0.5) is None


def test_prometheus_text_and_event_stream_match_jax(tmp_path):
    """A summary recorded by the port's sink renders to the same bytes as
    the JAX renderer gives for it, and the JAX report fold of the port's
    event stream reproduces that summary."""
    tel = telemetry.configure(str(tmp_path), run_meta={"driver": "t"})
    for i, v in enumerate(_observations()[:50]):
        tel.observe("serve/request_time", v)
        tel.add("serve/forward", v / 2)
        tel.gauge("serve/queue_depth", i % 7)
    tel.counter("serve/batches", 5)
    tel.counter("serve/recompile")
    with tel.span("serve/readback"):
        pass
    summ = tel.summary()
    per_rank = {0: summ, 3: summ}
    ages = {3: 1.25}
    assert prometheus_text(per_rank, ages) == \
        j_prometheus_text(per_rank, ages)
    telemetry.shutdown()
    folded = aggregate(load_events([str(tmp_path)]))
    assert folded["hists"]["serve/request_time"] == \
        summ["hists"]["serve/request_time"]
    assert folded["counters"] == summ["counters"]


HEADERS = ["0123456789abcdef0123456789abcdef",
           "0123456789abcdef0123456789abcdef-0123456789abcdef",
           "0123456789abcdef0123456789abcdef-0123456789abcdef-00",
           "0123456789abcdef0123456789abcdef-0000000000000000-01",
           "ABCDEF0123456789", "  deadbeef  ", "deadbeef-xyz", "short",
           "a-b-c-d", "", None, 42,
           "0123456789abcdef0123456789abcdef-0123456789abcdef-01-99"]


@pytest.mark.parametrize("value", HEADERS)
def test_trace_context_header_matches_jax(value):
    got, want = TraceContext.parse(value), JTraceContext.parse(value)
    if want is None:
        assert got is None
        return
    assert (got.trace_id, got.span_id, got.sampled) == \
        (want.trace_id, want.span_id, want.sampled)
    assert got.to_header() == want.to_header()


def test_trace_context_round_trips_across_packages():
    ctx = TraceContext.mint().child()
    back = JTraceContext.parse(ctx.to_header())
    assert (back.trace_id, back.span_id, back.sampled) == \
        (ctx.trace_id, ctx.span_id, True)
    jctx = JTraceContext.mint(sampled=False)
    mine = TraceContext.parse(jctx.to_header())
    assert (mine.trace_id, mine.span_id, mine.sampled) == \
        (jctx.trace_id, None, False)
