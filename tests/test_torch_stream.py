"""Streams of the PyTorch port (``serve/stream.py``, ``POST /stream``,
``run_stream_stdio``) against the JAX package's ``StreamManager`` on the
same frames, on the CPU.

Both sides run over their fake predictors (``tests/test_torch_serve_
engine.py`` and ``tests/test_serve.py``): the gate only reads the staged
pixels, so the skip, refresh and bucket decisions, the gate's deltas and
the stream counters are held against JAX's; the detections are the
port's own (the fakes score rows differently).

* gate off: a stream is byte for byte the port's ``/predict`` path;
* a sequence that crosses ``skip_thresh`` (noise, a scene cut, an
  orientation flip, a static run past ``max_skip``): the same skipped
  flags, the same counters, ``frame_delta`` within 1e-5 relative of
  JAX's, the forced refresh at ``max_skip``; a skip moves no engine
  counter and no service-time observation;
* ``frame_delta`` alone against the JAX program on seeded buckets;
* a stale or repeated ``seq`` raises ``StaleSeqError`` (409 on
  ``/stream``), the high-water mark survives it;
* ``max_streams``: the stream beyond the table is rejected (503) until
  an idle one can be evicted, as in JAX;
* two streams' frames share batches: the coalescing counters equal
  JAX's, and each stream's replies keep its order;
* a generation change forces the full path;
* ``run_stream_stdio`` round trip, statuses and keys as JAX's.
"""

import io
import json
import threading

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.data.image import stage_raw_to_bucket as j_stage
from mx_rcnn_tpu.serve import RejectedError as JRejectedError
from mx_rcnn_tpu.serve import StaleSeqError as JStaleSeqError
from mx_rcnn_tpu.serve import StreamManager as JStreamManager
from mx_rcnn_tpu.serve import StreamOptions as JStreamOptions
from mx_rcnn_tpu.serve import run_stream_stdio as j_run_stream_stdio
from mx_rcnn_tpu.serve.stream import _build_frame_delta as j_frame_delta
from tests.test_serve import make_engine as j_make_engine
from tests.test_serve import tiny_cfg as j_tiny_cfg

from mx_rcnn_tpu_torch.serve import (RejectedError, StaleSeqError,
                                     StreamManager, StreamOptions,
                                     encode_image_payload, make_server,
                                     run_stream_stdio, unix_http_request)
from mx_rcnn_tpu_torch.serve.frontend import unix_http_request_raw
from mx_rcnn_tpu_torch.serve.stream import frame_delta
from tests.test_torch_serve_engine import make_engine, raw_image, tiny_cfg

torch.set_num_threads(2)

GATE_COUNTERS = ("frames", "forwarded", "skipped", "delta_dispatches",
                 "refreshes", "bucket_switches", "stale_seq", "evicted")


def pair(skip_thresh=3.0, max_skip=3, batch_size=2, **eng):
    """A started port engine + manager and a started JAX one, same
    options."""
    e = make_engine(tiny_cfg(), batch_size=batch_size, **eng).start()
    je = j_make_engine(j_tiny_cfg(), batch_size=batch_size, **eng).start()
    return (e, StreamManager(e, StreamOptions(skip_thresh=skip_thresh,
                                              max_skip=max_skip)),
            je, JStreamManager(je, JStreamOptions(skip_thresh=skip_thresh,
                                                  max_skip=max_skip)))


def sequence():
    """Frames crossing the threshold: noise under it, a cut over it, a
    static run past max_skip, an orientation flip and back."""
    rng = np.random.RandomState(4)
    base = rng.randint(40, 200, (60, 100, 3)).astype(np.uint8)
    noisy = base.copy()
    noisy[::2, ::2, 0] += 1
    cut = (255 - base).astype(np.uint8)
    port = rng.randint(40, 200, (100, 60, 3)).astype(np.uint8)
    return [base, noisy, base, noisy, base, base, cut, cut, port, port,
            base, base]


def test_gate_off_stream_byte_identical_to_predict():
    cfg = tiny_cfg()
    rng = np.random.RandomState(3)
    frames = [rng.randint(0, 255, (60, 100, 3), dtype=np.uint8)
              for _ in range(4)]
    plain = make_engine(cfg, mode="e2e").start()
    try:
        expect = [plain.submit(f).result(timeout=60) for f in frames]
    finally:
        plain.stop()
    engine = make_engine(cfg, mode="e2e").start()
    mgr = StreamManager(engine)
    try:
        assert not mgr.gate_enabled and mgr.warmup() == 0
        results = [mgr.submit_frame("cam", i + 1, f)
                   for i, f in enumerate(frames)]
        got = [r.result(timeout=60) for r in results]
    finally:
        engine.stop()
    assert json.dumps(got, sort_keys=True) == json.dumps(expect,
                                                         sort_keys=True)
    assert all(r.skipped is False and r.delta is None for r in results)
    assert mgr.counters["forwarded"] == 4 and mgr.counters["skipped"] == 0
    assert engine.registry.counters["programs"] == 1  # the forward only


def test_skip_and_refresh_decisions_equal_jax():
    e, m, je, jm = pair(skip_thresh=3.0, max_skip=3)
    try:
        assert m.warmup() == jm.warmup() == 2
        out, jout = [], []
        for seq, img in enumerate(sequence(), 1):
            base = dict(e.counters)
            svc = e.hists["serve/service_time"].count
            r, jr = m.submit_frame("cam", seq, img), jm.submit_frame(
                "cam", seq, img)
            r.result(timeout=60)
            jr.result(timeout=60)
            if r.skipped:  # a skip is invisible to the engine
                assert dict(e.counters) == base
                assert e.hists["serve/service_time"].count == svc
                assert r.queue_wait_s is None
            out.append(r)
            jout.append(jr)
    finally:
        e.stop()
        je.stop()
    assert [r.skipped for r in out] == [r.skipped for r in jout]
    assert [r.skipped for r in out] == [False, True, True, True, False,
                                        True, False, True, False, True,
                                        False, True]
    for r, jr in zip(out, jout):
        assert (r.delta is None) == (jr.delta is None)
        if r.delta is not None:
            assert abs(r.delta - jr.delta) <= 1e-5 * max(jr.delta, 1e-30)
    for key in GATE_COUNTERS:
        assert m.counters[key] == jm.counters[key], key
    assert m.counters["refreshes"] == 1        # frame 5, after 3 skips
    assert out[4].delta is None                 # refreshed before the gate
    assert m.counters["bucket_switches"] == 2
    assert m.metrics()["skip_fraction"] == jm.metrics()["skip_fraction"]
    kinds = {p["kind"] for p in e.registry.snapshot()["programs"]}
    assert kinds == {"frame_delta", "predict"}
    assert e.counters["recompiles"] == 2        # the forwards, not the gate


def test_frame_delta_matches_jax_program():
    rng = np.random.RandomState(9)
    jfn = j_frame_delta()
    for hw in ((60, 100), (100, 60), (500, 375)):
        a = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
        b = np.clip(a.astype(np.int16) + rng.randint(-9, 10, a.shape),
                    0, 255).astype(np.uint8)
        sa, _, _, _ = j_stage(a, (96, 128), 16)
        sb, _, _, _ = j_stage(b, (96, 128), 16)
        got = float(frame_delta(torch.from_numpy(sa), torch.from_numpy(sb)))
        want = float(jfn(sa, sb))
        assert abs(got - want) <= 1e-5 * want, (hw, got, want)
        assert float(frame_delta(torch.from_numpy(sa),
                                 torch.from_numpy(sa))) == 0.0


def test_stale_seq_raises_and_is_409_on_http(tmp_path):
    e, m, je, jm = pair()
    sock = str(tmp_path / "s.sock")
    server = make_server(e, unix_socket=sock, stream=m)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        img = raw_image(60, 100, 80)
        for mgr, err in ((m, StaleSeqError), (jm, JStaleSeqError)):
            mgr.submit_frame("cam", 5, img).result(timeout=60)
            for bad in (5, 3):
                with pytest.raises(err):
                    mgr.submit_frame("cam", bad, img)
            mgr.submit_frame("cam", 6, img).result(timeout=60)
        for key in ("stale_seq", "frames"):
            assert m.counters[key] == jm.counters[key] == 2
        frame = dict(encode_image_payload(img), stream_id="web")
        lines = [json.dumps(dict(frame, seq=1)),
                 json.dumps(dict(frame, seq=2)),
                 "not json {",
                 json.dumps(dict(frame, seq=2)),
                 json.dumps({"seq": 3})]
        status, raw, ctype = unix_http_request_raw(
            sock, "POST", "/stream", "\n".join(lines).encode())
        assert status == 200 and "ndjson" in ctype
        replies = [json.loads(ln) for ln in raw.decode().splitlines()]
        assert [r["status"] for r in replies] == [200, 200, 400, 409, 400]
        assert replies[1]["skipped"] is True and replies[1]["delta"] < 3.0
        assert replies[1]["detections"] == replies[0]["detections"]
        status, metrics = unix_http_request(sock, "GET", "/metrics")
        assert metrics["stream"]["counters"]["stale_seq"] == 3
        status, prom = unix_http_request(sock, "GET", "/metrics?format=prom")
        assert status == 200 and "mxr_stream_skipped_total" in prom
    finally:
        server.shutdown()
        server.server_close()
        e.stop()
        je.stop()


def test_max_streams_eviction_and_503_as_jax(tmp_path):
    e = make_engine(tiny_cfg(), batch_size=2).start()
    je = j_make_engine(j_tiny_cfg(), batch_size=2).start()
    sock = str(tmp_path / "m.sock")
    server = None
    try:
        outcomes = {}
        for side, eng, mgr_cls, opt_cls, rej in (
                ("port", e, StreamManager, StreamOptions, RejectedError),
                ("jax", je, JStreamManager, JStreamOptions, JRejectedError)):
            mgr = mgr_cls(eng, opt_cls(max_streams=2, idle_ttl_s=3600.0))
            img = raw_image(60, 100, 30)
            got = []
            for sid in ("a", "b", "c"):
                try:
                    mgr.submit_frame(sid, 1, img).result(timeout=60)
                    got.append("ok")
                except rej:
                    got.append("503")
            # an idle stream becomes evictable: the new one gets its slot
            mgr.opts = opt_cls(max_streams=2, idle_ttl_s=0.0)
            mgr.submit_frame("c", 1, img).result(timeout=60)
            got.append(mgr.active_streams())
            got.append(mgr.counters["evicted"])
            outcomes[side] = got
            if side == "port":
                mgr.opts = StreamOptions(max_streams=1, idle_ttl_s=3600.0)
                server = make_server(e, unix_socket=sock, stream=mgr)
                threading.Thread(target=server.serve_forever,
                                 daemon=True).start()
                status, raw, _ = unix_http_request_raw(
                    sock, "POST", "/stream", json.dumps(dict(
                        encode_image_payload(img), stream_id="d",
                        seq=1)).encode())
                assert status == 200
                assert json.loads(raw)["status"] == 503
        assert outcomes["port"] == outcomes["jax"] == ["ok", "ok", "503", 1,
                                                       2]
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        e.stop()
        je.stop()


def test_two_streams_coalesce_counters_equal_jax():
    counts = {}
    for side in ("port", "jax"):
        if side == "port":
            eng = make_engine(tiny_cfg(), batch_size=2, max_delay_ms=50.0)
            mgr = StreamManager(eng)
        else:
            eng = j_make_engine(j_tiny_cfg(), batch_size=2,
                                max_delay_ms=50.0)
            mgr = JStreamManager(eng)
        values = {"a": (30, 90, 150), "b": (60, 120, 210)}
        results = {"a": [], "b": []}
        for seq in range(3):  # queued before start: every batch mixes both
            for sid in ("a", "b"):
                results[sid].append(mgr.submit_frame(
                    sid, seq + 1, raw_image(60, 100, values[sid][seq])))
        eng.start()
        try:
            dets = {sid: [r.result(timeout=60) for r in rs]
                    for sid, rs in results.items()}
        finally:
            eng.stop()
        c = eng.counters
        counts[side] = (c["stream_batches"], c["stream_batch_frames"],
                        c["stream_coalesced_batches"],
                        mgr.metrics()["batch_occupancy"])
        if side == "port":
            fake = eng.predictor
            for sid in ("a", "b"):
                for seq in range(3):
                    staged = np.full((96, 128, 3), 0, np.uint8)
                    staged[:60, :100] = values[sid][seq]
                    assert abs(dets[sid][seq][0]["score"]
                               - fake.row_score(staged)) < 1e-5
    assert counts["port"] == counts["jax"] == (3, 6, 3, 1.0)


def test_generation_change_forces_the_full_path():
    e, m, je, jm = pair(skip_thresh=5.0)
    try:
        img = raw_image(60, 100, 100)
        for eng, mgr in ((e, m), (je, jm)):
            mgr.submit_frame("cam", 1, img).result(timeout=60)
            assert mgr.submit_frame("cam", 2, img).skipped is True
            eng.generation += 1  # a hot reload's swap
            r = mgr.submit_frame("cam", 3, img)
            r.result(timeout=60)
            assert r.skipped is False
        assert m.counters["forwarded"] == jm.counters["forwarded"] == 2
    finally:
        e.stop()
        je.stop()


def test_run_stream_stdio_round_trip_as_jax():
    e, m, je, jm = pair(skip_thresh=3.0)
    frame = dict(encode_image_payload(raw_image(60, 100, 70)),
                 stream_id="cam")
    text = "\n".join([json.dumps(dict(frame, seq=1)),
                      json.dumps(dict(frame, seq=1)),
                      "{bad",
                      json.dumps(dict(frame, seq=2))]) + "\n"
    out, jout = io.StringIO(), io.StringIO()
    try:
        run_stream_stdio(m, inp=io.StringIO(text), out=out)
        j_run_stream_stdio(jm, inp=io.StringIO(text), out=jout)
    finally:
        e.stop()
        je.stop()
    replies = [json.loads(ln) for ln in out.getvalue().splitlines()]
    jreplies = [json.loads(ln) for ln in jout.getvalue().splitlines()]
    assert [r["status"] for r in replies] == [r["status"] for r in jreplies] \
        == [200, 409, 400, 200]
    for r, jr in zip(replies, jreplies):
        assert set(r) == set(jr)
        for key in ("stream_id", "seq", "skipped"):
            assert r.get(key) == jr.get(key)
    assert replies[3]["skipped"] is True
    assert replies[3]["detections"] == replies[0]["detections"]
