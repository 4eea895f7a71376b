"""The model pool and the cascade of the PyTorch port (``serve/pool.py``,
``flywheel/hardness.py``, the driver's ``--models`` parsing, ``?model=``
routing) against the JAX package, on the CPU.

* ``parse_model_specs`` against the JAX driver's on the same strings, its
  ``SystemExit`` messages included;
* routing over a Unix socket: ``?model=`` and the doc's ``"model"`` pick
  the engine, a request naming none goes to the default (first) model, an
  unknown id is a 404, ``/stream?model=`` picks that model's stream
  manager; ``/healthz``, ``/readyz`` and ``/metrics`` (JSON and
  Prometheus) report the pool;
* the scheduler's pick (``weight · (depth + 1)``, least recently
  scheduled on a tie) and its wait equal JAX's on a scripted queue state;
* the cascade over two tiny real models on the COCO preset (small:
  ResNet-50 C4, big: ResNet-50 FPN, both at the 64×96 bucket, e2e) under
  a weight budget that fits one model: every switch pages, a page-out
  points the model's tensors at host copies (the device ones released),
  a page-in restores them bitwise, and neither adds a first dispatch;
  thresh 0 escalates every image and answers with the big engine's own
  records, thresh 1 escalates none and answers with the small engine's,
  and the gate's hardness agrees with ``hardness_from_records`` on the
  served records;
* ``build_device_hardness`` (torch) within the JAX test's 5e-5 of the
  float64 host reference and within 1e-6 of the JAX device program;
* a model that is not e2e, and buckets that disagree, raise the JAX
  router's ``ValueError`` messages.
"""

import dataclasses
import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.flywheel.hardness import \
    build_device_hardness as j_build_device_hardness
from mx_rcnn_tpu.serve import CascadeRouter as JCascadeRouter
from mx_rcnn_tpu.serve import ModelPool as JModelPool
from tests.test_multimodel import add_fake_model as j_add_fake_model
from tests.test_serve import tiny_cfg as j_tiny_cfg

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.eval.tester import Predictor
from mx_rcnn_tpu_torch.flywheel import (HARDNESS_MAX, build_device_hardness,
                                        hardness_from_records)
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.serve import (CascadeRouter, ModelPool, ServeEngine,
                                     ServeOptions, StreamManager,
                                     encode_image_payload, make_server,
                                     param_nbytes, unix_http_request, warmup)
from mx_rcnn_tpu_torch.serve.driver import parse_model_specs
from mx_rcnn_tpu_torch.serve.frontend import unix_http_request_raw
from mx_rcnn_tpu_torch.utils.convert_jax import random_params
from tests.test_torch_serve_engine import FakePredictor, raw_image, tiny_cfg
from tests.test_torch_serve_slice import assert_records_match

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_driver():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_driver", os.path.join(REPO, "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def add_fake(pool, cfg, mid, e2e=False, **kw):
    pred = FakePredictor(cfg)
    eng = ServeEngine(pred, cfg, ServeOptions(
        batch_size=2, max_delay_ms=1.0, max_queue=32, serve_e2e=e2e))
    eng.start(external=True)
    pool.add_model(mid, cfg, pred, eng, **kw)
    return pred, eng


# -- the driver's spec grammar ----------------------------------------------

SPECS = [
    ("a=resnet50,b=vgg16", []),
    (" a = resnet50 , b=resnet101_fpn ,", [
        "a:pin=1", "b:weight=2.5", "b:cfg=TEST__NMS=0.4",
        "a:target-p99-ms=150", "b:fidelity=full", "a:prefix=model/x",
        "a:epoch=3", "b:pin=no"]),
    ("a", []), ("=x", []), ("a=", []), ("a=resnet50,a=vgg16", []),
    ("", []), (",", []),
    ("a=resnet50", ["c:pin=1"]), ("a=resnet50", ["a:bogus=1"]),
    ("a=resnet50", ["apin=1"]), ("a=resnet50", ["a:pin"]),
]


@pytest.mark.parametrize("models,model_args", SPECS)
def test_parse_model_specs_equals_jax(models, model_args):
    jparse = jax_driver().parse_model_specs
    try:
        want = jparse(models, model_args)
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            parse_model_specs(models, model_args)
        assert str(got.value) == str(e)
        return
    assert parse_model_specs(models, model_args) == want


# -- routing ------------------------------------------------------------------


def test_model_routing_default_and_404s(tmp_path):
    cfg = tiny_cfg()
    pool = ModelPool().start()
    pred_a, eng_a = add_fake(pool, cfg, "a")
    pred_b, eng_b = add_fake(pool, cfg, "b", weight=2.0)
    streams = {"b": StreamManager(eng_b)}
    sock = str(tmp_path / "pool.sock")
    server = make_server(eng_a, unix_socket=sock, pool=pool,
                         streams=streams)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        assert unix_http_request(sock, "GET", "/readyz")[0] == 503
        for eng in (eng_a, eng_b):
            warmup(eng)
        status, ready = unix_http_request(sock, "GET", "/readyz")
        assert status == 200 and set(ready["models"]) == {"a", "b"}
        img = encode_image_payload(raw_image(60, 100, 50))
        served = []
        for path, doc in (("/predict", img), ("/predict?model=b", img),
                          ("/predict", dict(img, model="b")),
                          ("/predict?model=a", img)):
            before = (eng_a.counters["served"], eng_b.counters["served"])
            status, resp = unix_http_request(sock, "POST", path, doc)
            assert status == 200 and resp["detections"], resp
            after = (eng_a.counters["served"], eng_b.counters["served"])
            served.append("a" if after[0] > before[0] else "b")
        assert served == ["a", "b", "b", "a"]
        status, resp = unix_http_request(sock, "POST", "/predict?model=zzz",
                                         img)
        assert status == 404 and "zzz" in resp["error"]
        frame = json.dumps(dict(img, stream_id="cam", seq=1)).encode()
        status, raw, _ = unix_http_request_raw(sock, "POST",
                                               "/stream?model=b", frame)
        assert status == 200 and json.loads(raw)["status"] == 200
        # the default model has no stream manager; an unknown model is 404
        assert unix_http_request_raw(sock, "POST", "/stream",
                                     frame)[0] == 404
        assert unix_http_request_raw(sock, "POST", "/stream?model=zz",
                                     frame)[0] == 404
        status, health = unix_http_request(sock, "GET", "/healthz")
        assert health["models"] == ["a", "b"]
        status, m = unix_http_request(sock, "GET", "/metrics")
        assert m["multimodel"] is True and m["default_model"] == "a"
        assert set(m["models"]) == {"a", "b"}
        assert m["models"]["b"]["stream"]["counters"]["frames"] == 1
        assert m["pool"]["counters"]["sched_batches"] >= 4 + 2 * 2
        assert m["counters"]["served"] == sum(
            d["counters"]["served"] for d in m["models"].values())
        status, prom = unix_http_request(sock, "GET", "/metrics?format=prom")
        assert status == 200
        assert 'mxr_serve_sched_batches_total{rank="pool"}' in prom
        assert 'mxr_serve_requests_total{rank="b"}' in prom
    finally:
        server.shutdown()
        server.server_close()
        pool.stop()


# -- the scheduler's pick ------------------------------------------------------


class StubEngine:
    """The engine surface ``_pick_locked`` reads, with a scripted state."""

    def __init__(self):
        self.state = (False, 0, None)
        self.on_work = None

    def due_state(self, now):
        return self.state


def test_pick_order_equals_jax():
    pools = {}
    for side, cls in (("port", ModelPool), ("jax", JModelPool)):
        pool = cls()
        engines = {}
        for mid, w in (("a", 1.0), ("b", 2.0), ("c", 1.0)):
            engines[mid] = StubEngine()
            pool.add_model(mid, None, object(), engines[mid], weight=w)
        pools[side] = (pool, engines)
    script = [
        ({"a": (True, 3, None), "b": (True, 1, None), "c": (False, 2, .01)},
         {}),
        ({"a": (True, 1, None), "b": (True, 1, None), "c": (True, 1, None)},
         {"b": 5.0}),
        ({"a": (True, 1, None), "b": (False, 0, None), "c": (True, 1, None)},
         {"a": 2.0, "c": 1.0}),
        ({"a": (True, 1, None), "b": (False, 0, None), "c": (True, 1, None)},
         {"a": 1.0, "c": 2.0}),
        ({"a": (False, 1, .03), "b": (False, 2, .02), "c": (False, 0, None)},
         {}),
        ({"a": (False, 0, None), "b": (False, 0, None),
          "c": (False, 0, None)}, {}),
        ({"a": (True, 7, None), "b": (True, 3, None), "c": (True, 0, None)},
         {}),
    ]
    for states, sched in script:
        picks = {}
        for side, (pool, engines) in pools.items():
            for mid, st in states.items():
                engines[mid].state = st
                pool.entry(mid).last_sched = sched.get(mid, 0.0)
            e, wait = pool._pick_locked(10.0)
            picks[side] = (e.model_id if e is not None else None, wait)
        assert picks["port"] == picks["jax"], (states, sched, picks)
    assert [p for p in picks.values()][0] == ("a", None)


# -- the cascade over two real models, paging at every switch -------------------

SCALE = (64, 96)


def coco_cfg(network: str):
    cfg = generate_config(network, "coco", TEST__RPN_PRE_NMS_TOP_N=250,
                          TEST__RPN_POST_NMS_TOP_N=32,
                          TEST__MAX_PER_IMAGE=20)
    net = dataclasses.replace(cfg.network, NETWORK="resnet50",
                              ANCHOR_SCALES=(2, 4), FPN_ANCHOR_SCALES=(4,),
                              PIXEL_STDS=(127.0, 127.0, 127.0))
    tpu = dataclasses.replace(cfg.tpu, SCALES=(SCALE,),
                              COMPUTE_DTYPE="float32")
    return cfg.replace(network=net, tpu=tpu)


def state_of(model):
    return [t.detach().clone() for t in (*model.parameters(),
                                         *model.buffers())]


@pytest.fixture(scope="module")
def cascade():
    cfgs = {"small": coco_cfg("resnet50"), "big": coco_cfg("resnet50_fpn")}
    preds = {}
    for i, (mid, cfg) in enumerate(cfgs.items()):
        model = build_model(cfg)
        params = random_params(model, seed=i)
        params["rcnn_out/cls_score/kernel"] *= 30.0
        preds[mid] = Predictor(model, params, cfg, device="cpu")
    nbytes = {mid: param_nbytes(p.model) for mid, p in preds.items()}
    pool = ModelPool(budget_bytes=max(nbytes.values()) + 1024).start()
    out = {"pool": pool, "preds": preds, "bytes": nbytes}
    small_state = state_of(preds["small"].model)
    small_ptrs = [t.data_ptr() for t in (*preds["small"].model.parameters(),
                                         *preds["small"].model.buffers())]
    for mid, cfg in cfgs.items():
        engine = ServeEngine(preds[mid], cfg, ServeOptions(
            batch_size=2, max_delay_ms=5.0, max_queue=32, serve_e2e=True))
        engine.start(external=True)
        pool.add_model(mid, cfg, preds[mid], engine)
        assert warmup(engine) == 2
    e_small = pool.entry("small")
    out["paged_out"] = (e_small.resident, e_small.page_outs,
                        [h.data_ptr() for h in e_small.host_params],
                        [t.data_ptr() for t in (
                            *preds["small"].model.parameters(),
                            *preds["small"].model.buffers())], small_ptrs)
    router = CascadeRouter(pool, "small", "big", thresh=0.0)
    assert router.warmup() == 1
    pool.cascade = router
    rng = np.random.RandomState(3)
    images = [rng.randint(0, 255, hw + (3,), dtype=np.uint8)
              for hw in ((48, 72), (72, 48), (60, 100), (100, 60))]
    for t in (0.0, 1.0):
        router.thresh, router._thresh_raw = t, t * HARDNESS_MAX
        base = dict(router.counters)
        futs = [router.submit(img) for img in images]
        out[t] = ([f.result(timeout=300) for f in futs],
                  [f.provenance() for f in futs],
                  {k: router.counters[k] - base[k] for k in base})
    out["direct"] = {mid: [pool.engine_for(mid).submit(img).result(
        timeout=300) for img in images] for mid in ("small", "big")}
    pool.ensure_resident("small")
    out["small_restored"] = (small_state, state_of(preds["small"].model))
    out["metrics"] = pool.metrics()
    out["images"] = images
    yield out
    pool.stop()


def test_paging_under_a_one_model_budget(cascade):
    resident, page_outs, host_ptrs, ptrs, before = cascade["paged_out"]
    assert resident is False and page_outs == 1
    assert host_ptrs == ptrs                   # the model reads the host copy
    assert not set(ptrs) & set(before)         # off its old storage
    want, got = cascade["small_restored"]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    m = cascade["metrics"]
    res = m["residency"]
    assert res["device_bytes"] <= res["budget_bytes"]
    assert res["models"]["small"]["page_ins"] >= 2
    assert res["models"]["big"]["page_outs"] >= 2
    assert m["pool"]["counters"]["weight_page_in"] >= 4
    assert "page_in_time_p50_ms" in res["paging"]
    for mid in ("small", "big"):
        c = m["models"][mid]["counters"]
        assert c["recompiles"] == c["warmup_programs"] == 2, mid
        assert res["models"][mid]["bytes"] == cascade["bytes"][mid]


def test_cascade_thresh_0_escalates_all_to_the_big_engine(cascade):
    records, prov, counts = cascade[0.0]
    assert counts["escalated"] == len(records)
    assert counts["answered_small"] == 0
    assert all(p["model"] == "big" and p["escalated"] for p in prov)
    n = 0
    for i, (got, want) in enumerate(zip(records, cascade["direct"]["big"],
                                        strict=True)):
        assert_records_match(got, want, f"escalated image {i}")
        n += len(got)
    assert n > 0


def test_cascade_thresh_1_escalates_none(cascade):
    records, prov, counts = cascade[1.0]
    assert counts["escalated"] == 0
    assert counts["answered_small"] == len(records)
    for i, (got, want, p) in enumerate(zip(
            records, cascade["direct"]["small"], prov, strict=True)):
        assert_records_match(got, want, f"small image {i}")
        assert p["model"] == "small" and not p["escalated"]
        # the gate's hardness (rounded to 4 places in the provenance) of
        # the served records
        assert abs(p["hardness"] - hardness_from_records(got)) < 5e-5 + 5e-5
        assert 0.0 <= p["hardness"] < HARDNESS_MAX
    assert cascade["metrics"]["cascade"]["counters"]["gate_batches"] >= 4


def test_device_hardness_matches_host_and_jax():
    cases = [[], [0.9], [0.5, 0.5, 0.5, 0.5], [0.95, 0.6, 0.35, 0.12, 0.05],
             [0.31, 0.69, 0.71, 0.29, 0.5, 0.5], [0.0, 0.0, 0.3]]
    rng = np.random.RandomState(0)
    cases += [list(rng.rand(n).astype(np.float32)) for n in (2, 17, 100)]
    cap = 100
    dets = np.zeros((len(cases), cap, 6), np.float32)
    valid = np.zeros((len(cases), cap), bool)
    for b, scores in enumerate(cases):
        for j, s in enumerate(scores):
            dets[b, j, 4] = s
            valid[b, j] = True
    got = build_device_hardness()(torch.from_numpy(dets),
                                  torch.from_numpy(valid)).numpy()
    assert got.dtype == np.float32 and got.shape == (len(cases),)
    want = np.asarray(j_build_device_hardness()(dets, valid))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for b, scores in enumerate(cases):
        host = hardness_from_records(
            [{"cls": 1, "score": float(s), "bbox": [0.0, 0.0, 4.0, 4.0]}
             for s in scores])
        assert abs(float(got[b]) - host) < 5e-5, (b, float(got[b]), host)
        assert 0.0 <= float(got[b]) < HARDNESS_MAX


def test_router_refusals_equal_jax():
    cfg, jcfg = tiny_cfg(), j_tiny_cfg()
    other = cfg.replace(tpu=dataclasses.replace(cfg.tpu,
                                                SCALES=((128, 192),)))
    jother = jcfg.replace(tpu=dataclasses.replace(jcfg.tpu,
                                                  SCALES=((128, 192),)))
    errors = {}
    for side in ("port", "jax"):
        msgs = []
        for case in ("not_e2e", "buckets", "same", "thresh"):
            pool = ModelPool() if side == "port" else JModelPool()
            for mid in ("s", "b"):
                e2e = not (case == "not_e2e" and mid == "b")
                if side == "port":
                    add_fake(pool, other if (case == "buckets" and mid == "b")
                             else cfg, mid, e2e=e2e)
                else:
                    j_add_fake_model(pool, jother if (case == "buckets"
                                                      and mid == "b")
                                     else jcfg, mid)
                    pool.entry(mid).engine.opts = dataclasses.replace(
                        pool.entry(mid).engine.opts, serve_e2e=e2e)
            router_cls = CascadeRouter if side == "port" else JCascadeRouter
            args = {"same": ("s", "s", 0.5), "thresh": ("s", "b", 1.5)}.get(
                case, ("s", "b", 0.5))
            with pytest.raises(ValueError) as e:
                router_cls(pool, *args[:2], thresh=args[2])
            msgs.append(str(e.value))
            with pytest.raises(KeyError):
                router_cls(pool, "s", "zz")
            pool.stop()
        errors[side] = msgs
    assert errors["port"] == errors["jax"]
    assert "not e2e" in errors["port"][0]
    assert "disagree on bucket geometry" in errors["port"][1]


def test_router_routes_by_model_identity():
    """The small (default) model gates, the big one is served directly
    ("addressed"), a ``fidelity="full"`` tenant goes to the big model
    ("fidelity"), any other model bypasses the cascade; an unknown id is
    a ``KeyError``, as in the JAX router."""
    cfg = tiny_cfg()
    pool = ModelPool().start()
    engines = {}
    for mid, kw in (("s", {}), ("b", {}), ("t", {"fidelity": "full"}),
                    ("x", {})):
        engines[mid] = add_fake(pool, cfg, mid, e2e=True, **kw)[1]
    router = CascadeRouter(pool, "s", "b", thresh=1.0)
    img = raw_image(60, 100, 40)
    try:
        for mid, served_by, want in (
                (None, "s", {"model": "s", "escalated": False,
                             "thresh": 1.0}),
                ("b", "b", {"model": "b", "escalated": False,
                            "reason": "addressed"}),
                ("t", "b", {"model": "b", "escalated": False,
                            "reason": "fidelity"}),
                ("x", "x", {"model": "x", "escalated": False,
                            "reason": "bypass"})):
            before = {k: e.counters["served"] for k, e in engines.items()}
            fut = router.submit(img, model_id=mid)
            assert fut.result(timeout=60)
            prov = fut.provenance()
            assert (prov.pop("hardness", None) is not None) == (mid is None)
            assert prov == want, mid
            moved = [k for k, e in engines.items()
                     if e.counters["served"] > before[k]]
            assert moved == [served_by], mid
        c = router.counters
        assert (c["forced_big"], c["answered_small"], c["escalated"]) \
            == (1, 1, 0)
        with pytest.raises(KeyError):
            router.submit(img, model_id="zz")
    finally:
        pool.stop()
