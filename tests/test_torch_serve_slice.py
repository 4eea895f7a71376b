"""The serving slice of the PyTorch port against the JAX package, on the
CPU: the port's server over a Unix socket in both forward modes, and its
driver as a process.

Config: ``tests/test_serve.py``'s tiny one (resnet50, ``SCALES=((96,
128),)``, ``ANCHOR_SCALES=(2, 4)``, 300 → 32 proposals) in float32
compute on both sides (parity is held at f32), with ``PIXEL_STDS=127``:
at std 1 the random-init RPN deltas reach tens and ``exp(dw)`` magnifies
float32 rounding past any box tolerance in both packages alike
(``tests/test_torch_port_model.py``).  Weights: the JAX ``init_params`` +
``denormalize_for_save``, carried by ``utils/convert_jax.py``.

* ``--serve-e2e``: the port's detections against the JAX
  ``ServeEngine(serve_e2e=True)`` on the same raw images;
* host NMS: against the JAX offline path with device prep (the port has no
  cv2, so both of its modes prep on the device): a ``Predictor`` with
  ``tpu.DEVICE_PREP=True``, ``batch_put``, ``predict``, ``per_class_nms``.

Tolerance, per record in score order: the same class, score within 1e-5,
box within 1e-3 px (the eval slice's); the same number of records.  The
traffic mixes sizes in both orientations, one raw larger than the bucket
(the host pre-shrink): after warmup (2 programs) it adds no first
dispatch; every batch crosses 1 h2d copy, 1 dispatch and 1 readback, and
the e2e readback is smaller than the host-NMS one; ``update_params`` adds
no first dispatch and gives the same detections.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data.image import stage_raw_to_bucket as j_stage
from mx_rcnn_tpu.eval import Predictor as JPredictor
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.models import init_params
from mx_rcnn_tpu.ops import postprocess as jpost
from mx_rcnn_tpu.serve import ServeEngine as JServeEngine
from mx_rcnn_tpu.serve import ServeOptions as JServeOptions
from mx_rcnn_tpu.train.checkpoint import denormalize_for_save

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.eval.tester import Predictor
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.serve import (ServeEngine, ServeOptions,
                                     encode_image_payload, make_server,
                                     unix_http_request, warmup)
from tests.test_torch_port_model import flatten

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((60, 100), (100, 60), (48, 90), (90, 48), (150, 250), (77, 128))
SCORE_ATOL, BOX_ATOL = 1e-5, 1e-3
# the same config as the driver's flags
TINY_FLAGS = ["--network", "resnet50", "--cfg", "tpu__SCALES=((96,128),)",
              "--cfg", "network__ANCHOR_SCALES=(2,4)",
              "--cfg", "tpu__MAX_GT=8",
              "--cfg", "TEST__RPN_PRE_NMS_TOP_N=300",
              "--cfg", "TEST__RPN_POST_NMS_TOP_N=32",
              "--cfg", "tpu__COMPUTE_DTYPE='float32'"]


def tiny(gen, **kw):
    cfg = gen("resnet50", "PascalVOC", TEST__RPN_PRE_NMS_TOP_N=300,
              TEST__RPN_POST_NMS_TOP_N=32, **kw)
    net = dataclasses.replace(cfg.network, ANCHOR_SCALES=(2, 4),
                              PIXEL_STDS=(127.0, 127.0, 127.0))
    tpu = dataclasses.replace(cfg.tpu, SCALES=((96, 128),), MAX_GT=8,
                              COMPUTE_DTYPE="float32")
    return cfg.replace(network=net, tpu=tpu)


def assert_records_match(got, want, what):
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (d, e) in enumerate(zip(got, want)):
        assert d["cls"] == e["cls"], (what, i)
        assert abs(d["score"] - e["score"]) <= SCORE_ATOL, (what, i)
        np.testing.assert_allclose(d["bbox"], e["bbox"], rtol=0,
                                   atol=BOX_ATOL, err_msg=f"{what} #{i}")


def serve_over_socket(engine, sock, images):
    """Warm the started engine, serve ``images`` over a Unix socket from
    one client thread per image; returns (warmup count, detections per
    image, final /metrics)."""
    server = make_server(engine, unix_socket=sock)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    try:
        compiled = warmup(engine)
        th.start()
        status, ready = unix_http_request(sock, "GET", "/readyz")
        assert status == 200 and ready["ready"], ready
        out = [None] * len(images)

        def client(i):
            out[i] = unix_http_request(sock, "POST", "/predict",
                                       encode_image_payload(images[i]),
                                       timeout=300)

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(images))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(300)
        for status, resp in out:
            assert status == 200, resp
        status, m = unix_http_request(sock, "GET", "/metrics")
        assert status == 200
        status, prom = unix_http_request(sock, "GET", "/metrics?format=prom")
        assert status == 200
        assert 'mxr_serve_recompile_total{rank="0"} 2' in prom
        for path in ("/stream", "/admin/reload", "/predict?model=x"):
            assert unix_http_request(sock, "POST", path, {})[0] == 404
        return compiled, [r["detections"] for _, r in out], m
    finally:
        if th.is_alive():
            server.shutdown()
        server.server_close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    jcfg = tiny(j_generate_config, tpu__DEVICE_PREP=True)
    jmodel = j_build_model(jcfg)
    params = denormalize_for_save(
        init_params(jmodel, jcfg, jax.random.PRNGKey(0), 2, (96, 128)), jcfg)
    jpred = JPredictor(jmodel, params, jcfg)
    flat = flatten(params)

    cfg = tiny(generate_config)
    pred = Predictor(build_model(cfg), flat, cfg, device="cpu")
    rng = np.random.RandomState(7)
    images = [rng.randint(0, 255, hw + (3,), dtype=np.uint8) for hw in SIZES]

    out = {"images": images, "cfg": cfg}
    for mode in ("host_nms", "e2e"):
        engine = ServeEngine(pred, cfg, ServeOptions(
            batch_size=2, max_delay_ms=5.0, max_queue=16,
            serve_e2e=mode == "e2e")).start()
        try:
            out[mode] = serve_over_socket(engine, str(root / f"{mode}.sock"),
                                          images)
            # hot swap of the same weights: no first dispatch, same answer
            before = engine.counters["recompiles"]
            pred.update_params(flat)
            again = engine.submit(images[0]).result(timeout=300)
            out[mode + "_reload"] = (before, engine.counters["recompiles"],
                                     again)
        finally:
            engine.stop()

    # the JAX references
    jeng = JServeEngine(jpred, jcfg, JServeOptions(
        batch_size=2, max_delay_ms=5.0, max_queue=16,
        serve_e2e=True)).start()
    try:
        out["jax_e2e"] = [jeng.submit(img).result(timeout=300)
                          for img in images]
    finally:
        jeng.stop()
    te, stride = jcfg.TEST, 16
    host = []
    for img in images:
        s, hw, r, info = j_stage(img, jcfg.tpu.SCALES[0], stride)
        batch = jpred.batch_put({
            "images": np.stack([s, s]), "raw_hw": np.stack([hw, hw]),
            "prep_ratio": np.stack([r, r]), "flip": np.zeros(2, bool),
            "im_info": np.stack([info, info])})
        rois, valid, scores, deltas, _ = [
            np.asarray(jax.device_get(x))
            for x in jpred.predict(batch["images"], batch["im_info"])]
        boxes = jpost.decode_image_boxes(rois[0], deltas[0], info)
        host.append(jpost.detections_to_records(jpost.per_class_nms(
            scores[0], boxes, valid[0], jcfg.NUM_CLASSES, te.THRESH, te.NMS,
            te.MAX_PER_IMAGE)))
    out["jax_host"] = host
    return out


@pytest.mark.parametrize("mode", ["host_nms", "e2e"])
def test_detections_match_jax(runs, mode):
    ref = runs["jax_e2e" if mode == "e2e" else "jax_host"]
    _, served, _ = runs[mode]
    n = 0
    for i, (got, want) in enumerate(zip(served, ref, strict=True)):
        assert_records_match(got, want, f"{mode} image {i} {SIZES[i]}")
        n += len(got)
    assert n > 0


@pytest.mark.parametrize("mode", ["host_nms", "e2e"])
def test_warmup_then_no_first_dispatch(runs, mode):
    compiled, _, m = runs[mode]
    c = m["counters"]
    assert compiled == 2 == c["warmup_programs"] == c["recompiles"]
    assert c["served"] == 2 * 2 + len(SIZES)  # warmup fills 2 batches of 2
    kinds = {p["kind"] for p in m["compile"]["programs"]}
    assert kinds == {"serve_e2e" if mode == "e2e" else "predict"}
    shapes = {tuple(p["shape"][:4]) for p in m["compile"]["programs"]}
    assert shapes == {(2, 96, 128, 3), (2, 128, 96, 3)}


def test_one_transfer_dispatch_and_readback_per_batch(runs):
    per_batch = {}
    for mode in ("host_nms", "e2e"):
        c = runs[mode][2]["counters"]
        assert c["h2d_transfers"] == c["dispatches"] == c["readbacks"] \
            == c["batches"] > 0, (mode, c)
        per_batch[mode] = c["readback_bytes"] / c["batches"]
    cfg = runs["cfg"]
    assert per_batch["e2e"] == 2 * cfg.TEST.MAX_PER_IMAGE * 7 * 4
    assert per_batch["host_nms"] == 2 * 32 * (5 + 5 * cfg.NUM_CLASSES) * 4
    assert 0 < per_batch["e2e"] < per_batch["host_nms"]


@pytest.mark.parametrize("mode", ["host_nms", "e2e"])
def test_update_params_adds_no_first_dispatch(runs, mode):
    before, after, again = runs[mode + "_reload"]
    assert before == after == 2
    assert_records_match(again, runs[mode][1][0], f"{mode} after reload")


def test_driver_serves_and_exits_cleanly_on_sigterm(tmp_path):
    """``python -m mx_rcnn_tpu_torch.serve --device cpu --synthetic`` on a
    Unix socket: ready, a predict, the Prometheus text, exit 0 on SIGTERM
    with the telemetry summary written."""
    sock, tel = str(tmp_path / "s.sock"), tmp_path / "tel"
    proc = subprocess.Popen(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.serve", "--device", "cpu",
         "--synthetic", "--unix-socket", sock, "--serve-batch", "2",
         "--max-delay-ms", "5", "--serve-e2e", "--telemetry-dir", str(tel),
         "--target-p99-ms", "60000"] + TINY_FLAGS,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    try:
        deadline = time.monotonic() + 240
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                if unix_http_request(sock, "GET", "/readyz",
                                     timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "server never became ready"
            time.sleep(0.2)
        img = np.random.RandomState(1).randint(0, 255, (70, 110, 3),
                                               dtype=np.uint8)
        status, resp = unix_http_request(sock, "POST", "/predict",
                                         encode_image_payload(img),
                                         timeout=120)
        assert status == 200 and resp["detections"], resp
        status, prom = unix_http_request(sock, "GET", "/metrics",
                                         headers={"Accept": "text/plain"})
        assert status == 200
        assert 'mxr_serve_request_time_seconds_count{rank="0"} 5' in prom
        assert 'mxr_slo_target_p99_ms{rank="0",stat="last"} 60000.0' in prom
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stdout.read().decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert (tel / "summary.json").exists()
    assert (tel / "events_rank0.jsonl").exists()
