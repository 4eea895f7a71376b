"""Hot reload of the PyTorch port against the JAX package, on the CPU: a
real port ``Predictor`` and ``ServeEngine`` in host-NMS and ``--serve-e2e``
mode swap weights through ``serve/replica.py:reload_engine_params``, held
to the JAX ``reload_engine_params`` on the same converted weights (the JAX
side loads through ``load_params_fn``).

Config and tolerance: ``tests/test_torch_serve_slice.py``'s tiny one
(resnet50, 96×128, float32) and its record tolerance.  The boot weights
are the JAX ``init_params`` at key 0, ``denormalize_for_save``-d, the new
generation every leaf of them times 1 + 5% seeded noise; the port reads the new one from its own
checkpoint layout (``{prefix}-0002.npz``, found by ``scan_checkpoints``).

* replies after the swap: e2e against the JAX ``ServeEngine(serve_e2e=
  True)`` after its swap; host NMS against the JAX offline device-prep
  path of the swapped JAX predictor; no first dispatch during the swap;
* a corrupt checkpoint (``MXR_FAULT_REPLICA_CORRUPT_CKPT``) is rejected
  in both modes, float32 and bfloat16, every parameter and buffer back
  bitwise; the JAX e2e canary lets the same NaN generation through (its
  padded detection rows are zeroed), the port's does not;
* a step checkpoint serves the boxes of the epoch checkpoint saved from
  the same parameters;
* ``make_reloader`` and ``POST /admin/reload``: 400 / 409 / 200, an
  ``eval_shard`` target refused by name (A.12);
* ``python -m mx_rcnn_tpu_torch.serve --watch-checkpoints`` as a process
  reloads when a new save appears, without a non-200 reply.
"""

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
from mx_rcnn_tpu.serve import replica as jrp
from mx_rcnn_tpu.serve import warmup as j_warmup
from mx_rcnn_tpu.train.checkpoint import denormalize_for_save

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.eval.tester import Predictor
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.serve import (ServeEngine, ServeOptions,
                                     encode_image_payload, make_server,
                                     unix_http_request, warmup)
from mx_rcnn_tpu_torch.serve import replica as rp
from mx_rcnn_tpu_torch.train.checkpoint import (CheckpointManager,
                                                epoch_path,
                                                normalize_for_train,
                                                save_params_npz)
from tests.test_torch_port_model import flatten
from tests.test_torch_serve_slice import (TINY_FLAGS, assert_records_match,
                                          tiny)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# landscape raws (one bucket: one JAX compile of the offline path), the
# last above the bucket (the host pre-shrink)
SIZES = ((60, 100), (77, 128), (150, 250))
MODES = ("host_nms", "e2e")
# 20 detections an image: the e2e post-process's plain NMS sweep on the
# CPU loops once per kept row
CAP = {"TEST__MAX_PER_IMAGE": 20}
# the driver's flags for a checkpoint of the tiny model (not --synthetic:
# PIXEL_STDS by --cfg, as the port's Predictor above has it)
CKPT_FLAGS = TINY_FLAGS + ["--cfg", "network__PIXEL_STDS=(127.0,127.0,127.0)",
                          "--cfg", "TEST__MAX_PER_IMAGE=20"]


def epoch_target(prefix, epoch):
    return {"prefix": prefix, "kind": "epoch", "epoch": epoch, "consumed": 0}


def engine_for(pred, cfg, mode):
    engine = ServeEngine(pred, cfg, ServeOptions(
        batch_size=2, max_delay_ms=5.0, max_queue=16,
        serve_e2e=mode == "e2e")).start()
    assert warmup(engine) == 2
    return engine


def serve_all(engine, images):
    """One request at a time (each rides row 0 of its batch)."""
    return [engine.submit(img).result(timeout=300) for img in images]


def state(model):
    return [t.detach().clone() for t in (*model.parameters(),
                                         *model.buffers())]


def assert_bitwise(model, saved):
    now = state(model)
    assert len(now) == len(saved)
    for a, b in zip(now, saved):
        assert torch.equal(a, b)


def jax_host_records(jpred, jcfg, images):
    """The JAX offline device-prep path, host NMS, row 0 of a batch of
    two (``tests/test_torch_serve_slice.py``'s reference)."""
    te = jcfg.TEST
    out = []
    for img in images:
        s, hw, r, info = j_stage(img, jcfg.tpu.SCALES[0], 16)
        batch = jpred.batch_put({
            "images": np.stack([s, s]), "raw_hw": np.stack([hw, hw]),
            "prep_ratio": np.stack([r, r]), "flip": np.zeros(2, bool),
            "im_info": np.stack([info, info])})
        rois, valid, scores, deltas, _ = [
            np.asarray(jax.device_get(x))
            for x in jpred.predict(batch["images"], batch["im_info"])]
        boxes = jpost.decode_image_boxes(rois[0], deltas[0], info)
        out.append(jpost.detections_to_records(jpost.per_class_nms(
            scores[0], boxes, valid[0], jcfg.NUM_CLASSES, te.THRESH, te.NMS,
            te.MAX_PER_IMAGE)))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("reload")
    jcfg = tiny(j_generate_config, tpu__DEVICE_PREP=True, **CAP)
    jmodel = j_build_model(jcfg)
    p0 = denormalize_for_save(init_params(
        jmodel, jcfg, jax.random.PRNGKey(0), 2, (96, 128)), jcfg)
    # the new generation: every leaf scaled by 1 + 5% seeded noise (one
    # init is ~10 s of the CPU; the scale keeps the BN variances positive)
    noise = np.random.RandomState(1)
    p1 = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) * (1.0 + 0.05 * noise.standard_normal(
            np.shape(x)))).astype(np.asarray(x).dtype), p0)
    flat0, flat1 = flatten(p0), flatten(p1)
    rng = np.random.RandomState(11)
    images = [rng.randint(0, 255, hw + (3,), dtype=np.uint8) for hw in SIZES]
    target = epoch_target("unused", 2)

    # the JAX side: its e2e engine swapped by its reload_engine_params
    jpred = JPredictor(jmodel, p0, jcfg)
    jeng = JServeEngine(jpred, jcfg, JServeOptions(
        batch_size=2, max_delay_ms=5.0, max_queue=16,
        serve_e2e=True)).start()
    try:
        j_warmup(jeng)
        jok, jinfo = jrp.reload_engine_params(
            jeng, jpred, jcfg, dict(target),
            load_params_fn=lambda t, c: p1)
        j_e2e = [jeng.submit(img).result(timeout=300) for img in images]
        # the reference's e2e canary on a NaN generation
        j_nan = jrp.reload_engine_params(
            jeng, jpred, jcfg, epoch_target("unused", 3),
            load_params_fn=lambda t, c: p1,
            faults=jrp.ReplicaFaults(0, env={jrp.ENV_CORRUPT_CKPT: "0"}))
    finally:
        jeng.stop()
    jpred.update_params(p1)
    j_host = jax_host_records(jpred, jcfg, images)

    # the port: epoch 1 boots, epoch 2 appears
    prefix = str(root / "c4")
    save_params_npz(epoch_path(prefix, 1), flat0)
    save_params_npz(epoch_path(prefix, 2), flat1)
    cfg = tiny(generate_config, **CAP)
    pred = Predictor(build_model(cfg), epoch_path(prefix, 1), cfg,
                     device="cpu")
    out = {"images": images, "cfg": cfg, "pred": pred, "prefix": prefix,
           "flat0": flat0, "flat1": flat1, "root": root,
           "jax": {"ok": jok, "info": jinfo, "e2e": j_e2e,
                   "host_nms": j_host, "nan": j_nan}}
    for mode in MODES:
        pred.update_params(flat0)
        engine = engine_for(pred, cfg, mode)
        try:
            target = rp.scan_checkpoints(prefix)
            before = engine.counters["recompiles"]
            ok, info = rp.reload_engine_params(engine, pred, cfg, target)
            out[mode] = {"ok": ok, "info": info, "target": target,
                         "recompiles": (before,
                                        engine.counters["recompiles"]),
                         "generation": engine.generation,
                         "replies": serve_all(engine, images),
                         "metrics": engine.metrics()}
        finally:
            engine.stop()
    return out


def test_jax_reference_swapped(world):
    assert world["jax"]["ok"]
    assert world["jax"]["info"]["recompiles_during_swap"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_replies_after_the_swap_match_jax(world, mode):
    got = world[mode]
    assert got["ok"], got["info"]
    assert got["target"] == epoch_target(world["prefix"], 2)
    n = 0
    for i, (served, want) in enumerate(zip(got["replies"],
                                           world["jax"][mode], strict=True)):
        assert_records_match(served, want, f"{mode} image {i}")
        n += len(served)
    assert n > 0


@pytest.mark.parametrize("mode", MODES)
def test_swap_first_dispatches_nothing(world, mode):
    got = world[mode]
    info = got["info"]
    assert info["recompiles_during_swap"] == 0 \
        == world["jax"]["info"]["recompiles_during_swap"]
    assert got["recompiles"] == (2, 2)
    assert got["generation"] == info["generation"] == 1
    assert info["target"] == [2, 0, "epoch"]
    # the canary ran on the CPU: the NMS wrappers' plain versions, no launch
    assert info["canary_launches"] == {"nms_mask": 0, "nms_sweep": 0}
    assert info["canary_ms"] > 0 and info["update_ms"] > 0
    m = got["metrics"]
    assert m["reload"]["ok"] and m["reload"]["generation"] == 1
    assert m["generation"] == 1 and m["counters"]["recompiles"] == 2


@pytest.mark.parametrize("mode,dtype", [("host_nms", "float32"),
                                        ("e2e", "float32"),
                                        ("e2e", "bfloat16")])
def test_corrupt_checkpoint_rolls_back_bitwise(world, mode, dtype):
    """The poisoned generation fails the canary, every parameter and
    buffer is back bitwise, the engine serves as before."""
    cfg, images = world["cfg"], world["images"][:1]
    pred = Predictor(build_model(cfg), world["flat0"], cfg, device="cpu",
                     dtype=dtype)
    faults = rp.ReplicaFaults(0, env={rp.ENV_CORRUPT_CKPT: "0"})
    assert faults.corrupt_ckpt
    engine = engine_for(pred, cfg, mode)
    try:
        before = serve_all(engine, images)
        saved = state(pred.model)
        ok, info = rp.reload_engine_params(
            engine, pred, cfg, epoch_target(world["prefix"], 2),
            faults=faults)
        assert not ok and info["rolled_back"], info
        assert "canary failed: non-finite" in info["error"]
        assert info["rollback_ms"] >= 0
        assert_bitwise(pred.model, saved)
        assert pred._feats is None and pred._feats_token is None
        assert engine.generation == 0
        assert engine.metrics()["reload"]["ok"] is False
        assert engine.readiness()["ready"]
        assert serve_all(engine, images) == before
        assert engine.counters["recompiles"] == 2
    finally:
        engine.stop()


def test_jax_e2e_canary_passes_a_nan_generation(world):
    """The reference's fault, which the port does not copy: its e2e canary
    checks only the detections, whose padded rows are zeroed, so a NaN
    generation (scores that no threshold keeps) leaves finite zeros."""
    ok, info = world["jax"]["nan"]
    assert ok and info["generation"] == 2


def test_step_checkpoint_serves_the_epoch_boxes(world):
    """The same raw (training) parameters saved as epoch 1 (de-normalized
    on save) and as a step checkpoint 5 batches into epoch 1 (raw):
    ``load_serving_params`` folds the step's, so both serve one set of
    boxes; the scan picks the step, the furthest position."""
    cfg = world["cfg"]
    raw = normalize_for_train(world["flat1"], cfg)
    prefix = str(world["root"] / "steps" / "c4")
    mgr = CheckpointManager(prefix)
    mgr.save_epoch(1, raw, cfg)
    mgr.save_step(1, 5, raw)
    step = rp.scan_checkpoints(prefix)
    assert step == {"prefix": prefix, "kind": "step", "epoch": 1,
                    "consumed": 5}
    from_step = rp.load_serving_params(step, cfg)
    from_epoch = rp.load_serving_params(epoch_target(prefix, 1), cfg)
    assert from_step.keys() == from_epoch.keys()
    for k in from_step:
        np.testing.assert_array_equal(from_step[k], from_epoch[k])
    pred = Predictor(build_model(cfg), world["flat0"], cfg, device="cpu")
    engine = engine_for(pred, cfg, "host_nms")
    try:
        replies = {}
        for name, target in (("step", step),
                             ("epoch", epoch_target(prefix, 1))):
            ok, info = rp.reload_engine_params(engine, pred, cfg, target)
            assert ok and info["recompiles_during_swap"] == 0, info
            replies[name] = serve_all(engine, world["images"])
        assert replies["step"] == replies["epoch"]
        assert any(replies["step"])
    finally:
        engine.stop()


def test_reloader_statuses_and_admin_route(world, tmp_path):
    cfg = world["cfg"]
    pred = Predictor(build_model(cfg), world["flat0"], cfg, device="cpu")
    engine = engine_for(pred, cfg, "host_nms")
    corrupt = {"on": False}

    class Faults:
        @property
        def corrupt_ckpt(self):
            return corrupt["on"]

    reloader = rp.make_reloader(engine, pred, cfg, faults=Faults())
    jreloader = jrp.make_reloader(None, None, None)  # its 400 needs none
    sock = str(tmp_path / "r.sock")
    server = make_server(engine, unix_socket=sock, reloader=reloader)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        status, doc = reloader({"kind": "epoch"})
        assert status == 400 and "consumed" in doc["error"]
        assert (status, doc) == jreloader({"kind": "epoch"})
        assert unix_http_request(sock, "POST", "/admin/reload",
                                 {"epoch": 1})[0] == 400
        # a prefix with no checkpoint: the load fails, 409, rolled back
        saved = state(pred.model)
        status, doc = reloader(epoch_target(str(tmp_path / "none"), 2))
        assert status == 409 and doc["rolled_back"]
        assert "FileNotFoundError" in doc["error"]
        assert_bitwise(pred.model, saved)
        assert engine.generation == 0
        corrupt["on"] = True
        status, doc = unix_http_request(
            sock, "POST", "/admin/reload",
            epoch_target(world["prefix"], 2))
        assert status == 409 and "canary" in doc["error"]
        corrupt["on"] = False
        status, doc = unix_http_request(
            sock, "POST", "/admin/reload",
            epoch_target(world["prefix"], 2))
        assert status == 200 and doc["generation"] == 1
        status, doc = reloader(dict(epoch_target(world["prefix"], 1),
                                    generation=5))
        assert status == 200 and doc["generation"] == 5
        # the fleet's quality gate is A.12's: refused, nothing advances
        status, doc = reloader(dict(epoch_target(world["prefix"], 2),
                                    eval_shard="shard.npz"))
        assert status == 409 and "A.12" in doc["error"]
        assert not doc["rolled_back"] and engine.generation == 5
        assert engine.readiness()["ready"]
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()


def test_watch_checkpoints_driver_reloads_a_new_save(world, tmp_path):
    """``python -m mx_rcnn_tpu_torch.serve --device cpu --watch-checkpoints
    P`` booted from P's epoch 1: a client thread sends requests while
    epoch 2 appears; every reply is 200, the generation turns 1 with no
    first dispatch, and a reply after the swap is the port's in-process
    swapped engine's."""
    prefix = str(tmp_path / "c4")
    save_params_npz(epoch_path(prefix, 1), world["flat0"])
    sock = str(tmp_path / "s.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.serve", "--device", "cpu",
         "--prefix", prefix, "--epoch", "1", "--unix-socket", sock,
         "--serve-batch", "2", "--max-delay-ms", "5",
         "--watch-checkpoints", prefix, "--watch-interval-s", "0.2"]
        + CKPT_FLAGS,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    img = world["images"][0]
    statuses, stop = [], threading.Event()

    def wait_for(cond, what):
        deadline = time.monotonic() + 120
        while not cond():
            assert time.monotonic() < deadline, what
            time.sleep(0.05)

    def client():
        while not stop.is_set():
            statuses.append(unix_http_request(
                sock, "POST", "/predict", encode_image_payload(img),
                timeout=120)[0])

    th = threading.Thread(target=client, daemon=True)
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
        th.start()
        wait_for(lambda: len(statuses) >= 2, "requests before the save")
        save_params_npz(epoch_path(prefix, 2), world["flat1"])
        wait_for(lambda: unix_http_request(sock, "GET", "/readyz")[1][
            "generation"] == 1, "the reload")
        n = len(statuses)
        wait_for(lambda: len(statuses) >= n + 2, "requests after the swap")
        stop.set()
        th.join(120)
        assert not th.is_alive()
        status, resp = unix_http_request(sock, "POST", "/predict",
                                         encode_image_payload(img),
                                         timeout=120)
        assert status == 200
        assert_records_match(resp["detections"],
                             world["host_nms"]["replies"][0],
                             "after the watched reload")
        status, m = unix_http_request(sock, "GET", "/metrics")
        assert m["reload"]["ok"] and m["reload"]["target"] == [2, 0, "epoch"]
        assert m["reload"]["recompiles_during_swap"] == 0
        assert m["counters"]["recompiles"] == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stdout.read().decode()
    finally:
        stop.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert set(statuses) == {200}, statuses
