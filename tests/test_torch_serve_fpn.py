"""FPN and Mask R-CNN serving of the PyTorch port against the JAX package,
on the CPU.

Config: ``tests/test_torch_fpn_slice.py``'s tiny Mask R-CNN (the
``resnet101_fpn_mask`` COCO preset, 81 classes, ``NETWORK="resnet50"``,
64×96 bucket at stride 32, ``FPN_ANCHOR_SCALES=(4,)``, TEST 250 → 32, 20
detections an image, ``PIXEL_STDS=127``, float32).  Weights: the port's
seeded ``random_params`` with ``cls_score`` ×30 (scores spread, no
near-ties at the cap), saved as ``.npz`` and read by both packages.

``serve.driver.build_engine`` builds the engine from that checkpoint
(``--prefix``/``--epoch``), in host-NMS and in ``--serve-e2e`` mode, and
serves raw images of both orientations over a Unix socket:

* ``--serve-e2e`` against the JAX ``ServeEngine(serve_e2e=True)`` on the
  same raw images; host NMS against the JAX offline path with device prep
  (``batch_put``, ``predict``, ``per_class_nms``), as
  ``tests/test_torch_serve_slice.py`` holds the C4 server.  Per record in
  score order: the same class, score within 1e-5, box within 1e-3 px, and
  the same number of records;
* warmup first-dispatches 2 programs, and the traffic adds none;
* a mask network answers with boxes only and its mask head never runs
  (the JAX engine serves no mask either).
"""

import threading

import jax
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.data.image import stage_raw_to_bucket as j_stage
from mx_rcnn_tpu.eval import Predictor as JPredictor
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.ops import postprocess as jpost
from mx_rcnn_tpu.serve import ServeEngine as JServeEngine
from mx_rcnn_tpu.serve import ServeOptions as JServeOptions
from mx_rcnn_tpu.train.checkpoint import load_params_npz as j_load_params_npz

from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.serve import (encode_image_payload, make_server,
                                     unix_http_request, warmup)
from mx_rcnn_tpu_torch.serve import driver
from mx_rcnn_tpu_torch.tools.common import config_from_args
from mx_rcnn_tpu_torch.train.checkpoint import epoch_path, save_params_npz
from mx_rcnn_tpu_torch.utils.convert_jax import random_params
from tests.test_torch_fpn_slice import TINY, jax_cfg
from tests.test_torch_serve_slice import assert_records_match

torch.set_num_threads(2)

# both orientations, one raw larger than the 64×96 bucket (pre-shrunk)
SIZES = ((48, 72), (72, 48), (60, 100), (100, 60))
MODES = ["host_nms", "e2e"]


def serve(engine, sock, images):
    """Warm the engine, then one client thread per image over a Unix
    socket → (programs warmed, replies, final /metrics)."""
    server = make_server(engine, unix_socket=sock)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    try:
        compiled = warmup(engine)
        th.start()
        assert unix_http_request(sock, "GET", "/readyz")[0] == 200
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
        return compiled, [r for _, r in out], unix_http_request(
            sock, "GET", "/metrics")[1]
    finally:
        if th.is_alive():
            server.shutdown()
        server.server_close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("servefpn")
    prefix = str(root / "model" / "mask")
    argv = TINY + ["--device", "cpu", "--prefix", prefix,
                   "--epoch", "1", "--serve-batch", "2", "--max-delay-ms",
                   "5", "--unix-socket", "unused"]
    cfg = config_from_args(driver.parse_args(argv), train=False)
    assert (cfg.NUM_CLASSES, cfg.network.HAS_MASK) == (81, True)
    params = random_params(build_model(cfg), seed=3)
    params["rcnn_out/cls_score/kernel"] *= 30.0
    save_params_npz(epoch_path(prefix, 1), params)
    rng = np.random.RandomState(5)
    images = [rng.randint(0, 255, hw + (3,), dtype=np.uint8) for hw in SIZES]

    out = {"cfg": cfg}
    for mode in MODES:
        args = driver.parse_args(argv + (["--serve-e2e"] if mode == "e2e"
                                         else []))
        predictor, engine = driver.build_engine(args, cfg)
        mask_calls = []
        hook = predictor.model.mask_head.register_forward_hook(
            lambda *a: mask_calls.append(1))
        try:
            out[mode] = serve(engine, str(root / f"{mode}.sock"), images)
        finally:
            hook.remove()
            engine.stop()
        out[mode + "_mask_calls"] = len(mask_calls)

    jcfg = jax_cfg("native")
    jpred = JPredictor(j_build_model(jcfg),
                       j_load_params_npz(epoch_path(prefix, 1)), jcfg)
    jeng = JServeEngine(jpred, jcfg, JServeOptions(
        batch_size=2, max_delay_ms=5.0, max_queue=16,
        serve_e2e=True)).start()
    try:
        out["jax_e2e"] = [jeng.submit(img).result(timeout=300)
                          for img in images]
    finally:
        jeng.stop()
    te = jcfg.TEST
    host = []
    for img in images:
        s, hw, r, info = j_stage(img, jcfg.tpu.SCALES[0], 32)
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
    out["jax_host_nms"] = host
    return out


@pytest.mark.parametrize("mode", MODES)
def test_served_fpn_detections_match_jax(runs, mode):
    _, replies, _ = runs[mode]
    n = 0
    for i, (resp, want) in enumerate(zip(replies, runs["jax_" + mode],
                                         strict=True)):
        assert_records_match(resp["detections"], want,
                             f"{mode} image {i} {SIZES[i]}")
        n += len(want)
    assert n > 0


@pytest.mark.parametrize("mode", MODES)
def test_fpn_warmup_then_no_first_dispatch(runs, mode):
    compiled, _, m = runs[mode]
    c = m["counters"]
    assert compiled == 2 == c["warmup_programs"] == c["recompiles"]
    assert c["served"] == 2 * 2 + len(SIZES)
    assert c["h2d_transfers"] == c["dispatches"] == c["readbacks"] \
        == c["batches"]
    shapes = {tuple(p["shape"][:4]) for p in m["compile"]["programs"]}
    assert shapes == {(2, 64, 96, 3), (2, 96, 64, 3)}


@pytest.mark.parametrize("mode", MODES)
def test_mask_network_serves_boxes_only(runs, mode):
    assert runs[mode + "_mask_calls"] == 0
    for resp in runs[mode][1]:
        for rec in resp["detections"]:
            assert set(rec) == {"cls", "score", "bbox"}
