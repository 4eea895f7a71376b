"""Online serving driver (counterpart of the JAX package's
``serve.py:_build_engine`` + ``main_single``): checkpoint → ``Predictor``
on the card → warmed ``ServeEngine`` → HTTP frontend, until SIGTERM or
SIGINT.  Run as ``python -m mx_rcnn_tpu_torch.serve``::

    python -m mx_rcnn_tpu_torch.serve --network resnet101 --synthetic \\
        --port 8321 --serve-batch 2 --serve-e2e

    python -m mx_rcnn_tpu_torch.serve --prefix model/e2e --epoch 10 \\
        --unix-socket /tmp/serve.sock --target-p99-ms 200

``--loader-workers N`` stages host-NMS requests in N worker processes
(``data/workers.py``; the ring lives in ``/dev/shm``).  ``--synthetic``
serves seeded random weights (seed 0) and scales
pixels by 127 (random weights cannot absorb the raw 0..255 range).
Without a card the driver raises unless it is given ``--device cpu``.  The
first SIGTERM/SIGINT shuts down in order (frontend, controller, engine,
telemetry summary) and exits 0; a second one exits at once with 130.  The
flags of the modes not ported yet (replicas, fabric, models, cascade,
streaming, checkpoint watching, capture, tracing, the watchtower) are not
accepted.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.eval.tester import (INFER_DTYPES, Predictor,
                                           resolve_device)
from mx_rcnn_tpu_torch.logger import logger, setup_logging
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.serve.controller import ControllerOptions, SLOController
from mx_rcnn_tpu_torch.serve.engine import ServeEngine, ServeOptions
from mx_rcnn_tpu_torch.serve.frontend import make_server
from mx_rcnn_tpu_torch.serve.warmup import warmup
from mx_rcnn_tpu_torch.tools.common import (add_common_args, config_from_args,
                                            load_eval_params, refuse_fpn)
from mx_rcnn_tpu_torch.utils.convert_jax import random_params


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Serve a Faster R-CNN network over HTTP (PyTorch port)")
    add_common_args(parser, train=False)
    parser.add_argument("--prefix", default="model/e2e",
                        help="checkpoint prefix: {prefix}-{epoch:04d}.npz")
    parser.add_argument("--epoch", type=int, default=10,
                        help="checkpoint epoch to serve")
    parser.add_argument("--port", type=int, default=0,
                        help="TCP port of the HTTP frontend")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--unix-socket", default="", dest="unix_socket",
                        help="serve HTTP over this Unix socket instead of "
                             "TCP")
    parser.add_argument("--serve-batch", type=int, default=4,
                        dest="serve_batch",
                        help="images per forward; every batch is padded to "
                             "this size (one program per bucket)")
    parser.add_argument("--max-delay-ms", type=float, default=10.0,
                        dest="max_delay_ms",
                        help="flush a partial batch once its oldest request "
                             "has waited this long (0 = no coalescing "
                             "wait)")
    parser.add_argument("--serve-e2e", action="store_true", dest="serve_e2e",
                        help="single-dispatch serving: device prep, forward "
                             "and the device post-process in one call, one "
                             "(B, cap, 7) readback a batch")
    parser.add_argument("--max-queue", type=int, default=64,
                        dest="max_queue",
                        help="submits beyond this many pending requests get "
                             "503")
    parser.add_argument("--deadline-ms", type=float, default=30000.0,
                        dest="deadline_ms",
                        help="default per-request deadline (504 when "
                             "exceeded; <= 0 disables)")
    parser.add_argument("--target-p99-ms", type=float, default=0.0,
                        dest="target_p99_ms",
                        help="enable the SLO controller toward this "
                             "request-time p99 (0 = off)")
    parser.add_argument("--slo-interval-ms", type=float, default=500.0,
                        dest="slo_interval_ms",
                        help="SLO controller tick period")
    parser.add_argument("--slo-window-s", type=float, default=10.0,
                        dest="slo_window_s",
                        help="trailing window of the controller's p99")
    parser.add_argument("--infer-dtype", "--infer_dtype", default="float32",
                        dest="infer_dtype", choices=list(INFER_DTYPES),
                        help="parameter variant (the int8 ones are not "
                             "ported)")
    parser.add_argument("--telemetry-dir", default="", dest="telemetry_dir",
                        help="write the JSONL event stream and summary.json "
                             "here")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; raises "
                             "without one)")
    return parser.parse_args(argv)


def build_engine(args, cfg):
    """checkpoint (or ``--synthetic`` weights) → ``Predictor`` → started
    ``ServeEngine``.  An FPN network is refused by name."""
    refuse_fpn(cfg, "serving")
    device = resolve_device(args.device)
    model = build_model(cfg)
    params = (random_params(model, seed=0) if args.synthetic
              else load_eval_params(args))
    predictor = Predictor(model, params, cfg, device=device,
                          dtype=args.infer_dtype)
    engine = ServeEngine(predictor, cfg, ServeOptions(
        batch_size=args.serve_batch, max_delay_ms=args.max_delay_ms,
        max_queue=args.max_queue, deadline_ms=args.deadline_ms,
        # the common --loader-workers sizes the request staging pool
        prep_workers=args.loader_workers or 0, serve_e2e=args.serve_e2e))
    return predictor, engine.start()


def _install_signals(done: threading.Event):
    """First SIGTERM/SIGINT: set ``done`` (orderly shutdown); the second:
    flight dump and exit 130 at once."""
    state = {"armed": False}

    def on_signal(signum, frame):
        name = signal.Signals(signum).name
        if state["armed"]:
            telemetry.get().dump_flight("hard_abort", signal=name)
            os._exit(130)
        state["armed"] = True
        telemetry.get().dump_flight("preempt_signal", signal=name)
        done.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, on_signal)


def main(args) -> dict:
    """Serve until a signal; returns the engine's final ``/metrics``."""
    setup_logging()
    if not args.unix_socket and not args.port:
        raise SystemExit("pass --port or --unix-socket")
    resolve_device(args.device)  # no card and no --device cpu: raise now
    cfg = config_from_args(args, train=False)
    if args.telemetry_dir:
        telemetry.configure(args.telemetry_dir, run_meta={
            "driver": "serve", "network": args.network,
            "serve_batch": args.serve_batch,
            "max_delay_ms": args.max_delay_ms,
            "serve_e2e": args.serve_e2e})
    done = threading.Event()
    _install_signals(done)
    _, engine = build_engine(args, cfg)
    controller = None
    try:
        warmup(engine)
        if args.target_p99_ms > 0:
            controller = SLOController(engine, ControllerOptions(
                target_p99_ms=args.target_p99_ms,
                interval_s=args.slo_interval_ms / 1e3,
                window_s=args.slo_window_s)).start()
        server = make_server(engine, port=args.port or None, host=args.host,
                             unix_socket=args.unix_socket or None)
        # serve_forever on a worker thread; the main thread waits for the
        # signal (shutdown() from the serving thread would deadlock)
        t = threading.Thread(target=server.serve_forever, name="serve-http",
                             daemon=True)
        t.start()
        where = args.unix_socket or f"http://{args.host}:{args.port}"
        logger.info("serving %s on %s (batch=%d, max_delay=%.0fms, "
                    "max_queue=%d, e2e=%s, device=%s)", args.network, where,
                    args.serve_batch, args.max_delay_ms, args.max_queue,
                    args.serve_e2e, engine.predictor.device)
        done.wait()
        logger.info("shutting down: %s", engine.metrics()["counters"])
        server.shutdown()
        server.server_close()
    finally:
        if controller is not None:
            controller.stop()
        engine.stop()
        final = engine.metrics()
        tel = telemetry.get()
        if tel.enabled:
            tel.write_summary(extra={"serve": final})
        telemetry.shutdown()
    return final
