"""Online serving driver (counterpart of the JAX package's
``serve.py:_build_engine`` + ``main_single``): checkpoint → ``Predictor``
on the card → warmed ``ServeEngine`` → HTTP frontend, until SIGTERM or
SIGINT.  Run as ``python -m mx_rcnn_tpu_torch.serve``::

    python -m mx_rcnn_tpu_torch.serve --network resnet101 --synthetic \\
        --port 8321 --serve-batch 2 --serve-e2e

    python -m mx_rcnn_tpu_torch.serve --prefix model/e2e --epoch 10 \\
        --unix-socket /tmp/serve.sock --target-p99-ms 200

    python -m mx_rcnn_tpu_torch.serve --network resnet101_fpn_mask \
        --dataset coco --prefix model/mask --epoch 1 --port 8321

    python -m mx_rcnn_tpu_torch.serve --synthetic --port 8321 --stream \
        --stream-skip-thresh 2 --stream-max-skip 30 --serve-e2e

    python -m mx_rcnn_tpu_torch.serve --synthetic --dataset coco \
        --serve-e2e --port 8321 --models c4=resnet101,fpn=resnet101_fpn \
        --weight-budget-mb 300 --cascade c4:fpn --cascade-thresh 0.5

Every network of the presets is served, FPN and Mask R-CNN ones too (a
mask network answers with boxes, as the JAX server does: the mask head
does not run).  ``--loader-workers N`` stages host-NMS requests in N
worker processes (``data/workers.py``; the ring lives in ``/dev/shm``).
``--synthetic`` serves seeded random weights (seed 0) and scales pixels
by 127 (random weights cannot absorb the raw 0..255 range).  Without a
card the driver raises unless it is given ``--device cpu``.

    python -m mx_rcnn_tpu_torch.serve --prefix model/e2e --epoch 1 \
        --serve-e2e --port 8321 --watch-checkpoints model/e2e

    python -m mx_rcnn_tpu_torch.serve --prefix model/e2e --epoch 1 \
        --serve-e2e --port 8321 --replicas 2 --watch-checkpoints model/e2e

``--stream`` adds ``POST /stream`` (``serve/stream.py``).  ``--models
ID=NETWORK,...`` serves several models from one process
(``serve/pool.py:ModelPool``, ``/predict?model=ID``, the first the
default), each with its own ``--model-arg ID:KEY=VALUE`` overrides
(``prefix``, ``epoch``, ``cfg``, ``pin``, ``weight``, ``target-p99-ms``,
``fidelity``) and the weights paged under ``--weight-budget-mb``;
``--cascade SMALL:BIG`` (with ``--models`` and ``--serve-e2e``) routes
through the confidence gate.  The first SIGTERM/SIGINT shuts down in
order (frontend, controllers, engines, telemetry summary) and exits 0; a
second one exits at once with 130.

``--watch-checkpoints P`` polls the checkpoint prefix ``P`` every
``--watch-interval-s`` and hot-reloads each newer epoch or step
checkpoint (``serve/replica.py``: quiesce, swap, canary, rollback).
``--replicas N`` (N > 1) runs the replica plane (``serve/supervisor.py``):
this process holds no model and touches no device; it starts N children
(``--replica-index I``, each its own CUDA context, on its group of
``--replica-devices`` or all on the one card), routes ``/predict`` over
the ready ones with one retry, respawns the dead, rolls the watched
checkpoints through them one at a time and exits nonzero when every
replica has failed.  ``--device cpu`` passes through to the children.
``--models`` and ``--stream`` need the single-process mode.  The flags of
the modes not ported yet (fabric, capture, tracing, the watchtower) are
not accepted.
"""

from __future__ import annotations

import argparse
import atexit
import os
import shutil
import signal
import sys
import tempfile
import threading

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.eval.tester import (INFER_DTYPES, Predictor,
                                           resolve_device)
from mx_rcnn_tpu_torch.logger import logger, setup_logging
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.serve.controller import ControllerOptions, SLOController
from mx_rcnn_tpu_torch.serve.engine import ServeEngine, ServeOptions
from mx_rcnn_tpu_torch.serve.frontend import make_server
from mx_rcnn_tpu_torch.serve.pool import CascadeRouter, ModelPool
from mx_rcnn_tpu_torch.serve.replica import (CheckpointWatcher,
                                             apply_replica_devices,
                                             reload_engine_params,
                                             serve_replica)
from mx_rcnn_tpu_torch.serve.stream import StreamManager, StreamOptions
from mx_rcnn_tpu_torch.serve.supervisor import (ReplicaRouter,
                                                ReplicaSupervisor,
                                                make_router_server,
                                                replica_specs)
from mx_rcnn_tpu_torch.serve.warmup import warmup
from mx_rcnn_tpu_torch.tools.common import (add_common_args, config_from_args,
                                            load_eval_params)
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
    parser.add_argument("--stream", action="store_true",
                        help="enable POST /stream: sequenced frames with "
                             "per-stream state over the same batcher")
    parser.add_argument("--stream-skip-thresh", type=float, default=0.0,
                        dest="stream_skip_thresh",
                        help="frame-delta gate: mean absolute uint8 pixel "
                             "delta against the stream's reference frame "
                             "below which a frame answers with its "
                             "detections and no forward (0 = off: "
                             "byte-identical to /predict)")
    parser.add_argument("--stream-max-skip", type=int, default=30,
                        dest="stream_max_skip",
                        help="a full forward after this many consecutive "
                             "skips")
    parser.add_argument("--models", default="",
                        help="serve several models from one process: "
                             "comma-separated ID=NETWORK entries; "
                             "/predict?model=ID routes, the first is the "
                             "default")
    parser.add_argument("--model-arg", action="append", default=[],
                        dest="model_arg", metavar="ID:KEY=VALUE",
                        help="per-model override, repeatable; KEYs: "
                             "prefix, epoch, cfg (a --cfg PATH=VALUE), pin "
                             "(1: never paged out), weight (scheduling "
                             "class, default 1), target-p99-ms, fidelity "
                             "(cascade | full)")
    parser.add_argument("--weight-budget-mb", type=float, default=0.0,
                        dest="weight_budget_mb",
                        help="device weight budget of --models: weights "
                             "beyond it are paged to the host, least "
                             "recently used first, pinned models exempt "
                             "(0 = unbounded)")
    parser.add_argument("--cascade", default="", metavar="SMALL:BIG",
                        help="cascade over two --models entries (needs "
                             "--serve-e2e): requests go to SMALL, and "
                             "images whose on-card hardness reaches "
                             "--cascade-thresh escalate to BIG with their "
                             "staged pixels")
    parser.add_argument("--cascade-thresh", type=float, default=0.5,
                        dest="cascade_thresh",
                        help="escalation threshold in [0, 1] of the "
                             "hardness scale: 0 escalates every image, 1 "
                             "none")
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
    parser.add_argument("--replicas", type=int, default=1,
                        help="run N supervised replica processes behind a "
                             "router (1 = the single-process server)")
    parser.add_argument("--replica-index", type=int, default=-1,
                        dest="replica_index",
                        help=argparse.SUPPRESS)  # a replica child's
    parser.add_argument("--replica-devices", default="",
                        dest="replica_devices",
                        help="semicolon-separated device groups, one per "
                             "replica (group i becomes the child's "
                             "CUDA_VISIBLE_DEVICES); default: every child "
                             "on every card")
    parser.add_argument("--watch-checkpoints", default="",
                        dest="watch_checkpoints",
                        help="poll this checkpoint prefix ({prefix}-"
                             "{epoch:04d}.npz and {prefix}-steps/) and "
                             "hot-reload each newer checkpoint: canary-"
                             "gated, rolled back on non-finite outputs, "
                             "rolling across --replicas")
    parser.add_argument("--watch-interval-s", type=float, default=5.0,
                        dest="watch_interval_s",
                        help="checkpoint watcher poll period")
    parser.add_argument("--telemetry-dir", default="", dest="telemetry_dir",
                        help="write the JSONL event stream and summary.json "
                             "here")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; raises "
                             "without one)")
    args = parser.parse_args(argv)
    # the plane rebuilds its children's command lines from these
    args.argv = list(sys.argv[1:] if argv is None else argv)
    return args


def build_engine(args, cfg, external: bool = False):
    """checkpoint (or ``--synthetic`` weights) → ``Predictor`` → started
    ``ServeEngine`` (``external``: flushed by a model pool's dispatcher,
    not a thread of its own)."""
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
    return predictor, engine.start(external=external)


def parse_model_specs(models: str, model_args) -> list:
    """``--models a=resnet101,b=vgg16`` and repeated ``--model-arg
    ID:KEY=VALUE`` → spec dicts in order (the first is the default
    model).  Raises ``SystemExit`` on a malformed entry, as the JAX
    driver does."""
    specs = []
    by_id = {}
    for entry in models.split(","):
        entry = entry.strip()
        if not entry:
            continue
        mid, _, network = entry.partition("=")
        mid, network = mid.strip(), network.strip()
        if not mid or not network:
            raise SystemExit(f"--models entries are ID=NETWORK, got "
                             f"{entry!r}")
        if mid in by_id:
            raise SystemExit(f"--models: duplicate model id {mid!r}")
        spec = {"id": mid, "network": network, "prefix": None,
                "epoch": None, "cfg": [], "pin": False, "weight": 1.0,
                "target_p99_ms": None, "fidelity": "cascade"}
        by_id[mid] = spec
        specs.append(spec)
    for arg in model_args or []:
        mid, sep, kv = arg.partition(":")
        key, sep2, val = kv.partition("=")
        if not sep or not sep2 or mid.strip() not in by_id:
            raise SystemExit(f"--model-arg is ID:KEY=VALUE with ID from "
                             f"--models, got {arg!r}")
        spec, key = by_id[mid.strip()], key.strip().replace("-", "_")
        if key == "cfg":
            spec["cfg"].append(val)
        elif key == "pin":
            spec["pin"] = val.strip().lower() in ("1", "true", "yes")
        elif key == "weight":
            spec["weight"] = float(val)
        elif key == "target_p99_ms":
            spec["target_p99_ms"] = float(val)
        elif key == "fidelity":
            spec["fidelity"] = val.strip()
        elif key in ("prefix", "epoch"):
            spec[key] = int(val) if key == "epoch" else val
        else:
            raise SystemExit(f"--model-arg: unknown key {key!r}")
    if not specs:
        raise SystemExit("--models parsed to zero entries")
    return specs


def _stream_manager(args, engine) -> StreamManager:
    sm = StreamManager(engine, StreamOptions(
        skip_thresh=args.stream_skip_thresh,
        max_skip=args.stream_max_skip))
    sm.warmup()
    return sm


def build_pool(args):
    """``--models`` → a started :class:`ModelPool`: for each model its own
    config, ``Predictor`` and engine (external dispatch), warmed before
    the next is built, a controller when a p99 target applies, and under
    ``--stream`` its stream manager; then under ``--cascade`` the warmed
    :class:`CascadeRouter`.  Returns ``(pool, streams, cascade)``."""
    specs = parse_model_specs(args.models, args.model_arg)
    pool = ModelPool(budget_bytes=int(args.weight_budget_mb * (1 << 20)))
    pool.start()
    streams = {}
    for spec in specs:
        margs = argparse.Namespace(**vars(args))
        margs.network = spec["network"]
        margs.cfg = list(args.cfg) + list(spec["cfg"])
        if spec["prefix"] is not None:
            margs.prefix = spec["prefix"]
        if spec["epoch"] is not None:
            margs.epoch = spec["epoch"]
        cfg = config_from_args(margs, train=False)
        predictor, engine = build_engine(margs, cfg, external=True)
        target = spec["target_p99_ms"]
        if target is None and args.target_p99_ms > 0:
            target = args.target_p99_ms
        controller = None
        if target:
            controller = SLOController(engine, ControllerOptions(
                target_p99_ms=target, interval_s=args.slo_interval_ms / 1e3,
                window_s=args.slo_window_s, label=spec["id"]))
        pool.add_model(spec["id"], cfg, predictor, engine,
                       controller=controller, pinned=spec["pin"],
                       weight=spec["weight"], fidelity=spec["fidelity"])
        warmup(engine)
        if args.stream:
            streams[spec["id"]] = _stream_manager(args, engine)
        if controller is not None:
            controller.start()
    cascade = None
    if args.cascade:
        small, sep, big = args.cascade.partition(":")
        small, big = small.strip(), big.strip()
        if not sep or not small or not big:
            raise SystemExit(f"--cascade is SMALL:BIG with ids from "
                             f"--models, got {args.cascade!r}")
        try:
            cascade = CascadeRouter(pool, small, big,
                                    thresh=args.cascade_thresh)
        except (KeyError, ValueError) as e:
            raise SystemExit(f"--cascade: {e}")
        cascade.warmup()
        pool.cascade = cascade
        if small in streams:
            streams[small].cascade = cascade
        logger.info("cascade: %s -> %s at thresh %.3f", small, big,
                    args.cascade_thresh)
    return pool, streams, cascade


def _install_signals(done: threading.Event, hard_cleanup=None):
    """First SIGTERM/SIGINT: set ``done`` (orderly shutdown); the second:
    flight dump, ``hard_cleanup()`` (the plane kills its children) and
    exit 130 at once."""
    state = {"armed": False}

    def on_signal(signum, frame):
        name = signal.Signals(signum).name
        if state["armed"]:
            telemetry.get().dump_flight("hard_abort", signal=name)
            if hard_cleanup is not None:
                hard_cleanup()
            os._exit(130)
        state["armed"] = True
        telemetry.get().dump_flight("preempt_signal", signal=name)
        done.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, on_signal)


def _serve_until_signal(server, done: threading.Event, what: str):
    """``serve_forever`` on a worker thread while the main thread waits for
    the signal (``shutdown()`` from the serving thread would deadlock)."""
    t = threading.Thread(target=server.serve_forever, name="serve-http",
                         daemon=True)
    t.start()
    logger.info("serving %s", what)
    done.wait()
    server.shutdown()
    server.server_close()


def choose_mode(args) -> str:
    """argv → serving mode: a replica child first (never recurse into a
    plane), then the plane, else the single server."""
    if args.replica_index >= 0:
        return "replica"
    if args.replicas > 1:
        return "plane"
    return "single"


def watch_checkpoints(args, engine, predictor, cfg) -> CheckpointWatcher:
    """The single server's ``--watch-checkpoints``: a started watcher that
    swaps each newer checkpoint into this engine."""
    def reload(target):
        ok, _ = reload_engine_params(
            engine, predictor, cfg,
            dict(target, generation=engine.generation + 1))
        return ok

    return CheckpointWatcher(args.watch_checkpoints, reload,
                             interval_s=args.watch_interval_s).start()


def boot_target(args):
    """The checkpoint the replicas boot from as a reload target (None
    with ``--synthetic``)."""
    if args.synthetic:
        return None
    return {"prefix": args.prefix, "kind": "epoch", "epoch": args.epoch,
            "consumed": 0}


def main(args) -> dict:
    """Serve until a signal; returns the final ``/metrics`` (the pool's
    under ``--models``, the supervisor's for the plane)."""
    setup_logging()
    mode = choose_mode(args)
    if mode == "replica":
        # before anything touches CUDA: the child's device group
        apply_replica_devices()
    if not args.unix_socket and not args.port:
        raise SystemExit("pass --port or --unix-socket")
    if args.cascade and not args.models:
        raise SystemExit("--cascade routes between two --models entries; "
                         "pass --models SMALL=...,BIG=... (and "
                         "--serve-e2e)")
    if args.models and mode != "single":
        raise SystemExit(f"--models requires single-process mode "
                         f"(got mode {mode!r})")
    if args.stream and mode != "single":
        raise SystemExit(
            f"--stream requires single-process mode (got mode "
            f"{mode!r}: drop --replicas/--fabric/--join/--pool-file "
            f"or run one streaming server per device)")
    if args.models and args.watch_checkpoints:
        raise SystemExit("--watch-checkpoints reloads one model's engine; "
                         "it does not combine with --models")
    resolve_device(args.device)  # no card and no --device cpu: raise now
    if mode == "replica":
        return main_replica(args)
    if mode == "plane":
        return main_plane(args)
    if args.telemetry_dir:
        telemetry.configure(args.telemetry_dir, run_meta={
            "driver": "serve", "network": args.network,
            "models": args.models, "serve_batch": args.serve_batch,
            "max_delay_ms": args.max_delay_ms,
            "serve_e2e": args.serve_e2e})
    done = threading.Event()
    _install_signals(done)
    where = args.unix_socket or f"http://{args.host}:{args.port}"
    addr = dict(port=args.port or None, host=args.host,
                unix_socket=args.unix_socket or None)
    if args.models:
        pool = None
        try:
            pool, streams, cascade = build_pool(args)
            default = pool.default_model
            server = make_server(pool.engine_for(default),
                                 stream=streams.get(default), pool=pool,
                                 streams=streams, cascade=cascade, **addr)
            _serve_until_signal(server, done, (
                f"{len(pool.model_ids())} model(s) {pool.model_ids()} on "
                f"{where} (batch={args.serve_batch}, weight budget "
                f"{args.weight_budget_mb:g} MB, cascade={args.cascade!r})"))
            logger.info("shutting down: %s", pool.metrics()["pool"])
        finally:
            final = None
            if pool is not None:
                pool.stop()
                final = pool.metrics()
            _close_telemetry(final)
        return final
    cfg = config_from_args(args, train=False)
    predictor, engine = build_engine(args, cfg)
    controller = watcher = None
    try:
        warmup(engine)
        if args.watch_checkpoints:
            watcher = watch_checkpoints(args, engine, predictor, cfg)
        stream = _stream_manager(args, engine) if args.stream else None
        if args.target_p99_ms > 0:
            controller = SLOController(engine, ControllerOptions(
                target_p99_ms=args.target_p99_ms,
                interval_s=args.slo_interval_ms / 1e3,
                window_s=args.slo_window_s)).start()
        server = make_server(engine, stream=stream, **addr)
        _serve_until_signal(server, done, (
            f"{args.network} on {where} (batch={args.serve_batch}, "
            f"max_delay={args.max_delay_ms:.0f}ms, max_queue="
            f"{args.max_queue}, e2e={args.serve_e2e}, stream={args.stream}, "
            f"device={engine.predictor.device})"))
        logger.info("shutting down: %s", engine.metrics()["counters"])
    finally:
        if watcher is not None:
            watcher.stop()
        if controller is not None:
            controller.stop()
        engine.stop()
        final = engine.metrics()
        _close_telemetry(final)
    return final


def main_replica(args) -> dict:
    """One replica child (``--replica-index I``, set by the plane): the
    engine stack on the supervisor's Unix socket, its telemetry as rank
    I + 1 of the plane's world."""
    if not args.unix_socket:
        raise SystemExit("--replica-index requires --unix-socket")
    if args.telemetry_dir:
        telemetry.configure(args.telemetry_dir, rank=args.replica_index + 1,
                            world=max(args.replicas, 1) + 1, run_meta={
                                "driver": "serve", "network": args.network,
                                "replica": args.replica_index})
    cfg = config_from_args(args, train=False)
    predictor, engine = build_engine(args, cfg)
    done = threading.Event()
    _install_signals(done)
    try:
        serve_replica(engine, cfg, args.unix_socket,
                      index=args.replica_index, predictor=predictor,
                      done=done)
    finally:
        engine.stop()
        final = engine.metrics()
        _close_telemetry(final)
    return final


def main_plane(args) -> dict:
    """The supervisor parent (``--replicas N``, N > 1): no model and no
    device; it spawns N replica children, routes ``/predict`` over the
    ready ones, respawns the dead and rolls the watched checkpoints
    through them.  Raises ``SystemExit`` when every replica has
    failed."""
    if args.telemetry_dir:
        telemetry.configure(args.telemetry_dir, rank=0,
                            world=args.replicas + 1, run_meta={
                                "driver": "serve", "network": args.network,
                                "replicas": args.replicas})
    sock_dir = tempfile.mkdtemp(prefix="mxr_replicas_")
    specs = replica_specs(["serve"] + args.argv, args.replicas, sock_dir,
                          devices=args.replica_devices)
    sup = ReplicaSupervisor(specs, boot_target=boot_target(args))
    # no orphans on any exit path: drain, exception or the second signal
    atexit.register(sup.sweep)
    done = threading.Event()
    _install_signals(done, hard_cleanup=lambda: sup.sweep(0.0))
    watcher = server = None
    try:
        sup.start()
        router = ReplicaRouter(sup)
        server = make_router_server(router, port=args.port or None,
                                    host=args.host,
                                    unix_socket=args.unix_socket or None)
        if args.watch_checkpoints:
            watcher = CheckpointWatcher(args.watch_checkpoints,
                                        sup.reload_to,
                                        interval_s=args.watch_interval_s)
            watcher.start()
        threading.Thread(target=server.serve_forever, name="router-http",
                         daemon=True).start()
        where = args.unix_socket or f"http://{args.host}:{args.port}"
        logger.info("serving plane: %d replica(s) behind %s (sockets "
                    "under %s)", args.replicas, where, sock_dir)
        # park until a signal or the systemic failure of every replica
        while not (done.wait(0.5) or sup.broken.is_set()):
            pass
        broken = sup.broken.is_set() and not done.is_set()
        logger.info("plane shutting down: %s", sup.metrics()["counters"])
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if watcher is not None:
            watcher.stop()
        sup.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
        final = sup.metrics()
        _close_telemetry(final)
    if broken:
        raise SystemExit("serving plane is down: every replica crossed the "
                         "respawn limit (see the flight dumps)")
    return final


def _close_telemetry(final):
    tel = telemetry.get()
    if tel.enabled and final is not None:
        tel.write_summary(extra={"serve": final})
    telemetry.shutdown()
