"""Online serving (counterpart of ``mx_rcnn_tpu/serve``), the
single-process server:

* ``engine``     — the bucket-aware dynamic batcher over a ``Predictor``
  (deadline flush, partial-batch padding, bounded-queue backpressure,
  per-request deadlines), in host-NMS or single-dispatch (``serve_e2e``)
  mode, both on the NMS kernels, for every network of the presets (C4,
  VGG-16, FPN and Mask R-CNN, which serves boxes);
* ``warmup``     — the first dispatch of every (bucket, batch) program
  before traffic; completion is readiness;
* ``stream``     — sequenced frames per stream over the batcher, with the
  frame-delta skip gate on the card;
* ``pool``       — several models on one device (registry, weight paging
  under a byte budget, one cross-model dispatcher) and the cascade that
  escalates hard images from a small model to a big one;
* ``frontend``   — stdlib HTTP (``/predict``, ``/stream``, ``/healthz``,
  ``/readyz``, ``/metrics``) over TCP or a Unix socket, its clients, and
  stdio;
* ``controller`` — the SLO controller: per-bucket flush batch and delay
  toward ``--target-p99-ms``, and load shedding on the queue trend;
* ``replica``    — hot reload (quiesce, swap, canary, bitwise rollback),
  the checkpoint watcher, the fault injectors and a replica child's main
  loop;
* ``supervisor`` — the replica plane's parent: probes, respawn with
  backoff, the retrying router and the rolling reload.

Driver: ``python -m mx_rcnn_tpu_torch.serve`` (``serve/driver.py``).
The fabric, the autoscaler, capture and the watchtower are not ported yet
(ROADMAP.md A.7.5–A.7.10).
"""

from mx_rcnn_tpu_torch.serve.controller import ControllerOptions, SLOController
from mx_rcnn_tpu_torch.serve.engine import (DeadlineExceededError,
                                            RejectedError, ServeEngine,
                                            ServeFuture, ServeOptions)
from mx_rcnn_tpu_torch.serve.frontend import (encode_image_payload,
                                              make_server, run_stdio,
                                              run_stream_stdio,
                                              tcp_http_request,
                                              tcp_http_request_raw,
                                              unix_http_request,
                                              unix_http_request_raw)
from mx_rcnn_tpu_torch.serve.pool import (CascadeFuture, CascadeRouter,
                                          ModelEntry, ModelPool,
                                          param_nbytes)
from mx_rcnn_tpu_torch.serve.replica import (CheckpointWatcher, NetFaults,
                                             ReplicaFaults, canary_probe,
                                             load_serving_params,
                                             make_reloader, poison_params,
                                             reload_engine_params,
                                             scan_checkpoints, serve_replica)
from mx_rcnn_tpu_torch.serve.stream import (FrameResult, StaleSeqError,
                                            StreamManager, StreamOptions)
from mx_rcnn_tpu_torch.serve.supervisor import (ReplicaRouter, ReplicaSpec,
                                                ReplicaSupervisor,
                                                SupervisorOptions,
                                                TokenBucket,
                                                build_child_argv,
                                                make_router_server,
                                                replica_specs)
from mx_rcnn_tpu_torch.serve.warmup import warmup

__all__ = ["ServeEngine", "ServeOptions", "ServeFuture", "RejectedError",
           "DeadlineExceededError", "SLOController", "ControllerOptions",
           "make_server", "run_stdio", "unix_http_request",
           "unix_http_request_raw", "tcp_http_request",
           "tcp_http_request_raw", "encode_image_payload", "warmup",
           "run_stream_stdio", "StreamManager", "StreamOptions",
           "StaleSeqError", "FrameResult", "ModelPool", "ModelEntry",
           "CascadeRouter", "CascadeFuture", "param_nbytes",
           "CheckpointWatcher", "ReplicaFaults", "NetFaults", "canary_probe",
           "load_serving_params", "make_reloader", "poison_params",
           "reload_engine_params", "scan_checkpoints", "serve_replica",
           "ReplicaRouter", "ReplicaSpec", "ReplicaSupervisor",
           "SupervisorOptions", "TokenBucket", "build_child_argv",
           "make_router_server", "replica_specs"]
