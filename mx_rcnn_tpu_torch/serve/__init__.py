"""Online serving (counterpart of ``mx_rcnn_tpu/serve``), the
single-process server:

* ``engine``     — the bucket-aware dynamic batcher over a ``Predictor``
  (deadline flush, partial-batch padding, bounded-queue backpressure,
  per-request deadlines), in host-NMS or single-dispatch (``serve_e2e``)
  mode, both on the NMS kernels;
* ``warmup``     — the first dispatch of every (bucket, batch) program
  before traffic; completion is readiness;
* ``frontend``   — stdlib HTTP (``/predict``, ``/healthz``, ``/readyz``,
  ``/metrics``) over TCP or a Unix socket, its clients, and stdio;
* ``controller`` — the SLO controller: per-bucket flush batch and delay
  toward ``--target-p99-ms``, and load shedding on the queue trend.

Driver: ``python -m mx_rcnn_tpu_torch.serve`` (``serve/driver.py``).
Streaming, model pools and cascade, hot reload, replicas, the fabric, the
autoscaler, capture and the watchtower are not ported yet (ROADMAP.md).
"""

from mx_rcnn_tpu_torch.serve.controller import ControllerOptions, SLOController
from mx_rcnn_tpu_torch.serve.engine import (DeadlineExceededError,
                                            RejectedError, ServeEngine,
                                            ServeFuture, ServeOptions)
from mx_rcnn_tpu_torch.serve.frontend import (encode_image_payload,
                                              make_server, run_stdio,
                                              tcp_http_request,
                                              tcp_http_request_raw,
                                              unix_http_request,
                                              unix_http_request_raw)
from mx_rcnn_tpu_torch.serve.warmup import warmup

__all__ = ["ServeEngine", "ServeOptions", "ServeFuture", "RejectedError",
           "DeadlineExceededError", "SLOController", "ControllerOptions",
           "make_server", "run_stdio", "unix_http_request",
           "unix_http_request_raw", "tcp_http_request",
           "tcp_http_request_raw", "encode_image_payload", "warmup"]
