"""Stdlib HTTP and stdio frontends over :class:`ServeEngine` (counterpart
of ``mx_rcnn_tpu/serve/frontend.py``).

Transports, one JSON contract:

* TCP HTTP (``make_server(engine, port=...)``);
* Unix-socket HTTP (``make_server(engine, unix_socket=path)``), the same
  handler over ``AF_UNIX``; ``unix_http_request`` is its client;
* stdio (``run_stdio``, ``run_stream_stdio``): newline-delimited JSON
  over stdin/stdout.

Endpoints:

* ``POST /predict`` — body ``{"shape": [h, w, 3], "data": <base64 raw
  uint8 RGB bytes>}`` (or ``"pixels"``: nested lists), optional
  ``"deadline_ms"`` and ``"trace"``.  200 → ``{"detections": [{"cls",
  "score", "bbox"}...], "queue_wait_ms", "batch_row"}`` (``batch_row``:
  the request's row in the batch it rode); 503 queue full or load shed
  (retry with backoff); 504 deadline exceeded; 400 malformed; 500 the
  batch failed.  A client's trace id (the ``X-Mxr-Trace`` header or the
  ``"trace"`` field) is echoed back as ``"trace"``.  With a model pool,
  ``?model=ID`` (or a ``"model"`` field) picks the model, 404 for an
  unknown id; with a cascade, the reply grows ``"cascade"`` (which model
  answered and why).
* ``POST /stream`` — sequenced frames, when the server has a stream
  manager (``--stream``; 404 otherwise).  The body is NDJSON, one frame a
  line: a predict payload plus ``"stream_id"`` (str) and ``"seq"``
  (strictly increasing int per stream).  Every frame of a body is
  submitted before any is waited on, so one client's burst fills batches
  beside other streams.  The reply is NDJSON in submit order, each line
  ``{"status", "stream_id", "seq", "skipped", "detections",
  "queue_wait_ms"}`` (plus ``"delta"`` when the gate ran); the statuses
  are ``/predict``'s, plus 409 for a stale ``seq``.  The envelope is 200
  once the body is read.  With a pool, ``?model=ID`` picks that model's
  manager.
* ``GET /healthz`` — liveness: 200 while the process answers.
* ``GET /readyz`` — readiness: 200 only once warmup is done and
  admissions are open; 503 otherwise.
* ``GET /metrics`` — the engine's counters, queue state, latency
  quantiles, policy and compile snapshot as JSON (with a pool: every
  model's, summed and per model, with ``pool``, ``residency`` and
  ``cascade`` sections); with ``Accept: text/plain`` or
  ``?format=prom``, the Prometheus text of ``telemetry/obs.py``.

* ``POST /admin/reload`` — with a ``reloader`` (a replica's, see
  ``serve/replica.py:make_reloader``), the body is a reload target
  ``{"prefix", "kind", "epoch", "consumed"}`` (optionally
  ``"generation"``): 200 when the new generation is live, 409 when it was
  rejected and rolled back, 400 on a malformed target; 404 without a
  reloader, as the JAX frontend answers.

``/stream`` without a stream manager and a ``?model=`` selector without a
pool answer 404 too.  Three optional hooks serve the replica plane's
fault injection (``serve/replica.py``): ``gate()`` runs before any
handling, ``net_faults.intercept(path, handler)`` may consume a request
(blackhole, reset, delay), and ``request_hook(status)`` runs after each
``/predict`` reply.  Request threads (``ThreadingHTTPServer``) decode and
stage images concurrently, which is what fills batches.
"""

from __future__ import annotations

import base64
import json
import os
import socket
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from mx_rcnn_tpu_torch.logger import logger
from mx_rcnn_tpu_torch.serve.engine import (DeadlineExceededError,
                                            RejectedError, ServeEngine)
from mx_rcnn_tpu_torch.serve.stream import StaleSeqError, StreamManager
from mx_rcnn_tpu_torch.telemetry.obs import (PROM_CONTENT_TYPE,
                                             pool_prometheus,
                                             serve_prometheus)
from mx_rcnn_tpu_torch.telemetry.tracectx import TRACE_HEADER

# result-wait ceiling for one HTTP request; the engine's own deadline fires
# long before it, the ceiling only bounds a wedged dispatcher
WAIT_TIMEOUT_S = 600.0


def decode_image_payload(doc: dict) -> np.ndarray:
    """Request JSON → (H, W, 3) uint8 RGB array.  Raises ValueError on a
    malformed payload (the handler's 400)."""
    if "pixels" in doc:
        img = np.asarray(doc["pixels"], np.uint8)
    elif "data" in doc:
        shape = doc.get("shape")
        if (not isinstance(shape, (list, tuple)) or len(shape) != 3
                or shape[2] != 3):
            raise ValueError(f"'shape' must be [h, w, 3], got {shape!r}")
        raw = base64.b64decode(doc["data"], validate=True)
        h, w, c = (int(x) for x in shape)
        if len(raw) != h * w * c:
            raise ValueError(f"'data' holds {len(raw)} bytes, shape "
                             f"{shape} needs {h * w * c}")
        img = np.frombuffer(raw, np.uint8).reshape(h, w, c)
    else:
        raise ValueError("payload needs 'data'+'shape' (base64 raw RGB "
                         "bytes) or 'pixels' (nested lists)")
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {img.shape}")
    return img


def encode_image_payload(img: np.ndarray) -> dict:
    """The client half of the contract."""
    img = np.ascontiguousarray(img, np.uint8)
    return {"shape": list(img.shape),
            "data": base64.b64encode(img.tobytes()).decode("ascii")}


def _predict_doc(engine: ServeEngine, doc: dict, img, cascade=None,
                 model_id=None) -> tuple:
    """Submit + wait for one predict request → (status, response doc).
    With a ``cascade`` router the submit goes through it and the reply
    carries its ``"cascade"`` provenance."""
    try:
        if cascade is not None:
            fut = cascade.submit(img, deadline_ms=doc.get("deadline_ms"),
                                 model_id=model_id)
        else:
            fut = engine.submit(img, deadline_ms=doc.get("deadline_ms"))
        dets = fut.result(timeout=WAIT_TIMEOUT_S)
    except RejectedError as e:
        return 503, {"error": str(e)}
    except (DeadlineExceededError, TimeoutError) as e:
        return 504, {"error": str(e)}
    except Exception as e:  # noqa: BLE001 — surface as a 500, keep serving
        logger.exception("predict failed")
        return 500, {"error": f"{type(e).__name__}: {e}"}
    qms = (fut.queue_wait_s or 0.0) * 1e3
    resp = {"detections": dets, "queue_wait_ms": round(qms, 3),
            "batch_row": getattr(fut, "batch_row", None)}
    if cascade is not None:
        resp["cascade"] = fut.provenance()
    return 200, resp


def handle_request_doc(engine: ServeEngine, doc: dict,
                       trace_header: Optional[str] = None, cascade=None,
                       model_id=None) -> tuple:
    """One predict request → (http_status, response_doc), shared by every
    transport.

    A trace id sent in the ``X-Mxr-Trace`` header or the ``"trace"`` doc
    field is echoed back as ``"trace"`` (the JAX frontend's answer with
    tracing off; no spans are recorded)."""
    try:
        img = decode_image_payload(doc)
    except (ValueError, TypeError, KeyError) as e:
        return 400, {"error": str(e)}
    raw = trace_header or doc.get("trace")
    status, resp = _predict_doc(engine, doc, img, cascade=cascade,
                                model_id=model_id)
    if raw:
        resp["trace"] = str(raw).split("-", 1)[0]
    return status, resp


def submit_stream_frame(stream: StreamManager, doc: dict) -> tuple:
    """Check and submit one stream frame without waiting: the submit half
    of ``/stream``.  ``(None, None, FrameResult)`` on acceptance, else
    ``(status, error_doc, None)``."""
    sid, seq = doc.get("stream_id"), doc.get("seq")
    if not isinstance(sid, str) or not sid:
        return 400, {"error": "frame needs a non-empty string "
                              "'stream_id'"}, None
    if not isinstance(seq, int) or isinstance(seq, bool):
        return 400, {"error": "frame needs an integer 'seq'",
                     "stream_id": sid}, None
    try:
        img = decode_image_payload(doc)
    except (ValueError, TypeError, KeyError) as e:
        return 400, {"error": str(e), "stream_id": sid, "seq": seq}, None
    try:
        res = stream.submit_frame(sid, seq, img,
                                  deadline_ms=doc.get("deadline_ms"))
    except StaleSeqError as e:
        return 409, {"error": str(e), "stream_id": sid, "seq": seq}, None
    except RejectedError as e:
        return 503, {"error": str(e), "stream_id": sid, "seq": seq}, None
    except Exception as e:  # noqa: BLE001 — surface as a 500, keep serving
        logger.exception("stream submit failed")
        return 500, {"error": f"{type(e).__name__}: {e}",
                     "stream_id": sid, "seq": seq}, None
    return None, None, res


def resolve_stream_frame(res) -> tuple:
    """The wait half: one accepted ``FrameResult`` → ``(status,
    response_doc)`` with ``/predict``'s statuses."""
    try:
        dets = res.result(timeout=WAIT_TIMEOUT_S)
    except RejectedError as e:
        return 503, {"error": str(e), "stream_id": res.stream_id,
                     "seq": res.seq}
    except (DeadlineExceededError, TimeoutError) as e:
        return 504, {"error": str(e), "stream_id": res.stream_id,
                     "seq": res.seq}
    except Exception as e:  # noqa: BLE001
        logger.exception("stream frame failed")
        return 500, {"error": f"{type(e).__name__}: {e}",
                     "stream_id": res.stream_id, "seq": res.seq}
    out = {"stream_id": res.stream_id, "seq": res.seq,
           "skipped": res.skipped, "detections": dets,
           "queue_wait_ms": round((res.queue_wait_s or 0.0) * 1e3, 3)}
    if res.delta is not None:
        out["delta"] = round(res.delta, 4)
    prov = res.cascade()
    if prov is not None:
        out["cascade"] = prov
    return 200, out


def handle_stream_doc(stream: StreamManager, doc: dict) -> tuple:
    """One frame, submit and wait → (status, response_doc): the stdio
    transport's unit."""
    status, err, res = submit_stream_frame(stream, doc)
    if res is None:
        return status, err
    return resolve_stream_frame(res)


def handle_stream_lines(stream: StreamManager, lines) -> list:
    """An NDJSON body → (status, doc) replies in input order.  Every frame
    is submitted before any is resolved, so one connection's burst
    coalesces into shared batches."""
    staged = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except json.JSONDecodeError as e:
            staged.append((400, {"error": f"bad JSON line: {e}"}, None))
            continue
        staged.append(submit_stream_frame(stream, doc))
    return [(status, err) if res is None else resolve_stream_frame(res)
            for status, err, res in staged]


def query_model(query: str) -> Optional[str]:
    """``model=...`` from a raw query string (None if absent)."""
    for part in query.split("&"):
        k, _, v = part.partition("=")
        if k == "model" and v:
            return v
    return None


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    engine: ServeEngine = None  # set by make_server subclassing
    stream: Optional[StreamManager] = None  # enables POST /stream
    pool = None      # a ModelPool: enables ?model= routing
    streams = None   # with a pool: {model_id: StreamManager}
    cascade = None   # a CascadeRouter: /predict rides it
    reloader = None      # callback(doc) -> (status, doc): /admin/reload
    request_hook = None  # callback(status) after each /predict
    gate = None          # callback() before any handling
    net_faults = None    # NetFaults: intercept(path, handler) -> consumed

    def _model_id(self, query: str, doc: Optional[dict] = None):
        mid = query_model(query) if query else None
        if mid is None and doc is not None:
            m = doc.get("model")
            if isinstance(m, str) and m:
                mid = m
        return mid

    def _resolve_engine(self, mid: Optional[str]):
        """A model id → ``(engine, None)`` or ``(None, (status, doc))``:
        without a pool any explicit model is a 404 (routing is opt-in with
        ``--models``); with one, the id's own engine."""
        if self.pool is None:
            if mid is not None:
                return None, (404, {"error": f"model routing not enabled "
                                             f"(requested {mid!r}; start "
                                             f"with --models)"})
            return self.engine, None
        try:
            return self.pool.engine_for(mid), None
        except KeyError as e:
            return None, (404, {"error": str(e.args[0]) if e.args
                                else str(e)})

    def log_message(self, fmt, *args):  # route through the logger
        logger.debug("serve http: " + fmt, *args)

    def address_string(self):  # AF_UNIX peers have no (host, port)
        if isinstance(self.client_address, (bytes, str)):
            return "unix"
        return super().address_string()

    def _reply(self, status: int, doc: dict):
        self._reply_raw(status, json.dumps(doc).encode(),
                        "application/json")

    def _reply_raw(self, status: int, body: bytes, ctype: str):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _intercepted(self) -> bool:
        """The fault hooks, before any handling: True when a network
        fault consumed the request."""
        if self.gate is not None:
            self.gate()
        return (self.net_faults is not None
                and self.net_faults.intercept(self.path, self))

    def do_GET(self):
        if self._intercepted():
            return
        path, _, query = self.path.partition("?")
        pool = self.pool
        if path == "/healthz":
            if pool is not None:
                self._reply(200, {"status": "ok",
                                  "models": pool.model_ids(),
                                  "queue_depth": sum(
                                      pool.engine_for(m).queue_depth()
                                      for m in pool.model_ids())})
            else:
                self._reply(200, {"status": "ok",
                                  "queue_depth": self.engine.queue_depth()})
        elif path == "/readyz":
            doc = (pool.readiness() if pool is not None
                   else self.engine.readiness())
            self._reply(200 if doc["ready"] else 503, doc)
        elif path == "/metrics":
            accept = self.headers.get("Accept", "")
            if "format=prom" in query or "text/plain" in accept:
                text = (pool_prometheus(pool) if pool is not None
                        else serve_prometheus(self.engine))
                self._reply_raw(200, text.encode(), PROM_CONTENT_TYPE)
            else:
                self._reply(200, pool.metrics() if pool is not None
                            else self.engine.metrics())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self._intercepted():
            return
        path, _, query = self.path.partition("?")
        if path == "/stream":
            self._post_stream(query)
            return
        if path not in ("/predict", "/admin/reload"):
            self._reply(404, {"error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad JSON body: {e}"})
            return
        if path == "/admin/reload":
            if self.reloader is None:
                self._reply(404, {"error": "no reloader configured"})
            elif not isinstance(doc, dict):
                self._reply(400, {"error": "reload target must be a JSON "
                                           "object"})
            else:
                self._reply(*self.reloader(doc))
            return
        mid = self._model_id(query, doc)
        engine, err = self._resolve_engine(mid)
        if engine is None:
            status, resp = err
        else:
            status, resp = handle_request_doc(
                engine, doc, trace_header=self.headers.get(TRACE_HEADER),
                cascade=self.cascade, model_id=mid)
        self._reply(status, resp)
        if self.request_hook is not None:
            self.request_hook(status)

    def _post_stream(self, query: str):
        """``/stream``: with a pool, ``?model=`` picks that model's
        manager (the default model's without one)."""
        stream = self.stream
        if self.pool is not None:
            mid = query_model(query) or self.pool.default_model
            stream = (self.streams or {}).get(mid)
            if stream is None and mid not in self.pool.model_ids():
                self._reply(404, {"error": f"unknown model {mid!r} "
                                           f"(have {self.pool.model_ids()})"})
                return
        if stream is None:
            self._reply(404, {"error": "streaming not enabled "
                                       "(start with --stream)"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
        except ValueError as e:
            self._reply(400, {"error": f"bad Content-Length: {e}"})
            return
        replies = handle_stream_lines(
            stream, body.decode("utf-8", "replace").splitlines())
        payload = "".join(json.dumps({"status": st, **d}) + "\n"
                          for st, d in replies)
        self._reply_raw(200, payload.encode(), "application/x-ndjson")


class _TCPHTTPServer(ThreadingHTTPServer):
    # the stdlib backlog (5) drops connections under the very bursts the
    # engine's backpressure answers with 503s
    request_queue_size = 128


class _UnixHTTPServer(_TCPHTTPServer):
    address_family = socket.AF_UNIX

    def server_bind(self):
        # a stale socket file from a killed process blocks bind
        if os.path.exists(self.server_address):
            os.unlink(self.server_address)
        super().server_bind()

    def client_address_string(self):
        return "unix"


def make_server(engine: ServeEngine, port: Optional[int] = None,
                host: str = "127.0.0.1",
                unix_socket: Optional[str] = None,
                stream: Optional[StreamManager] = None, pool=None,
                streams: Optional[dict] = None, cascade=None,
                reloader=None, request_hook=None, gate=None,
                net_faults=None):
    """Build (not start) the HTTP server on exactly one of ``port`` /
    ``unix_socket``.  The caller owns ``serve_forever``/``shutdown``.

    ``reloader`` enables ``POST /admin/reload``; ``request_hook(status)``
    runs after each ``/predict`` reply and ``gate()`` before any handling
    (the replica plane's kill and hang injection points); ``net_faults``
    (``intercept(path, handler) -> bool``) may blackhole, delay or reset a
    request below both.

    ``stream`` enables ``POST /stream``.  ``pool`` (a
    :class:`~mx_rcnn_tpu_torch.serve.pool.ModelPool`) turns on
    ``?model=`` routing over its engines (``streams``: model id → stream
    manager), and ``/metrics`` and ``/readyz`` report the whole pool;
    ``engine`` stays the default model's.  ``cascade`` routes
    ``/predict`` through a
    :class:`~mx_rcnn_tpu_torch.serve.pool.CascadeRouter`."""
    if (port is None) == (unix_socket is None):
        raise ValueError("pass exactly one of port / unix_socket")

    class Handler(_Handler):
        pass

    Handler.engine = engine
    Handler.stream = stream
    Handler.pool = pool
    Handler.streams = streams
    Handler.cascade = cascade
    # staticmethod: a plain function on the class would bind as a method
    Handler.reloader = staticmethod(reloader) if reloader else None
    Handler.request_hook = (staticmethod(request_hook) if request_hook
                            else None)
    Handler.gate = staticmethod(gate) if gate else None
    Handler.net_faults = net_faults
    if unix_socket is not None:
        return _UnixHTTPServer(unix_socket, Handler)
    return _TCPHTTPServer((host, port), Handler)


def _http_raw(conn, method: str, path: str, body: Optional[bytes],
              headers: Optional[dict]) -> tuple:
    try:
        hdrs = dict(headers or {})
        if body:
            hdrs.setdefault("Content-Type", "application/json")
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        return (resp.status, resp.read(),
                resp.getheader("Content-Type") or "")
    finally:
        conn.close()


def _as_doc(status: int, raw: bytes, ctype: str) -> tuple:
    if "json" in ctype:
        return status, json.loads(raw)
    return status, raw.decode()


def unix_http_request_raw(sock_path: str, method: str, path: str,
                          body: Optional[bytes] = None,
                          timeout: float = 60.0,
                          headers: Optional[dict] = None) -> tuple:
    """Byte-level HTTP over a Unix socket → (status, body_bytes, ctype).
    Raises ``OSError`` on transport failure."""
    import http.client

    class Conn(http.client.HTTPConnection):
        def __init__(self):
            super().__init__("localhost", timeout=timeout)

        def connect(self):
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.sock.settimeout(timeout)
            self.sock.connect(sock_path)

    return _http_raw(Conn(), method, path, body, headers)


def unix_http_request(sock_path: str, method: str, path: str,
                      doc: Optional[dict] = None, timeout: float = 60.0,
                      headers: Optional[dict] = None) -> tuple:
    """HTTP over a Unix socket → (status, response_doc): JSON responses
    parsed, anything else (the Prometheus text) as str."""
    body = json.dumps(doc).encode() if doc is not None else None
    return _as_doc(*unix_http_request_raw(sock_path, method, path, body=body,
                                          timeout=timeout, headers=headers))


def tcp_http_request_raw(host: str, port: int, method: str, path: str,
                         body: Optional[bytes] = None,
                         timeout: float = 60.0,
                         headers: Optional[dict] = None) -> tuple:
    """Byte-level HTTP over TCP → (status, body_bytes, ctype)."""
    import http.client

    return _http_raw(http.client.HTTPConnection(host, port, timeout=timeout),
                     method, path, body, headers)


def tcp_http_request(host: str, port: int, method: str, path: str,
                     doc: Optional[dict] = None, timeout: float = 60.0,
                     headers: Optional[dict] = None) -> tuple:
    """HTTP over TCP → (status, response_doc), as
    :func:`unix_http_request`."""
    body = json.dumps(doc).encode() if doc is not None else None
    return _as_doc(*tcp_http_request_raw(host, port, method, path, body=body,
                                         timeout=timeout, headers=headers))


def run_stdio(engine: ServeEngine, inp=None, out=None):
    """Newline-delimited JSON over stdin/stdout: each input line a predict
    payload, each output line ``{"status": N, ...response}``.  Returns on
    EOF."""
    inp = inp if inp is not None else sys.stdin
    out = out if out is not None else sys.stdout
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except json.JSONDecodeError as e:
            status, resp = 400, {"error": f"bad JSON line: {e}"}
        else:
            status, resp = handle_request_doc(engine, doc)
        out.write(json.dumps({"status": status, **resp}) + "\n")
        out.flush()


def run_stream_stdio(stream: StreamManager, inp=None, out=None):
    """The stream twin of :func:`run_stdio`: each input line a frame
    (predict payload plus ``stream_id``/``seq``), each output line
    ``{"status": N, ...}``.  Returns on EOF."""
    inp = inp if inp is not None else sys.stdin
    out = out if out is not None else sys.stdout
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except json.JSONDecodeError as e:
            status, resp = 400, {"error": f"bad JSON line: {e}"}
        else:
            status, resp = handle_stream_doc(stream, doc)
        out.write(json.dumps({"status": status, **resp}) + "\n")
        out.flush()
