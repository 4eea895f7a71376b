"""Telemetry (counterpart of ``mx_rcnn_tpu/telemetry/__init__.py``):
structured run-time instrumentation, stdlib only.

One module-global active sink, so instrumented code records into whatever
run is active without a handle threaded through every constructor::

    from mx_rcnn_tpu_torch import telemetry

    telemetry.configure(out_dir)
    with telemetry.get().span("serve/forward"):
        ...
    telemetry.get().counter("serve/recompile")
    telemetry.shutdown()   # close the event file, restore the no-op sink

Unconfigured, ``get()`` returns the shared :data:`NULL` no-op sink.  The
serve driver exposes it as ``--telemetry-dir``.  ``tracectx`` holds the
request-trace context and ``obs`` the Prometheus exposition of the serve
``/metrics``.
"""

from __future__ import annotations

from typing import Optional

from mx_rcnn_tpu_torch.telemetry.sink import (HIST_LE, NULL, RING_SIZE,
                                              SCHEMA_VERSION, SUMMARY_NAME,
                                              Hist, NullTelemetry, Telemetry,
                                              quantile_from_counts)

__all__ = ["Telemetry", "NullTelemetry", "NULL", "RING_SIZE",
           "SCHEMA_VERSION", "SUMMARY_NAME", "Hist", "HIST_LE",
           "quantile_from_counts", "configure", "get", "reset_null",
           "shutdown"]

_active: "NullTelemetry | Telemetry" = NULL


def configure(out_dir: str, rank: int = 0, world: int = 1,
              run_meta: Optional[dict] = None, stream: bool = True,
              trace: Optional[bool] = None) -> Telemetry:
    """Open a run's sink and make it the active one; a live sink is closed
    first (one active run per process).  ``stream=False`` keeps the sink
    in memory (aggregates and flight ring, no event file).  ``trace`` opts
    span records into wall-start timestamps (default: the
    ``MXR_TELEMETRY_TRACE`` environment variable)."""
    global _active
    if _active.enabled:
        _active.close()
    _active = Telemetry(out_dir, rank=rank, world=world, run_meta=run_meta,
                        stream=stream, trace=trace)
    return _active


def get() -> "NullTelemetry | Telemetry":
    """The active sink (the no-op :data:`NULL` when none is configured)."""
    return _active


def reset_null():
    """Drop the active sink WITHOUT closing it — for a forked child that
    inherits the parent's open event stream and must neither write to it
    nor close it."""
    global _active
    _active = NULL


def shutdown():
    """Close the active sink and restore the no-op default."""
    global _active
    _active.close()
    _active = NULL
