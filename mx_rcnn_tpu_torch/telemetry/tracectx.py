"""Request-trace context (the header half of
``mx_rcnn_tpu/telemetry/tracectx.py``): :class:`TraceContext` — a 128-bit
trace id, a 64-bit parent span id and a sampled flag — and its one
propagation header, :data:`TRACE_HEADER`, in the JAX package's grammar,
so a trace id minted by either package parses in the other.

The serve frontend echoes a client's trace id back in its response.  The
span sink (``Tracer``, tail sampling, the engine's batch-causality spans)
comes with the serve driver's ``--trace`` flags (ROADMAP.md).  Stdlib
only.
"""

from __future__ import annotations

import os
import re
from typing import Optional

# the one propagation header, hop to hop: "trace[-span[-flags]]"
# (32 hex chars - 16 hex chars - 2 hex chars; flags 01 = sampled)
TRACE_HEADER = "X-Mxr-Trace"

_ID_RE = re.compile(r"^[0-9a-f]{8,32}$")
_SID_RE = re.compile(r"^[0-9a-f]{1,16}$")


def _trace_id() -> str:
    return os.urandom(16).hex()


def _span_id() -> str:
    return os.urandom(8).hex()


class TraceContext:
    """One hop's view of a trace: which trace, which parent span, and
    whether spans should be recorded at all.  ``span_id`` is the span
    any child recorded under this context hangs from — ``None`` marks a
    context with no parent yet (freshly minted, or a bare client-sent
    trace id), whose first span is the trace's ROOT."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: Optional[str] = None,
                 sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    @classmethod
    def mint(cls, sampled: bool = True) -> "TraceContext":
        return cls(_trace_id(), None, sampled)

    @classmethod
    def parse(cls, value) -> Optional["TraceContext"]:
        """Accept ``trace``, ``trace-span``, or ``trace-span-flags``
        (the header grammar); None on anything malformed — a frontend
        mints fresh rather than serving a garbage id downstream."""
        if not isinstance(value, str):
            return None
        parts = value.strip().lower().split("-")
        if not parts or not _ID_RE.match(parts[0]):
            return None
        span = None
        sampled = True
        if len(parts) >= 2:
            if not _SID_RE.match(parts[1]):
                return None
            # all-zero span id = "no parent" (the client-mint idiom)
            span = None if set(parts[1]) == {"0"} else parts[1]
        if len(parts) >= 3:
            sampled = parts[2] != "00"
        if len(parts) > 3:
            return None
        return cls(parts[0], span, sampled)

    def to_header(self) -> str:
        return (f"{self.trace_id}-{self.span_id or '0' * 16}-"
                f"{'01' if self.sampled else '00'}")

    def child(self) -> "TraceContext":
        """A downstream context parented on a fresh span id."""
        return TraceContext(self.trace_id, _span_id(), self.sampled)

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, {self.span_id!r}, "
                f"sampled={self.sampled})")
