"""First-dispatch bookkeeping (the dispatch half of
``mx_rcnn_tpu/compile/registry.py``: the per-process (kind, shape) key
space, ``note_dispatch``, ``record_compile_seconds``, the counters and
``snapshot``).

PyTorch compiles nothing ahead of a call, but the first dispatch of a
shape still costs what a steady-state one does not: on the card, cuDNN
chooses its convolution algorithms for the new shapes (``cudnn.benchmark``
off: the heuristic's choice, plus the workspace allocation) and the
caching allocator grows its pools; the very first dispatch of a process
also builds the hand kernels with ``nvcc`` (``kernels/_build.py``, at
first use).  The serve engine counts these first dispatches as its
"recompiles" and warmup makes every one of them happen before traffic, so
the steady state must never add one.  There is no persistent program
cache here, so the JAX registry's AOT hit/miss accounting and its
callable cache have no counterpart.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from typing import Dict, Iterable, Tuple

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.telemetry import Hist


def config_digest(cfg) -> str:
    """sha1 over the frozen config tree (16 hex chars); ``"none"`` for a
    predictor without a config."""
    if cfg is None:
        return "none"
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


class ProgramRegistry:
    """The programs one model has dispatched in this process, keyed by
    (kind, shape): ``shape`` is the input's shape, optionally extended with
    string tokens for statics of the call (``"mpi=100"``)."""

    def __init__(self, cfg=None, dtype: str = "float32"):
        self.digest = config_digest(cfg)
        self.dtype = dtype
        self._lock = threading.Lock()
        self._seen: Dict[Tuple[str, Tuple], dict] = {}
        self.counters: Dict[str, int] = {"programs": 0}
        self.compile_hist = Hist()

    @staticmethod
    def key_for(kind: str, shape: Iterable) -> Tuple[str, Tuple]:
        return kind, tuple(s if isinstance(s, str) else int(s)
                           for s in shape)

    def note_dispatch(self, kind: str, shape: Iterable) -> bool:
        """True exactly once per (kind, shape) per process: the caller's
        "this dispatch is the first of its program" signal."""
        key = self.key_for(kind, shape)
        with self._lock:
            if key in self._seen:
                return False
            self._seen[key] = {"t": time.time()}
            self.counters["programs"] += 1
        telemetry.get().meta("compile/program", kind=kind,
                             shape=list(key[1]), dtype=self.dtype,
                             digest=self.digest)
        return True

    def record_compile_seconds(self, kind: str, shape: Iterable,
                               seconds: float) -> None:
        """Observe one program's first-dispatch wall time into the
        registry's and the active sink's compile histograms."""
        self.compile_hist.observe(seconds)
        tel = telemetry.get()
        tel.observe("compile/seconds", seconds)
        tel.observe(f"compile/seconds/{kind}", seconds)
        with self._lock:
            info = self._seen.get(self.key_for(kind, shape))
            if info is not None:
                info["compile_s"] = seconds

    def snapshot(self) -> dict:
        """JSON-able state for ``/metrics``: the counters and every
        program by kind, shape and first-dispatch seconds."""
        with self._lock:
            counters = dict(self.counters)
            seen = [dict(kind=k, shape=list(s), dtype=self.dtype,
                         compile_s=round(v.get("compile_s", 0.0), 3))
                    for (k, s), v in self._seen.items()]
        return {"digest": self.digest, "dtype": self.dtype,
                "counters": counters, "programs": seen,
                "compile_seconds": self.compile_hist.to_dict()}
