"""Startup warmup (counterpart of ``mx_rcnn_tpu/serve/warmup.py``): make
the first dispatch of every (bucket, batch) program before traffic.

The first dispatch of a shape costs what later ones do not: cuDNN's
choice of convolution algorithms, the allocator's growth and, in a fresh
process, the ``nvcc`` build of the hand kernels (``compile/registry.py``).
Warmup pushes one full batch of blank images per orientation through the
real engine path (same queue, padding and post-process), so that after it
``counters["recompiles"] == counters["warmup_programs"]`` holds for the
life of the process.
"""

from __future__ import annotations

import time

import numpy as np

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.logger import logger


def warmup(engine) -> int:
    """First-dispatch every (bucket, batch) program through a STARTED
    engine: ``batch_size`` blank images per orientation (full batches
    flush at once), waited on.  Returns the number of programs
    first-dispatched, adds it to ``engine.counters["warmup_programs"]``
    and the ``serve/warmup_programs`` counter, puts the warmup's wall time
    (the kernels' build included in a fresh process) in the
    ``serve/warmup_compile_s`` gauge, and marks the engine ready."""
    assert engine._thread is not None or engine._external, \
        "start() the engine before warmup"
    short, long_ = engine._scale
    t0 = time.perf_counter()
    before = engine.counters["recompiles"]
    for h, w in ((short, long_), (long_, short)):  # landscape, portrait
        dummy = np.zeros((h, w, 3), np.uint8)
        futs = [engine.submit(dummy, deadline_ms=0)  # never expire
                for _ in range(engine.opts.batch_size)]
        for f in futs:
            f.result(timeout=600.0)
    dt = time.perf_counter() - t0
    compiled = engine.counters["recompiles"] - before
    engine.counters["warmup_programs"] += compiled
    # warmup completion IS readiness: /readyz turns 200 here
    engine.mark_ready()
    tel = telemetry.get()
    tel.counter("serve/warmup_programs", compiled)
    tel.gauge("serve/warmup_compile_s", dt)
    logger.info("serve warmup: %d program(s) first-dispatched in %.1fs, "
                "kernel builds included (batch=%d, scale=%s, dtype=%s, "
                "e2e=%s)", compiled, dt, engine.opts.batch_size,
                engine._scale, engine._dtype, engine.opts.serve_e2e)
    return compiled
