"""Fault tolerance (counterpart of ``mx_rcnn_tpu/train/resilience.py``):
step checkpoints and auto-resume, the NaN sentinel's policies, preemption,
and retried checkpoint I/O.

The pieces ``fit`` (``train/trainer.py``), the checkpoint manager
(``train/checkpoint.py``) and the drivers (``tools/common.py``) wire
together:

* :class:`ResilienceOptions`: the knobs every training driver exposes
  (``--save-every-n-steps``, ``--auto-resume``, ``--nan-policy``).
* :class:`PreemptionGuard`: SIGTERM/SIGINT → "save a step checkpoint at
  the next step boundary and return cleanly"; the handler only sets a
  flag.  A second signal restores the previous handlers and re-raises.
* :func:`retry_io`: exponential-backoff retry of transient checkpoint I/O
  errors (the ``checkpoint/retry`` telemetry counter).
* The NaN policies (:data:`NAN_POLICIES`): ``halt`` (diagnostic dump and
  :class:`NonFiniteLossError`), ``skip`` (the step keeps its parameters
  and momentum on the card when its loss or a gradient is not finite),
  ``rollback`` (restore the latest step checkpoint and keep consuming the
  loader).
* Fault injection from the environment (``MXR_FAULT_BAD_RECORD``,
  ``MXR_FAULT_NAN_STEP``), the same variables as the JAX package's.

Every recovery lands in the telemetry stream (``train/nan_detected``,
``train/nan_skipped``, ``train/nan_rollback``, ``loader/bad_record``,
``checkpoint/retry``, ``train/preempted``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from typing import Optional, Tuple

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.logger import logger

NAN_POLICIES = ("off", "halt", "skip", "rollback")

# (epoch, consumed) → one int key; an epoch cannot run more batches than
# this (checked at save).  The decoded pair is the resume position:
# "epoch E, C loader batches already dispatched".
STEP_KEY_STRIDE = 10 ** 7

# checkpoint I/O: retries after the first attempt, the first delay (doubled
# each retry), and the errors worth retrying (a programming error is not)
IO_RETRIES = 3
IO_BACKOFF_S = 0.5
TRANSIENT_IO = (OSError, TimeoutError)


class NonFiniteLossError(RuntimeError):
    """Raised by the ``halt`` NaN policy (and by ``rollback`` when there is
    no step checkpoint to roll back to)."""


@dataclasses.dataclass(frozen=True)
class ResilienceOptions:
    """Fault-tolerance knobs for ``fit``, all off by default (a plain
    ``fit`` runs the step without the sentinel, as before).

    ``save_every_n_steps``: mid-epoch step checkpoints at this cadence (0 =
    epoch checkpoints only).  ``auto_resume``: continue from the latest
    checkpoint, step or epoch, under the prefix, fast-forwarding the
    loader.  ``nan_policy``: what to do when the step's all-finite
    sentinel trips (:data:`NAN_POLICIES`).  Checkpoint I/O retries on a
    fixed budget (:data:`IO_RETRIES`, :data:`IO_BACKOFF_S`), where the JAX
    package carries it here as two fields no flag sets.
    """

    save_every_n_steps: int = 0
    auto_resume: bool = False
    nan_policy: str = "off"

    def __post_init__(self):
        if self.nan_policy not in NAN_POLICIES:
            raise ValueError(f"nan_policy must be one of {NAN_POLICIES}, "
                             f"got {self.nan_policy!r}")
        if self.save_every_n_steps < 0:
            raise ValueError("save_every_n_steps must be >= 0")

    @property
    def enabled(self) -> bool:
        return (self.save_every_n_steps > 0 or self.auto_resume
                or self.nan_policy != "off")

    @property
    def sentinel(self) -> bool:
        """The step must compute the on-device all-finite flag."""
        return self.nan_policy != "off"

    @property
    def skip_nonfinite(self) -> bool:
        """The step must keep its parameters and momentum where the flag
        is down (the ``skip`` policy), before the host reads it."""
        return self.nan_policy == "skip"

    @classmethod
    def from_args(cls, args) -> "ResilienceOptions":
        """From a training driver's parsed argv; missing attributes (a
        caller's own namespace) default to off."""
        return cls(
            save_every_n_steps=getattr(args, "save_every_n_steps", 0) or 0,
            auto_resume=getattr(args, "auto_resume", False),
            nan_policy=getattr(args, "nan_policy", "off") or "off",
        )


def add_resilience_args(parser) -> None:
    """``--save-every-n-steps``, ``--auto-resume`` and ``--nan-policy``, the
    JAX package's flags with its defaults and choices."""
    parser.add_argument("--save-every-n-steps", type=int, default=0,
                        dest="save_every_n_steps",
                        help="mid-epoch step checkpoints every N steps "
                             "(atomic writes under PREFIX-steps/, the "
                             "latest two kept; 0 = epoch checkpoints only)")
    parser.add_argument("--auto-resume", action="store_true",
                        dest="auto_resume",
                        help="resume from the latest checkpoint (step or "
                             "epoch) under --prefix, fast-forwarding the "
                             "loader to the exact batch; fresh start when "
                             "none exists, so safe to pass always")
    parser.add_argument("--nan-policy", default="off", dest="nan_policy",
                        choices=list(NAN_POLICIES),
                        help="non-finite loss/grad handling: halt = "
                             "diagnostic dump + error; skip = drop the bad "
                             "update on the card and keep going; rollback "
                             "= restore the last step checkpoint")


# -- step-checkpoint keys -------------------------------------------------

def encode_step_key(epoch: int, consumed: int) -> int:
    """(epoch, consumed loader batches) → one int key."""
    if not 0 <= consumed < STEP_KEY_STRIDE:
        raise ValueError(f"consumed {consumed} outside [0, {STEP_KEY_STRIDE})")
    return epoch * STEP_KEY_STRIDE + consumed


def decode_step_key(key: int) -> Tuple[int, int]:
    return key // STEP_KEY_STRIDE, key % STEP_KEY_STRIDE


# -- transient-I/O retry ----------------------------------------------------

def retry_io(fn, what: str):
    """``fn()``, retrying :data:`TRANSIENT_IO` errors up to
    :data:`IO_RETRIES` times with exponential backoff (``IO_BACKOFF_S ·
    2**attempt``).  Each retry bumps ``checkpoint/retry`` and logs the
    error; the last failure is raised."""
    for attempt in range(IO_RETRIES + 1):
        try:
            return fn()
        except TRANSIENT_IO as e:
            if attempt == IO_RETRIES:
                raise
            delay = IO_BACKOFF_S * (2 ** attempt)
            telemetry.get().counter("checkpoint/retry")
            logger.warning("%s failed (%s: %s) — retry %d/%d in %.1fs",
                           what, type(e).__name__, e, attempt + 1,
                           IO_RETRIES, delay)
            time.sleep(delay)


# -- preemption ---------------------------------------------------------------

class PreemptionGuard:
    """Context manager turning SIGTERM/SIGINT into a "save at the next step
    boundary" request.

    The handler only sets the flag and dumps the flight recorder; ``fit``
    saves on its own thread, at a step boundary, where the state is
    consistent.  A second signal restores the previous handlers and
    re-raises, so a hung save never makes the process unkillable.
    Handlers can be installed only on the main thread: elsewhere the guard
    stays inert (``requested`` stays False), with a warning.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._requested = False
        self._prev = {}

    @property
    def requested(self) -> bool:
        return self._requested

    def _handler(self, signum, frame):
        if self._requested:
            # the second signal: restore and deliver it again
            self._restore()
            signal.raise_signal(signum)
            return
        self._requested = True
        name = signal.Signals(signum).name
        # record now: if the clean path never reaches its boundary, this
        # dump is all there is (the sink's lock acquire is bounded)
        telemetry.get().dump_flight("preempt_signal", signal=name)
        logger.warning("received %s — saving a step checkpoint at the next "
                       "step boundary, then exiting cleanly (send again to "
                       "kill immediately)", name)

    def __enter__(self):
        if threading.current_thread() is not threading.main_thread():
            logger.warning("PreemptionGuard outside the main thread: signal "
                           "handlers not installed, preemption save disabled")
            return self
        for s in self.SIGNALS:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def _restore(self):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}

    def __exit__(self, *exc):
        self._restore()
        return False


def preemption_agreed(local: bool) -> bool:
    """The preemption flag all ranks act on.  The port trains on one card,
    so it is the local flag; the JAX package's cross-process OR comes with
    multi-card training (ROADMAP.md A.13)."""
    return local


# -- NaN diagnostics ----------------------------------------------------------

def dump_nan_diagnostics(out_dir: Optional[str], epoch: int, consumed: int,
                         step: int, scalars: dict) -> Optional[str]:
    """The ``halt`` policy's dump: the position of the detection and the
    last fetched metric scalars, as JSON in ``out_dir``."""
    if not out_dir:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"nan_dump_e{epoch}_b{consumed}.json")
    doc = {"epoch": int(epoch), "consumed": int(consumed), "step": int(step),
           "time": time.time(),
           "metrics": {k: float(v) for k, v in scalars.items()}}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return path


# -- fault injection from the environment -------------------------------------

ENV_BAD_RECORD = "MXR_FAULT_BAD_RECORD"
ENV_NAN_STEP = "MXR_FAULT_NAN_STEP"


def inject_roidb_faults(roidb: list) -> list:
    """Corrupt the roidb records named by ``MXR_FAULT_BAD_RECORD`` (comma
    separated indices, modulo the roidb's length) so that their load
    raises and the loader must substitute them.  A no-op when the variable
    is unset; ``tools/common.py:get_train_roidb`` calls it, so it reaches
    every training driver."""
    spec = os.environ.get(ENV_BAD_RECORD, "")
    if not spec:
        return roidb
    for tok in spec.split(","):
        i = int(tok) % max(len(roidb), 1)
        rec = dict(roidb[i])
        rec.pop("image_array", None)  # synthetic records carry pixels
        rec["image"] = "/nonexistent/mxr_injected_bad_record.jpg"
        roidb[i] = rec
        logger.warning("fault injection: corrupted roidb record %d "
                       "(%s=%s)", i, ENV_BAD_RECORD, spec)
    return roidb


def nan_injection_step() -> Optional[int]:
    """The consumed-batch index whose images ``fit`` turns to NaN
    (``MXR_FAULT_NAN_STEP``); None when unset."""
    spec = os.environ.get(ENV_NAN_STEP, "")
    return int(spec) if spec else None
