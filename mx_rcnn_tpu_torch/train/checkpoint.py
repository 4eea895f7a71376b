"""Checkpoints (counterpart of ``mx_rcnn_tpu/train/checkpoint.py``:
``_bbox_fold``, ``denormalize_for_save``, ``normalize_for_train``,
``CheckpointManager``, ``save_params_npz``, ``load_params_npz``).

Params travel in the JAX package's flat layout (``utils/convert_jax.py:
export_jax_params``), so a checkpoint of either package loads into the
other.  The de-normalize contract is the reference's ``do_checkpoint``:
training regresses R-CNN targets normalised by (BBOX_MEANS, BBOX_STDS),
and the saved ``bbox_pred`` weights fold that normalisation in, so
inference needs none; :func:`normalize_for_train` inverts it.

The layout of :class:`CheckpointManager` under a ``prefix`` (numpy files
only, so a machine without orbax reads every one of them):

* ``{prefix}-{epoch:04d}.npz``: the epoch checkpoint, the de-normalized
  flat parameters, written by :func:`save_params_npz` (the interchange
  format that ``test``, ``serve``, ``reeval``, ``combine_model`` and the
  JAX package's ``load_params_npz`` read).
* ``{prefix}-{epoch:04d}.state.npz``: beside it, the training state:
  ``momentum/<key>`` (the SGD momentum buffer of each trainable leaf, in
  the leaf's JAX layout and under its JAX key; frozen leaves have none),
  ``raw/<key>`` (the training values of the leaves the fold changes, the
  ``bbox_pred`` kernels and biases, so an epoch resume continues
  bitwise), ``step`` (the global step) and ``generator`` (the state of
  the trainer's sampling ``torch.Generator``, ``uint8``).
* ``{prefix}-steps/step-{key:012d}.npz``: step checkpoints, ``key =
  epoch · 10**7 + consumed`` (``resilience.encode_step_key``), the latest
  two kept.  Each holds ``params/<key>`` (the raw training
  parametrisation, no fold: a resume artifact, never an inference
  input), ``momentum/<key>``, ``step``, ``epoch``, ``consumed``,
  ``schedule_count`` and ``generator``.

Every file is written under a temporary name in its directory, flushed
to disk (``fsync``) and renamed over its target (``os.replace``), so a
save killed midway leaves the previous checkpoint readable; the manager's
saves retry transient I/O errors (``resilience.retry_io``).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.logger import logger
from mx_rcnn_tpu_torch.train.resilience import (decode_step_key,
                                                encode_step_key, retry_io)

Params = Dict[str, np.ndarray]

STEP_KEEP = 2  # the rolling window of step checkpoints


def _folded(key: str) -> bool:
    """The leaves :func:`_bbox_fold` changes."""
    names = key.split("/")
    return "bbox_pred" in names and names[-1] in ("kernel", "bias")


def _bbox_fold(params: Params, means: Sequence[float], stds: Sequence[float],
               num_classes: int, invert: bool) -> Params:
    """Fold (or unfold) target normalisation into every ``bbox_pred``
    leaf: kernel (D, 4K) · stds, bias · stds + means; ``invert`` recovers
    the trained parametrisation.  Other leaves are passed through."""
    stds_t = np.tile(np.asarray(stds, np.float32), num_classes)
    means_t = np.tile(np.asarray(means, np.float32), num_classes)
    out = {}
    for key, leaf in params.items():
        names = key.split("/")
        if "bbox_pred" in names and names[-1] == "kernel":
            leaf = leaf / stds_t[None, :] if invert else leaf * stds_t[None, :]
        elif "bbox_pred" in names and names[-1] == "bias":
            leaf = (leaf - means_t) / stds_t if invert else \
                leaf * stds_t + means_t
        out[key] = leaf
    return out


def denormalize_for_save(params: Params, cfg) -> Params:
    return _bbox_fold(params, cfg.TRAIN.BBOX_MEANS, cfg.TRAIN.BBOX_STDS,
                      cfg.NUM_CLASSES, invert=False)


def normalize_for_train(params: Params, cfg) -> Params:
    return _bbox_fold(params, cfg.TRAIN.BBOX_MEANS, cfg.TRAIN.BBOX_STDS,
                      cfg.NUM_CLASSES, invert=True)


def epoch_path(prefix: str, epoch: int) -> str:
    return f"{prefix}-{epoch:04d}.npz"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez`` of ``arrays`` to ``path`` through a temporary file in the
    same directory, ``fsync``-ed and renamed over ``path``; its directory is
    made when missing."""
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    _fsync_dir(folder)


def save_params_npz(path: str, params: Params) -> None:
    """The flat ``.npz`` (the JAX package's deployment artifact), written
    atomically (:func:`atomic_savez`)."""
    atomic_savez(path, params)


def load_params_npz(path: str) -> Params:
    """Inverse of :func:`save_params_npz` → the flat dict."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _group(flat: dict, name: str) -> Params:
    """``{key: array}`` of the entries ``{name}/<key>``."""
    head = name + "/"
    return {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}


class CheckpointManager:
    """The epoch and step checkpoints under ``prefix`` (the module
    docstring gives the layout), with the JAX package's methods and
    semantics: epoch saves and loads, a rolling window of
    :data:`STEP_KEEP` step checkpoints, and the resume point.  ``prefix``
    is a file prefix, as ``--prefix`` is everywhere in the port
    (``model/e2e`` → ``model/e2e-0001.npz``)."""

    STEP_SUFFIX = "-steps"
    STATE_SUFFIX = ".state.npz"

    def __init__(self, prefix: str):
        self.prefix = os.path.abspath(prefix)
        self.step_dir = self.prefix + self.STEP_SUFFIX
        self._epoch_re = re.compile(
            re.escape(os.path.basename(self.prefix)) + r"-(\d{4,})\.npz$")

    # -- epoch checkpoints ---------------------------------------------------

    def state_path(self, epoch: int) -> str:
        return f"{self.prefix}-{epoch:04d}{self.STATE_SUFFIX}"

    def save_epoch(self, epoch: int, params: Params, cfg,
                   momentum: Optional[Params] = None, step: int = 0,
                   generator_state: Optional[np.ndarray] = None) -> None:
        """``do_checkpoint``: the de-normalized ``params`` (the training
        parametrisation given) as ``{prefix}-{epoch:04d}.npz``, then the
        training state beside it."""
        path = epoch_path(self.prefix, epoch)
        state = {"step": np.asarray(int(step), np.int64)}
        state.update({f"raw/{k}": v for k, v in params.items() if _folded(k)})
        state.update({f"momentum/{k}": v
                      for k, v in (momentum or {}).items()})
        if generator_state is not None:
            state["generator"] = np.asarray(generator_state, np.uint8)

        def do_save():
            save_params_npz(path, denormalize_for_save(params, cfg))
            atomic_savez(self.state_path(epoch), state)

        retry_io(do_save, what=f"epoch checkpoint {epoch}")
        logger.info("saved %s", path)

    def available_epochs(self) -> list:
        folder = os.path.dirname(self.prefix)
        if not os.path.isdir(folder):
            return []
        found = (self._epoch_re.match(n) for n in os.listdir(folder))
        return sorted(int(m.group(1)) for m in found if m)

    def load_epoch(self, epoch: int, cfg, for_training: bool = True
                   ) -> Tuple[Params, Optional[Params], int,
                              Optional[np.ndarray]]:
        """``(params, momentum or None, step, generator state or None)``.
        ``for_training`` returns the training parametrisation: the
        de-normalized file unfolded, with the state file's raw ``bbox_pred``
        leaves where they fold to the file's bitwise.  A file without its
        state (the JAX package's ``save_params_npz``, a combined model)
        gives no momentum, step 0 and no generator state."""
        have = self.available_epochs()
        if epoch not in have:
            raise FileNotFoundError(
                f"no checkpoint for epoch {epoch} under {self.prefix}; "
                f"epochs present: {have or 'none'} — pass one of those (or "
                f"retrain; the latest is selected by fit(auto_resume))")
        saved = load_params_npz(epoch_path(self.prefix, epoch))
        sp = self.state_path(epoch)
        state = load_params_npz(sp) if os.path.exists(sp) else {}
        params = saved
        if for_training:
            params = normalize_for_train(saved, cfg)
            raw = _group(state, "raw")
            refolded = denormalize_for_save(raw, cfg)
            if all(np.array_equal(refolded[k], saved.get(k)) for k in raw):
                params.update(raw)
            else:
                logger.warning("%s does not match %s's bbox_pred leaves; "
                               "unfolding the epoch file's", sp,
                               epoch_path(self.prefix, epoch))
        momentum = _group(state, "momentum") if state else None
        return (params, momentum, int(state.get("step", 0)),
                state.get("generator"))

    def latest_epoch(self) -> Optional[int]:
        have = self.available_epochs()
        return have[-1] if have else None

    # -- step checkpoints ----------------------------------------------------

    def _step_path(self, key: int) -> str:
        return os.path.join(self.step_dir, f"step-{key:012d}.npz")

    def _step_keys(self) -> list:
        if not os.path.isdir(self.step_dir):
            return []
        found = (re.match(r"step-(\d+)\.npz$", n)
                 for n in os.listdir(self.step_dir))
        return sorted(int(m.group(1)) for m in found if m)

    def save_step(self, epoch: int, consumed: int, params: Params,
                  momentum: Optional[Params] = None, step: int = 0,
                  schedule_count: int = 0,
                  generator_state: Optional[np.ndarray] = None) -> None:
        """Step checkpoint at ``consumed`` loader batches into ``epoch``:
        the raw training parametrisation (no fold), the momentum, the
        counters and the sampling generator's state, so that
        ``fit(auto_resume)`` continues the run exactly.  The oldest beyond
        the window are removed after the write."""
        key = encode_step_key(epoch, consumed)
        payload = {f"params/{k}": v for k, v in params.items()}
        payload.update({f"momentum/{k}": v
                        for k, v in (momentum or {}).items()})
        payload.update({
            "step": np.asarray(int(step), np.int64),
            "epoch": np.asarray(int(epoch), np.int64),
            "consumed": np.asarray(int(consumed), np.int64),
            "schedule_count": np.asarray(int(schedule_count), np.int64)})
        if generator_state is not None:
            payload["generator"] = np.asarray(generator_state, np.uint8)
        with telemetry.get().span("checkpoint/step_save"):
            retry_io(
                lambda: atomic_savez(self._step_path(key), payload),
                what=f"step checkpoint (epoch {epoch}, batch {consumed})")
        for old in self._step_keys()[:-STEP_KEEP]:
            os.remove(self._step_path(old))
        logger.info("saved step checkpoint epoch %d batch %d -> %s", epoch,
                    consumed, self.step_dir)

    def latest_step_checkpoint(self) -> Optional[Tuple[int, int]]:
        """The latest step checkpoint as (epoch, consumed), or None."""
        keys = self._step_keys()
        return decode_step_key(keys[-1]) if keys else None

    def load_step_checkpoint(self, epoch: int, consumed: int) -> dict:
        """A step checkpoint's payload: ``params`` (raw: do NOT
        ``normalize_for_train``), ``momentum``, ``step``, ``epoch``,
        ``consumed``, ``schedule_count`` and ``generator`` (or None)."""
        key = encode_step_key(epoch, consumed)
        keys = self._step_keys()
        if key not in keys:
            have = [decode_step_key(k) for k in keys]
            raise FileNotFoundError(
                f"no step checkpoint (epoch {epoch}, batch {consumed}) under "
                f"{self.step_dir}; present: {have or 'none'}")
        flat = load_params_npz(self._step_path(key))
        out = {"params": _group(flat, "params"),
               "momentum": _group(flat, "momentum"),
               "generator": flat.get("generator")}
        for k in ("step", "epoch", "consumed", "schedule_count"):
            out[k] = int(flat[k])
        return out

    def latest_resume_point(self) -> Optional[Tuple[str, int, int]]:
        """The furthest position any checkpoint reaches: ``("epoch", E,
        0)`` (epoch checkpoint E = the start of epoch E) or ``("step", E,
        C)`` (C batches into epoch E); None when there is none.  A step
        checkpoint from before the latest epoch checkpoint loses, so a
        finished epoch wins over its own mid-epoch saves."""
        cands = []
        e = self.latest_epoch()
        if e is not None:
            cands.append((e, 0, "epoch"))
        s = self.latest_step_checkpoint()
        if s is not None:
            cands.append((s[0], s[1], "step"))
        if not cands:
            return None
        ep, cons, kind = max(cands)
        return kind, ep, cons
