"""The training loop (counterpart of ``mx_rcnn_tpu/train/trainer.py:fit``).

epochs × batches → :func:`batch_put` (to the card, with device prep; the
loader's ``put`` hook, run on its prefetch thread) → the train step →
metric fetch at the Speedometer cadence into a ``MetricBank`` → the epoch
line → an epoch checkpoint (``train/checkpoint.py:CheckpointManager``:
the JAX flat layout with the bbox de-normalisation folded in, which
``eval/tester.py:Predictor`` loads as it is, and the training state
beside it).

Fault tolerance, as the JAX ``fit`` has it (``train/resilience.py``):
``resume`` (the reference's ``--resume``) and ``auto_resume``, step
checkpoints, the NaN sentinel's ``halt``/``skip``/``rollback`` policies,
``MXR_FAULT_NAN_STEP``, and a SIGTERM/SIGINT that saves a step checkpoint
and returns.  Not ported: telemetry sinks of its own, profiling,
``steps_per_dispatch`` and mesh plans.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.data.image import prep_images
from mx_rcnn_tpu_torch.eval.tester import resolve_device
from mx_rcnn_tpu_torch.logger import logger
from mx_rcnn_tpu_torch.train.callback import Speedometer
from mx_rcnn_tpu_torch.train.checkpoint import CheckpointManager
from mx_rcnn_tpu_torch.train.metric import MetricBank
from mx_rcnn_tpu_torch.train.optim import (export_momentum, import_momentum,
                                           make_lr_schedule)
from mx_rcnn_tpu_torch.train.resilience import (NonFiniteLossError,
                                                PreemptionGuard,
                                                ResilienceOptions,
                                                dump_nan_diagnostics,
                                                nan_injection_step,
                                                preemption_agreed)
from mx_rcnn_tpu_torch.train.train_step import (TrainState, create_train_state,
                                                make_train_step)
from mx_rcnn_tpu_torch.utils.convert_jax import (export_jax_params,
                                                 load_jax_params)


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: bound for the card, through pinned
    memory with a non-blocking copy on the thread's current stream (a copy
    from pageable memory would wait for the step queued before it)."""
    t = torch.as_tensor(np.asarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def batch_put(batch: Dict[str, np.ndarray], cfg: Config,
              device: torch.device) -> Dict[str, torch.Tensor]:
    """An ``AnchorLoader`` or ``ROIIter`` batch → device tensors, the staged raw pixels
    resampled, mirrored where ``flip``, normalised and regrouped on the
    device (the JAX package's ``DevicePrep.put``)."""
    t = {k: _to_device(v, device) for k, v in batch.items()}
    net = cfg.network
    t["images"] = prep_images(t["images"], t.pop("raw_hw"), t.pop("prep_ratio"),
                              t["im_info"], pixel_means=net.PIXEL_MEANS,
                              pixel_stds=net.PIXEL_STDS, s2d=net.HOST_S2D,
                              flip=t.pop("flip"))
    return t


def _resolve_start(ckpt, res: ResilienceOptions, resume: bool,
                   begin_epoch: int, prefix):
    """``(begin_epoch, resume, step_resume, origin)`` after
    ``auto_resume`` has looked for the furthest checkpoint (JAX ``fit``
    :224-254); the schedule is built from the resolved ``begin_epoch``.
    ``origin`` is the epoch the run began in: the caller's ``begin_epoch``
    (which, under ``auto_resume``, is the interrupted run's), or 0 for an
    explicit ``resume``, the reference's ``--resume --begin_epoch``."""
    step_resume, origin, resolved = None, begin_epoch, False
    if res.auto_resume:
        if ckpt is None:
            raise ValueError("auto_resume requires a checkpoint prefix")
        point = ckpt.latest_resume_point()
        if point is None:
            logger.info("auto-resume: no checkpoint under %s — fresh start",
                        prefix)
        else:
            kind, r_ep, r_cons = point
            begin_epoch, resolved = r_ep, True
            if kind == "epoch":
                resume = True
                logger.info("auto-resume: epoch checkpoint %d under %s",
                            r_ep, prefix)
            else:
                step_resume = (r_ep, r_cons)
                logger.info("auto-resume: step checkpoint (epoch %d, "
                            "batch %d) under %s", r_ep, r_cons, prefix)
    if resume and ckpt is None:
        raise ValueError("resume=True requires a checkpoint prefix")
    if resume and not resolved:
        origin = 0
    return begin_epoch, resume, step_resume, origin


def fit(cfg: Config, model, params, train_loader, *, begin_epoch: int = 0,
        end_epoch: int = 10, prefix: Optional[str] = None,
        graph: str = "end2end", seed: int = 0, frequent: int = 20,
        device=None, fixed_prefixes: Optional[Sequence[str]] = None,
        batch_end_callback: Optional[Callable[[int, int, dict], None]] = None,
        resume: bool = False,
        resilience: Optional[ResilienceOptions] = None) -> TrainState:
    """Train ``model`` from ``params`` (flat JAX layout, the training
    parametrisation) over epochs ``begin_epoch`` … ``end_epoch − 1`` of
    ``train_loader`` on ``device`` (the card unless given ``"cpu"``),
    through the ``graph`` (``"end2end"``, ``"rpn"`` or ``"rcnn"``,
    ``train/train_step.py``) with the leaves of ``fixed_prefixes``
    (default ``cfg.network.FIXED_PARAMS``) frozen.  The LR schedule counts
    its steps from ``begin_epoch``.

    Metrics are fetched from the device every ``frequent`` steps and at
    the end of an epoch (a fetch synchronises with the card);
    ``batch_end_callback(epoch, step, metrics)`` sees each fetched dict.
    With ``prefix``, epoch ``e`` ends with ``{prefix}-{e + 1:04d}.npz`` and
    its training state (``train/checkpoint.py``).  The sampling uniforms
    come from one ``torch.Generator`` seeded with ``seed`` on the device.

    ``fit`` owns the loader's ``put`` hook, which every loader has (the
    ``AnchorLoader`` contract): it is set to :func:`batch_put` for this
    ``cfg`` and ``device``, so that each batch is copied and prepped on
    the prefetch thread while the previous step runs (on this thread at
    ``tpu.PREFETCH`` 0).

    ``resume`` (the reference's ``--resume``) restores the parameters, the
    momentum, the global step and the generator from epoch
    ``begin_epoch``'s checkpoint under ``prefix``; the schedule count
    restarts at 0, since the schedule is rebuilt from ``begin_epoch``, with
    the LR drops of epochs 1 … ``begin_epoch`` in its base rate (the
    reference's ``lr_epoch_diff``; under ``auto_resume``, those after the
    caller's ``begin_epoch``, where the interrupted run began).

    ``resilience`` (``ResilienceOptions``, all off by default):

    * ``save_every_n_steps``: step checkpoints at that batch cadence; under
      an active sentinel a save that falls due (or a preemption's) forces
      a metric fetch first, so only verified-finite state is written, and
      no position is saved twice.
    * ``auto_resume``: continue from the furthest checkpoint under
      ``prefix``, step or epoch.  The loader is advanced past the
      completed epochs (``advance_epochs``) and, mid-epoch, told to skip
      the consumed batches (``skip_next``: a loader without it raises);
      the generator's state is restored and the schedule count restarts
      at ``consumed``, so the rest of the run is the uninterrupted run's,
      batch for batch.
    * ``nan_policy``: the sentinel is read at every fetch.  ``halt`` dumps
      the diagnostics and raises ``NonFiniteLossError``; ``skip`` counts
      (the step kept its state on the card); ``rollback`` restores the
      latest step checkpoint and keeps consuming the loader (without one
      it raises), the schedule count set back to the checkpoint's
      position.
    * With any knob on, SIGTERM/SIGINT ask for a step checkpoint at the
      next step boundary and a clean return; the epoch's iterator is
      closed, so its prefetch thread and worker tickets end.
    """
    device = resolve_device(device)
    if not hasattr(train_loader, "put"):
        raise TypeError(f"fit: {type(train_loader).__name__} has no put "
                        f"hook (the AnchorLoader contract)")
    res = resilience if resilience is not None else ResilienceOptions()
    ckpt = CheckpointManager(prefix) if prefix else None
    tel = telemetry.get()
    begin0 = begin_epoch
    begin_epoch, resume, step_resume, origin = _resolve_start(
        ckpt, res, resume, begin_epoch, prefix)
    if step_resume is not None and not hasattr(train_loader, "skip_next"):
        raise ValueError(
            f"auto_resume hit a mid-epoch step checkpoint but "
            f"{type(train_loader).__name__} has no skip_next() — it cannot "
            f"be fast-forwarded to batch {step_resume[1]}")

    momentum, r_step, r_count, r_gen = None, 0, 0, None
    if resume:
        params, momentum, r_step, r_gen = ckpt.load_epoch(
            begin_epoch, cfg, for_training=True)
        logger.info("resumed from %s epoch %d (step %d)", prefix, begin_epoch,
                    r_step)
    elif step_resume is not None:
        payload = ckpt.load_step_checkpoint(*step_resume)
        params, momentum = payload["params"], payload["momentum"]
        r_step, r_count, r_gen = (payload["step"], step_resume[1],
                                  payload["generator"])
        logger.info("resumed mid-epoch from %s (epoch %d, batch %d, step %d)",
                    prefix, step_resume[0], step_resume[1], r_step)

    if device.type == "cuda" and cfg.tpu.COMPUTE_DTYPE == "float32":
        # cuDNN would otherwise run float32 convolutions in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    load_jax_params(model, params)
    model.to(device)
    steps_per_epoch = train_loader.steps_per_epoch
    state = create_train_state(cfg, model, steps_per_epoch,
                               begin_epoch=begin_epoch,
                               fixed_prefixes=fixed_prefixes)
    if origin != begin_epoch:
        # a resumed run keeps the LR drops it passed (ROADMAP.md C.5)
        state.schedule = make_lr_schedule(cfg, steps_per_epoch, begin_epoch,
                                          origin)
    if momentum is not None:
        import_momentum(model, state.optimizer, momentum)
    state.step, state.schedule_count = r_step, r_count
    step_fn = make_train_step(cfg, graph, sentinel=res.sentinel,
                              skip_nonfinite=res.skip_nonfinite)
    generator = torch.Generator(device=device).manual_seed(seed)
    if r_gen is not None:
        # the resumed per-step sampling stream continues exactly
        generator.set_state(torch.from_numpy(np.array(r_gen, np.uint8)))
    speedo = Speedometer(train_loader.batch_size, frequent=frequent)
    bank = MetricBank()
    train_loader.put = lambda b: batch_put(b, cfg, device)

    # the loader's fast-forward: the completed epochs' draws, then the
    # resumed epoch's consumed batches (its plan drawn whole, then cut)
    if res.auto_resume and begin_epoch > begin0:
        if hasattr(train_loader, "advance_epochs"):
            train_loader.advance_epochs(begin_epoch - begin0)
        else:
            logger.warning("auto-resume: %s has no advance_epochs(); the "
                           "resumed epochs replay the loader's first-epoch "
                           "draws", type(train_loader).__name__)
    if step_resume is not None:
        train_loader.skip_next(step_resume[1])

    nan_at = nan_injection_step()
    dump_dir = ((tel.out_dir if tel.enabled else None)
                or (os.path.dirname(ckpt.prefix) if ckpt else None))
    guard = PreemptionGuard()
    preempted = False
    last_saved = None  # (epoch, consumed) of the last step checkpoint

    def fetch(epoch, cur, pending):
        """The metrics (the sentinel's flag apart) and the flag, or None."""
        fetched = {k: float(v) for k, v in pending.items()}
        if batch_end_callback is not None:
            batch_end_callback(epoch, cur, dict(fetched))
        finite = fetched.pop("all_finite", None)
        bank.update(fetched)
        return fetched, finite

    def save_step_ckpt(ep, cur):
        """A step checkpoint of the current state, once a position."""
        nonlocal last_saved
        if last_saved == (ep, cur):
            return
        ckpt.save_step(ep, cur, export_jax_params(model),
                       momentum=export_momentum(model, state.optimizer),
                       step=state.step, schedule_count=state.schedule_count,
                       generator_state=generator.get_state().numpy())
        last_saved = (ep, cur)

    def handle_nonfinite(ep, cur, fetched) -> bool:
        """The sentinel tripped at a fetch: apply ``nan_policy``.  True
        when the state was rolled back (no step save at this boundary)."""
        tel.counter("train/nan_detected")
        tel.meta("nan_detected", epoch=int(ep), consumed=int(cur),
                 policy=res.nan_policy)
        tel.dump_flight("nan_detected", epoch=int(ep), consumed=int(cur),
                        policy=res.nan_policy)
        logger.warning("non-finite loss/gradients detected (epoch %d, "
                       "batch %d, policy=%s)", ep, cur, res.nan_policy)
        if res.nan_policy == "skip":
            tel.counter("train/nan_skipped")
            return False
        if res.nan_policy == "halt":
            path = dump_nan_diagnostics(dump_dir, ep, cur, state.step, fetched)
            raise NonFiniteLossError(
                f"non-finite loss/gradients at epoch {ep}, batch {cur} "
                f"(policy=halt)"
                + (f"; diagnostics dumped to {path}" if path else ""))
        point = ckpt.latest_step_checkpoint() if ckpt is not None else None
        if point is None:
            raise NonFiniteLossError(
                f"non-finite loss/gradients at epoch {ep}, batch {cur} "
                f"(policy=rollback) with no step checkpoint to roll back "
                f"to — set save_every_n_steps (prefix: {prefix or 'none'})")
        payload = ckpt.load_step_checkpoint(*point)
        load_jax_params(model, payload["params"])
        import_momentum(model, state.optimizer, payload["momentum"])
        state.step = payload["step"]
        # the count the schedule had at that position from this basis
        state.schedule_count = max(
            0, (point[0] - begin_epoch) * steps_per_epoch + point[1])
        tel.counter("train/nan_rollback")
        logger.warning("rolled back to step checkpoint (epoch %d, batch "
                       "%d)", *point)
        return True

    with (guard if res.enabled else contextlib.nullcontext()):
        for epoch in range(begin_epoch, end_epoch):
            bank.reset()
            speedo.reset()
            ep_t0 = time.perf_counter()
            start = (step_resume[1]
                     if step_resume and epoch == begin_epoch else 0)
            pending, consumed = None, start
            last_fetch = last_step_save = start
            it = iter(train_loader)
            try:
                for batch in it:  # on the device: the put hook ran
                    if nan_at is not None and consumed == nan_at:
                        batch = dict(batch)
                        batch["images"] = batch["images"] * float("nan")
                        logger.warning("fault injection: NaN images at batch "
                                       "%d (MXR_FAULT_NAN_STEP)", consumed)
                    state, pending = step_fn(state, batch,
                                             generator=generator)
                    cur = consumed + 1
                    stop = preemption_agreed(guard.requested)
                    save_due = (res.save_every_n_steps > 0
                                and ckpt is not None
                                and cur - last_step_save
                                >= res.save_every_n_steps)
                    if (cur - last_fetch >= frequent
                            or (res.sentinel and (save_due or stop))):
                        fetched, finite = fetch(epoch, cur, pending)
                        pending, last_fetch = None, cur
                        if finite is not None and finite < 1.0 and \
                                handle_nonfinite(epoch, cur, fetched):
                            save_due = False  # restored from a checkpoint
                            last_step_save = cur
                        # a signal during the fetch: this state is verified
                        stop = preemption_agreed(guard.requested)
                    if save_due or (stop and ckpt is not None):
                        save_step_ckpt(epoch, cur)
                        last_step_save = cur
                    if stop:
                        tel.counter("train/preempted")
                        tel.dump_flight("preempted", epoch=epoch,
                                        consumed=int(cur))
                        preempted = True
                    speedo(epoch, consumed, bank.format())
                    consumed = cur
                    if preempted:
                        break
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
            if pending is not None:
                fetched, finite = fetch(epoch, consumed, pending)
                if finite is not None and finite < 1.0:
                    handle_nonfinite(epoch, consumed, fetched)
            logger.info("Epoch[%d] Train-%s\tWall=%.1fs", epoch,
                        bank.format().replace("\t", " Train-"),
                        time.perf_counter() - ep_t0)
            if preempted:
                logger.info("preemption requested — exiting cleanly after "
                            "step checkpoint (epoch %d, batch %d); rerun "
                            "with auto_resume to continue", epoch, consumed)
                break
            if ckpt is not None:
                with tel.span("train/checkpoint_save"):
                    ckpt.save_epoch(
                        epoch + 1, export_jax_params(model), cfg,
                        momentum=export_momentum(model, state.optimizer),
                        step=state.step,
                        generator_state=generator.get_state().numpy())
    return state
