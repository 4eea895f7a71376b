"""The training loop (counterpart of ``mx_rcnn_tpu/train/trainer.py:fit``,
its core only).

epochs × batches → :func:`batch_put` (to the card, with device prep) →
the train step → metric fetch at the Speedometer cadence into a
``MetricBank`` → the epoch line → an epoch checkpoint in the JAX flat
layout with the bbox de-normalisation folded in (``train/checkpoint.py``),
which ``eval/tester.py:Predictor`` loads as it is.  Not ported: resume and
auto-resume, step checkpoints, NaN policies, preemption, telemetry,
profiling, ``steps_per_dispatch`` and mesh plans.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.data.image import prep_images
from mx_rcnn_tpu_torch.eval.tester import resolve_device
from mx_rcnn_tpu_torch.logger import logger
from mx_rcnn_tpu_torch.train.callback import Speedometer
from mx_rcnn_tpu_torch.train.checkpoint import (denormalize_for_save,
                                                epoch_path, save_params_npz)
from mx_rcnn_tpu_torch.train.metric import MetricBank
from mx_rcnn_tpu_torch.train.train_step import (TrainState, create_train_state,
                                                make_train_step)
from mx_rcnn_tpu_torch.utils.convert_jax import (export_jax_params,
                                                 load_jax_params)


def batch_put(batch: Dict[str, np.ndarray], cfg: Config,
              device: torch.device) -> Dict[str, torch.Tensor]:
    """An ``AnchorLoader`` or ``ROIIter`` batch → device tensors, the staged raw pixels
    resampled, mirrored where ``flip``, normalised and regrouped on the
    device (the JAX package's ``DevicePrep.put``)."""
    t = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}
    net = cfg.network
    t["images"] = prep_images(t["images"], t.pop("raw_hw"), t.pop("prep_ratio"),
                              t["im_info"], pixel_means=net.PIXEL_MEANS,
                              pixel_stds=net.PIXEL_STDS, s2d=net.HOST_S2D,
                              flip=t.pop("flip"))
    return t


def fit(cfg: Config, model, params, train_loader, *, begin_epoch: int = 0,
        end_epoch: int = 10, prefix: Optional[str] = None,
        graph: str = "end2end", seed: int = 0, frequent: int = 20,
        device=None, fixed_prefixes: Optional[Sequence[str]] = None,
        batch_end_callback: Optional[Callable[[int, int, dict], None]] = None
        ) -> TrainState:
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
    With ``prefix``, epoch ``e`` ends with ``{prefix}-{e + 1:04d}.npz``.
    The sampling uniforms come from one ``torch.Generator`` seeded with
    ``seed`` on the device.
    """
    device = resolve_device(device)
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
    step_fn = make_train_step(cfg, graph)
    generator = torch.Generator(device=device).manual_seed(seed)
    speedo = Speedometer(train_loader.batch_size, frequent=frequent)
    bank = MetricBank()

    def fetch(epoch, cur, pending):
        fetched = {k: float(v) for k, v in pending.items()}
        bank.update(fetched)
        if batch_end_callback is not None:
            batch_end_callback(epoch, cur, fetched)

    for epoch in range(begin_epoch, end_epoch):
        bank.reset()
        speedo.reset()
        ep_t0 = time.perf_counter()
        pending, consumed, last_fetch = None, 0, 0
        for batch in train_loader:
            state, pending = step_fn(state, batch_put(batch, cfg, device),
                                     generator=generator)
            cur = consumed + 1
            if cur - last_fetch >= frequent:
                fetch(epoch, cur, pending)
                pending, last_fetch = None, cur
            speedo(epoch, consumed, bank.format())
            consumed = cur
        if pending is not None:
            fetch(epoch, consumed, pending)
        logger.info("Epoch[%d] Train-%s\tWall=%.1fs", epoch,
                    bank.format().replace("\t", " Train-"),
                    time.perf_counter() - ep_t0)
        if prefix:
            path = epoch_path(prefix, epoch + 1)
            save_params_npz(path, denormalize_for_save(
                export_jax_params(model), cfg))
            logger.info("saved %s", path)
    return state
