"""The train step (counterpart of ``mx_rcnn_tpu/train/train_step.py``:
``TrainState``, ``create_train_state``, ``make_train_step``), one device.

One step: the model's training forward (``FasterRCNN.forward``) → the
backward pass (autograd: cuDNN/cuBLAS for the convs and matmuls, as the
JAX package leaves them to XLA; frozen leaves have ``requires_grad=False``
and so no gradient work) → elementwise clip → SGD with decay and momentum
(``train/optim.py``) at the schedule's LR for this step.  The metric
scalars stay on the device; the trainer fetches them at its cadence.  Not
ported: the NaN sentinel and skip policies, the multi-step dispatch and
mesh plans.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.train.metric import metric_scalars
from mx_rcnn_tpu_torch.train.optim import clip_gradient, make_optimizer


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the state), the optimizer (momentum
    buffers), the LR schedule, the trainable mask over the JAX keys, and
    the number of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    mask: Dict[str, bool]
    step: int = 0


def create_train_state(cfg: Config, model: nn.Module,
                       steps_per_epoch: int) -> TrainState:
    opt, schedule, mask = make_optimizer(cfg, model, steps_per_epoch)
    return TrainState(model=model, optimizer=opt, schedule=schedule,
                      mask=mask)


def make_train_step(cfg: Config) -> Callable:
    """``train_step(state, batch, *, draws=None, generator=None) ->
    (state, metrics)``: ``batch`` holds the device tensors ``images``
    (prepped), ``im_info``, ``gt_boxes``, ``gt_classes``, ``gt_valid``;
    ``draws``/``generator`` feed the model's sampling.  Updates ``state``
    in place."""
    clip = cfg.TRAIN.CLIP_GRADIENT

    def train_step(state: TrainState, batch: dict, *,
                   draws: Optional[dict] = None,
                   generator: Optional[torch.Generator] = None):
        model, opt = state.model, state.optimizer
        lr = state.schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        total, aux = model(batch["images"], batch["im_info"],
                           batch["gt_boxes"], batch["gt_classes"],
                           batch["gt_valid"], draws=draws,
                           generator=generator)
        total.backward()
        clip_gradient(model.parameters(), clip)
        opt.step()
        state.step += 1
        metrics = metric_scalars(aux)
        metrics["total_loss"] = total.detach()
        return state, metrics

    return train_step
