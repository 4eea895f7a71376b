"""The train step (counterpart of ``mx_rcnn_tpu/train/train_step.py``:
``TrainState``, ``create_train_state``, ``make_train_step``), one device.

One step: the graph's training forward (``FasterRCNN.forward``,
``rpn_train`` or ``rcnn_train``) → the backward pass (autograd:
cuDNN/cuBLAS for the convs and matmuls, as the JAX package leaves them to
XLA; frozen leaves have ``requires_grad=False`` and so no gradient work)
→ a zero gradient for every trainable leaf the graph did not reach → the
elementwise clip → SGD with decay and momentum (``train/optim.py``) at the
schedule's LR for this step.  The zero gradient is optax's behaviour: its
chain decays every trainable leaf and moves it by its momentum on every
step, so an ``rpn`` step decays the R-CNN head and an ``rcnn`` step the
RPN head, where ``torch.optim.SGD`` would skip a leaf without a gradient.
The metric scalars stay on the device; the trainer fetches them at its
cadence.  Not
ported: the NaN sentinel and skip policies, the multi-step dispatch and
mesh plans.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

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


def create_train_state(cfg: Config, model: nn.Module, steps_per_epoch: int,
                       begin_epoch: int = 0,
                       fixed_prefixes: Optional[Sequence[str]] = None
                       ) -> TrainState:
    """The optimizer over ``model``'s leaves that ``fixed_prefixes``
    (default ``cfg.network.FIXED_PARAMS``) leaves trainable, its schedule
    counted from ``begin_epoch``."""
    opt, schedule, mask = make_optimizer(cfg, model, steps_per_epoch,
                                         begin_epoch=begin_epoch,
                                         fixed_prefixes=fixed_prefixes)
    return TrainState(model=model, optimizer=opt, schedule=schedule,
                      mask=mask)


def _loss(model: nn.Module, batch: dict, graph: str, draws, generator):
    """The training graph's ``(total, aux)`` on the batch's keys, as the
    JAX package's ``_loss_fn`` reads them."""
    kw = dict(draws=draws, generator=generator)
    if graph == "end2end":
        return model(batch["images"], batch["im_info"], batch["gt_boxes"],
                     batch["gt_classes"], batch["gt_valid"], **kw)
    if graph == "rpn":
        return model.rpn_train(batch["images"], batch["im_info"],
                               batch["gt_boxes"], batch["gt_valid"], **kw)
    if graph == "rcnn":
        return model.rcnn_train(batch["images"], batch["im_info"],
                                batch["rois"], batch["roi_valid"],
                                batch["gt_boxes"], batch["gt_classes"],
                                batch["gt_valid"], **kw)
    raise ValueError(f"unknown graph {graph!r}")


def make_train_step(cfg: Config, graph: str = "end2end") -> Callable:
    """``train_step(state, batch, *, draws=None, generator=None) ->
    (state, metrics)`` of the ``graph`` (``"end2end"``, ``"rpn"`` or
    ``"rcnn"``): ``batch`` holds the device tensors ``images`` (prepped),
    ``im_info``, ``gt_boxes``, ``gt_classes``, ``gt_valid``, and for
    ``"rcnn"`` ``rois``/``roi_valid``; ``draws``/``generator`` feed the
    model's sampling.  Updates ``state`` in place."""
    if graph not in ("end2end", "rpn", "rcnn"):
        raise ValueError(f"unknown graph {graph!r}")
    clip = cfg.TRAIN.CLIP_GRADIENT

    def train_step(state: TrainState, batch: dict, *,
                   draws: Optional[dict] = None,
                   generator: Optional[torch.Generator] = None):
        model, opt = state.model, state.optimizer
        lr = state.schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        total, aux = _loss(model, batch, graph, draws, generator)
        total.backward()
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        clip_gradient(model.parameters(), clip)
        opt.step()
        state.step += 1
        metrics = metric_scalars(aux)
        metrics["total_loss"] = total.detach()
        return state, metrics

    return train_step
