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
cadence.

The NaN sentinel (``sentinel``, the JAX package's ``_all_finite``): one
0-dim flag on the card, the loss and every gradient element finite after
the zero-fill, reported as the metric ``all_finite`` and read only when
the trainer fetches.  The ``skip`` policy (``skip_nonfinite``) snapshots
the trainable leaves and their momentum buffers before the update and
puts them back with ``torch.where`` on that flag, so a non-finite step
leaves both bitwise as they were, with no host synchronisation; only the
step and schedule counters advance (the JAX package keeps its optax
schedule count with the rest of the optimizer state, which its own step
resume then resets to the batch position).  Not ported: the multi-step
dispatch and mesh plans.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.train.metric import metric_scalars
from mx_rcnn_tpu_torch.train.optim import clip_gradient, make_optimizer


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the state), the optimizer (momentum
    buffers), the LR schedule, the trainable mask over the JAX keys, the
    global number of steps taken, and the schedule's count: the steps
    taken since the schedule's basis ``begin_epoch``, kept apart from
    ``step`` as the JAX package keeps its optax count, since a resume
    rebuilds the schedule from the epoch it resumes in."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    mask: Dict[str, bool]
    step: int = 0
    schedule_count: int = 0


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


def _all_finite(total: torch.Tensor, grads: List[torch.Tensor]
                ) -> torch.Tensor:
    """0-dim bool on the device: ``total`` and every element of ``grads``
    finite.  One max-abs reduction a leaf (``_foreach_norm`` at ord ∞,
    which propagates NaN and cannot overflow), then one ``isfinite`` over
    the leaves' maxima and the loss."""
    norms = torch._foreach_norm(grads, float("inf"))
    return torch.isfinite(torch.stack([*norms, total.detach().float()])
                          ).all()


def _skip_guard(optimizer: torch.optim.Optimizer,
                params: List[torch.Tensor], snapshot: List[torch.Tensor]
                ) -> List[torch.Tensor]:
    """The leaves and momentum buffers the ``skip`` policy restores,
    copied into ``snapshot`` (allocated at the first call).  A leaf without
    a buffer yet gets a zero one, optax's initial trace, so that it too can
    be put back."""
    bufs = []
    for p in params:
        st = optimizer.state[p]
        if st.get("momentum_buffer") is None:
            st["momentum_buffer"] = torch.zeros_like(p)
        bufs.append(st["momentum_buffer"])
    tensors = params + bufs
    if len(snapshot) != len(tensors):
        snapshot[:] = [torch.empty_like(t) for t in tensors]
    torch._foreach_copy_(snapshot, tensors)
    return tensors


def make_train_step(cfg: Config, graph: str = "end2end",
                    sentinel: bool = False,
                    skip_nonfinite: bool = False) -> Callable:
    """``train_step(state, batch, *, draws=None, generator=None) ->
    (state, metrics)`` of the ``graph`` (``"end2end"``, ``"rpn"`` or
    ``"rcnn"``): ``batch`` holds the device tensors ``images`` (prepped),
    ``im_info``, ``gt_boxes``, ``gt_classes``, ``gt_valid``, and for
    ``"rcnn"`` ``rois``/``roi_valid``; ``draws``/``generator`` feed the
    model's sampling.  Updates ``state`` in place.  ``sentinel`` adds
    ``all_finite`` to the metrics; ``skip_nonfinite`` (which needs it)
    keeps the parameters and momentum of a non-finite step."""
    if graph not in ("end2end", "rpn", "rcnn"):
        raise ValueError(f"unknown graph {graph!r}")
    if skip_nonfinite and not sentinel:
        raise ValueError("skip_nonfinite needs the sentinel")
    clip = cfg.TRAIN.CLIP_GRADIENT
    snapshot: List[torch.Tensor] = []  # the skip policy's copy of the state

    def train_step(state: TrainState, batch: dict, *,
                   draws: Optional[dict] = None,
                   generator: Optional[torch.Generator] = None):
        model, opt = state.model, state.optimizer
        lr = state.schedule(state.schedule_count)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        total, aux = _loss(model, batch, graph, draws, generator)
        total.backward()
        params = [p for group in opt.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = metric_scalars(aux)
        metrics["total_loss"] = total.detach()
        if sentinel:
            finite = _all_finite(total, [p.grad for p in params])
            metrics["all_finite"] = finite.to(torch.float32)
        guarded = (_skip_guard(opt, params, snapshot) if skip_nonfinite
                   else None)
        clip_gradient(model.parameters(), clip)
        opt.step()
        if guarded is not None:
            with torch.no_grad():
                for t, old in zip(guarded, snapshot):
                    torch.where(finite, t, old, out=t)
        state.step += 1
        state.schedule_count += 1
        return state, metrics

    return train_step
