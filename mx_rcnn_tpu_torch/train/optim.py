"""Optimizer (counterpart of ``mx_rcnn_tpu/train/optim.py``).

The reference's ``train_end2end.py`` optimizer: SGD with momentum 0.9,
weight decay 0.0005, elementwise gradient clip at 5, a MultiFactor LR
schedule (optional linear warmup), and ``fixed_param_prefix`` freezing.
The JAX package chains optax's ``_clip_elementwise`` →
``add_decayed_weights`` → ``sgd(momentum)``: each gradient element is
clamped to ±clip, then ``wd · w`` is added, then the momentum trace
``m = g + μ·m`` (zero-initialised) moves the weight by ``−lr · m``.
``clip_gradient`` (an in-place ``clamp_`` of every gradient) followed by
``torch.optim.SGD(momentum=μ, weight_decay=wd)`` (no dampening, no
Nesterov: its buffer starts at the first gradient, the same value) is
that chain, update for update.

Frozen leaves are the JAX package's, decided on the same flat names
(``utils/convert_jax.py:jax_names``): they get ``requires_grad=False`` and
never reach the optimizer.  Every other leaf is decayed and carries its
momentum on every step, also where the step's graph does not reach it
(``train/train_step.py`` gives it a zero gradient), as optax's chain does.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
import torch.nn as nn

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.utils.convert_jax import jax_names, param_shapes

# FrozenBN statistics are never optimizer targets, in any config
_ALWAYS_FROZEN = ("mean", "var")
_BN_AFFINE = ("gamma", "beta")


def fixed_param_mask(keys: Iterable[str],
                     fixed_prefixes: Sequence[str]) -> Dict[str, bool]:
    """``{flat JAX key: trainable}``.

    MXNet's ``fixed_param_prefix`` matches ``name.startswith(prefix)`` on
    flat names; the JAX package's flat name is the path below the
    top-level submodule joined with ``_`` (``backbone/stage1/unit1/conv1/
    kernel`` → ``stage1_unit1_conv1_kernel``), so ``conv1`` freezes the
    stem but not ``stage2_unit1_conv1``.  Prefixes that are BN leaf names
    (``gamma``/``beta``) freeze those leaves everywhere; ``mean``/``var``
    are always frozen."""
    structural = tuple(p for p in fixed_prefixes if p not in _BN_AFFINE)
    leaf_frozen = {p for p in fixed_prefixes if p in _BN_AFFINE}
    leaf_frozen.update(_ALWAYS_FROZEN)

    def frozen(key: str) -> bool:
        names = key.split("/")
        flat = "_".join(names[1:]) if len(names) > 1 else names[0]
        return any(flat.startswith(p) for p in structural) or \
            names[-1] in leaf_frozen

    return {k: not frozen(k) for k in keys}


def apply_param_mask(model: nn.Module,
                     fixed_prefixes: Sequence[str]) -> Dict[str, bool]:
    """Set ``requires_grad`` of every parameter from
    :func:`fixed_param_mask` over the model's JAX keys and return the mask.
    The FrozenBN affine is held in buffers, so a config that would train
    ``gamma``/``beta`` raises ``NotImplementedError``."""
    mask = fixed_param_mask(param_shapes(model), fixed_prefixes)
    trained_bn = sorted(k for k, t in mask.items()
                        if t and k.rpartition("/")[2] in _BN_AFFINE)
    if trained_bn:
        raise NotImplementedError(
            f"training the FrozenBN affine is not ported (FIXED_PARAMS must "
            f"name gamma and beta); would train {trained_bn[:3]}...")
    for name, key in jax_names(model).items():
        model.get_parameter(name).requires_grad_(mask[key])
    return mask


def make_lr_schedule(cfg: Config, steps_per_epoch: int,
                     begin_epoch: int = 0) -> Callable[[int], float]:
    """MultiFactorScheduler(step=LR_STEP epochs, factor=LR_FACTOR) with the
    optional linear warmup, as optax's ``piecewise_constant_schedule``
    joined after ``linear_schedule``: the factor applies from the boundary
    step on.  The step count starts at 0 in ``begin_epoch``: a drop at
    epoch ``e`` lands on step ``(e − begin_epoch) · steps_per_epoch``, and
    the drops at or before ``begin_epoch`` are not applied."""
    tr = cfg.TRAIN
    warmup = tr.WARMUP_STEP if (tr.WARMUP and tr.WARMUP_STEP > 0) else 0
    # MultiFactor drops land on GLOBAL steps; the warmup shifts the
    # constant schedule's clock like optax.join_schedules (a set: the JAX
    # package keys its boundaries in a dict)
    boundaries = sorted({(e - begin_epoch) * steps_per_epoch - warmup
                         for e in tr.LR_STEP
                         if (e - begin_epoch) * steps_per_epoch > 0})

    def constant(count: int) -> float:
        lr = tr.LR
        for b in boundaries:
            if count >= b:
                lr *= tr.LR_FACTOR
        return lr

    def schedule(count: int) -> float:
        if count < warmup:
            return tr.WARMUP_LR + (tr.LR - tr.WARMUP_LR) * count / warmup
        return constant(count - warmup)

    return schedule


def clip_gradient(params: Iterable[torch.Tensor], clip: float) -> None:
    """MXNet ``clip_gradient``: clamp every gradient element to
    [−clip, clip], in place."""
    for p in params:
        if p.grad is not None:
            p.grad.clamp_(-clip, clip)


def make_optimizer(cfg: Config, model: nn.Module, steps_per_epoch: int,
                   begin_epoch: int = 0,
                   fixed_prefixes: Optional[Sequence[str]] = None):
    """-> ``(optimizer, schedule, mask)``: SGD over the parameters that
    ``fixed_prefixes`` (default ``cfg.network.FIXED_PARAMS``) leaves
    trainable (the others get ``requires_grad=False``), the LR schedule by
    step from ``begin_epoch``, and the trainable mask over the JAX keys."""
    tr = cfg.TRAIN
    if tr.OPT_ACC_DTYPE != "float32":
        raise NotImplementedError(
            f"OPT_ACC_DTYPE={tr.OPT_ACC_DTYPE!r}: the port keeps the "
            f"momentum in float32 only")
    if fixed_prefixes is None:
        fixed_prefixes = cfg.network.FIXED_PARAMS
    mask = apply_param_mask(model, fixed_prefixes)
    schedule = make_lr_schedule(cfg, steps_per_epoch, begin_epoch)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.SGD(params, lr=schedule(0), momentum=tr.MOMENTUM,
                          weight_decay=tr.WD)
    return opt, schedule, mask
