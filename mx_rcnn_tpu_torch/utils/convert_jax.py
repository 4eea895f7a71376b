"""The weight bridge between the JAX package's flat parameter layout and
the port's modules, both ways.

The layout is ``mx_rcnn_tpu/train/checkpoint.py:save_params_npz``'s: one
array per flax leaf under its ``/``-joined path, e.g.
``backbone/stage1/unit1/conv1/kernel``.  The port's module paths mirror
those names (``backbone.stage1.unit1.conv1``), and the mapping is:

* ``ScaledConv``: ``<path>/kernel`` (kh, kw, in, out) HWIO ↔ ``kernel``
  OIHW, unfolded; the FrozenBN leaves of the sibling ``bn`` path
  (``conv1``→``bn1``, ``sc_conv``→``sc_bn``, the stem
  ``backbone/conv1``→``backbone/bn1``) ↔ the buffers ``gamma``, ``beta``,
  ``mean``, ``var``.  The stem kernel stays (7, 7, 3, 64).
* ``nn.Conv2d``: kernel HWIO ↔ OIHW, bias (the FPN neck's ``lateral*``
  and ``post*``, the heads' convs).
* ``nn.ConvTranspose2d`` (the mask head's ``mask_deconv``): flax
  ``ConvTranspose`` kernel (kh, kw, in, out) ↔ weight (in, out, kh, kw)
  with both spatial axes flipped (flax applies the kernel unflipped, torch
  as the gradient of a conv), bias.
* ``nn.Linear``: flax ``Dense`` kernel (in, out) ↔ weight (out, in), bias
  (``fc6`` of the FPN box head takes its 7×7×256 input flattened in (h, w,
  c) order on both sides, so it needs no permutation).

Every tensor is float32 on both sides and the maps are transposes, so
:func:`export_jax_params` ∘ :func:`load_jax_params` is bit-exact.  Reads
and writes with numpy only.  A missing or an extra key raises with its
name: a partial load never happens silently.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from mx_rcnn_tpu_torch.models.backbones import ScaledConv

Params = Dict[str, np.ndarray]
BN_LEAVES = ("gamma", "beta", "mean", "var")
OIHW_TO_HWIO = (2, 3, 1, 0)
HWIO_TO_OIHW = (3, 2, 0, 1)


def _bn_path(conv_path: str) -> str:
    parent, sep, leaf = conv_path.rpartition("/")
    return f"{parent}{sep}{leaf.replace('conv', 'bn')}"


def _leaves(model: nn.Module) -> Iterator[Tuple[str, nn.Module, List[Tuple[str, tuple]]]]:
    """(jax path, module, [(jax key, jax shape)]) for every weight-holding
    module of the port, in a fixed order; :func:`_attrs` names the
    module's tensors in the same order."""
    for name, mod in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(mod, ScaledConv):
            o, i, kh, kw = mod.kernel.shape
            bn = _bn_path(path)
            yield path, mod, ([(f"{path}/kernel", (kh, kw, i, o))] +
                              [(f"{bn}/{leaf}", (o,)) for leaf in BN_LEAVES])
        elif isinstance(mod, nn.Conv2d):
            o, i, kh, kw = mod.weight.shape
            yield path, mod, [(f"{path}/kernel", (kh, kw, i, o)),
                              (f"{path}/bias", (o,))]
        elif isinstance(mod, nn.ConvTranspose2d):
            i, o, kh, kw = mod.weight.shape
            yield path, mod, [(f"{path}/kernel", (kh, kw, i, o)),
                              (f"{path}/bias", (o,))]
        elif isinstance(mod, nn.Linear):
            o, i = mod.weight.shape
            yield path, mod, [(f"{path}/kernel", (i, o)), (f"{path}/bias", (o,))]


def _attrs(mod: nn.Module) -> Tuple[str, ...]:
    return ("kernel",) + BN_LEAVES if isinstance(mod, ScaledConv) \
        else ("weight", "bias")


def _tensors(model: nn.Module) -> Iterator[Tuple[str, str, torch.Tensor]]:
    """(jax key, torch attribute, tensor) for every tensor the bridge
    carries; a transpose conv's weight is named ``"deconv"``, its map."""
    for _, mod, keys in _leaves(model):
        for (key, _), attr in zip(keys, _attrs(mod), strict=True):
            tag = ("deconv" if isinstance(mod, nn.ConvTranspose2d)
                   and attr == "weight" else attr)
            yield key, tag, getattr(mod, attr)


def _to_jax(attr: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().to("cpu", torch.float32).numpy()
    if attr == "deconv":
        a = a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    elif attr in ("kernel", "weight"):
        a = a.transpose(OIHW_TO_HWIO) if a.ndim == 4 else a.T
    # np.array copies: on the CPU ``a`` may be a view of the model's own
    # tensor, which later training would change under the export
    return np.array(a, order="C")


def _from_jax(attr: str, a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if attr == "deconv":
        a = a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    elif attr in ("kernel", "weight"):
        a = a.transpose(HWIO_TO_OIHW) if a.ndim == 4 else a.T
    # np.array copies: the source may be a read-only view
    return torch.from_numpy(np.array(a, order="C"))


def param_shapes(model: nn.Module) -> Dict[str, tuple]:
    """Every key the model consumes, with its shape in the JAX layout."""
    return {k: s for _, _, keys in _leaves(model) for k, s in keys}


def jax_names(model: nn.Module) -> Dict[str, str]:
    """``{torch parameter name: JAX key}`` for every ``nn.Parameter`` (the
    FrozenBN statistics are buffers and have none)."""
    ids = {id(p): n for n, p in model.named_parameters()}
    return {ids[id(t)]: key for key, _, t in _tensors(model) if id(t) in ids}


def _as_flat(params: Union[Params, str, os.PathLike]) -> Params:
    if isinstance(params, (str, os.PathLike)):
        with np.load(params) as data:
            return {k: data[k] for k in data.files}
    return dict(params)


def load_jax_params(model: nn.Module, params: Union[Params, str, os.PathLike]) -> None:
    """Copy a flat JAX parameter dict (or its ``.npz``) into ``model`` in
    place.  Raises ``KeyError`` naming every missing or unconsumed key and
    ``ValueError`` naming a key of the wrong shape."""
    flat = _as_flat(params)
    want = param_shapes(model)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"parameter keys do not match the model: missing "
                       f"{missing}, extra {extra}")
    for key, shape in want.items():
        got = tuple(np.shape(flat[key]))
        if got != tuple(shape):
            raise ValueError(f"{key}: expected shape {tuple(shape)}, got {got}")
    with torch.no_grad():
        for key, attr, t in _tensors(model):
            t.copy_(_from_jax(attr, flat[key]))


def export_jax_params(model: nn.Module) -> Params:
    """The model's weights in the flat JAX layout: float32 numpy arrays
    under the ``save_params_npz`` keys (the inverse of
    :func:`load_jax_params`), each owning its memory on every device."""
    return {key: _to_jax(attr, t) for key, attr, t in _tensors(model)}


def random_params(model: nn.Module, seed: int = 0) -> Params:
    """A seeded flat parameter dict in the JAX layout, drawn like the JAX
    package's initialisers: convs and the stem ~ N(0, 1/fan_in) (lecun
    normal), the RPN convs and ``cls_score`` N(0, 0.01²), ``bbox_pred``
    N(0, 0.001²), biases 0, FrozenBN at identity (gamma 1, beta 0, mean 0,
    var 1)."""
    rng = np.random.RandomState(seed)
    out: Params = {}
    for key, shape in param_shapes(model).items():
        leaf = key.rpartition("/")[2]
        if leaf in ("gamma", "var"):
            v = np.ones(shape, np.float32)
        elif leaf in ("beta", "mean", "bias"):
            v = np.zeros(shape, np.float32)
        else:
            if key.startswith("rpn/") or key.endswith("cls_score/kernel"):
                std = 0.01
            elif key.endswith("bbox_pred/kernel"):
                std = 0.001
            else:
                std = 1.0 / np.sqrt(np.prod(shape[:-1]))
            v = (rng.standard_normal(shape) * std).astype(np.float32)
        out[key] = v
    return out
