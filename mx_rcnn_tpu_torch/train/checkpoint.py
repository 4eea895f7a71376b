"""Checkpoints (counterpart of ``mx_rcnn_tpu/train/checkpoint.py``:
``_bbox_fold``, ``denormalize_for_save``, ``normalize_for_train``,
``save_params_npz``, ``load_params_npz``).

Params travel in the JAX package's flat layout (``utils/convert_jax.py:
export_jax_params``), so a checkpoint of either package loads into the
other.  The de-normalize contract is the reference's ``do_checkpoint``:
training regresses R-CNN targets normalised by (BBOX_MEANS, BBOX_STDS),
and the saved ``bbox_pred`` weights fold that normalisation in, so
inference needs none; :func:`normalize_for_train` inverts it.  Epoch
checkpoints are ``{prefix}-{epoch:04d}.npz`` (the reference's
``prefix-%04d.params``); the JAX package's orbax managers, step
checkpoints and resume are not ported.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

Params = Dict[str, np.ndarray]


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


def save_params_npz(path: str, params: Params) -> None:
    """The flat ``.npz`` (the JAX package's deployment artifact), its
    directory made when missing."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def load_params_npz(path: str) -> Params:
    """Inverse of :func:`save_params_npz` → the flat dict."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
