"""Proposal roidb assembly (counterpart of
``mx_rcnn_tpu/utils/load_data.py:load_proposals``): attach the proposals
cached by ``tools/test_rpn.py`` to a gt roidb for ``ROIIter`` training."""

from __future__ import annotations

import pickle

import numpy as np

from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.logger import logger


def load_proposals(roidb: list, pkl_path: str) -> list:
    """Attach per-image proposals from a ``test_rpn`` cache (a pickled list
    aligned with ``roidb`` by index; ``None`` for an image without any),
    each sanitized into its image.  Raises ``ValueError`` when the lengths
    differ."""
    with open(pkl_path, "rb") as f:
        proposals = pickle.load(f)
    if len(proposals) != len(roidb):
        raise ValueError(f"proposal cache has {len(proposals)} entries for "
                         f"{len(roidb)} roidb records")
    n = 0
    for rec, props in zip(roidb, proposals):
        rec["proposals"] = IMDB.sanitize_proposals(
            props if props is not None else np.zeros((0, 4), np.float32),
            rec["width"], rec["height"])
        n += len(rec["proposals"])
    logger.info("attached %d proposals from %s", n, pkl_path)
    return roidb
