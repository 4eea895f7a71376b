"""``combine_model`` (counterpart of ``mx_rcnn_tpu/utils/combine_model.py``;
reference ``rcnn/utils/combine_model.py``): the last step of 4-step
alternate training merges the RPN stage's and the R-CNN stage's weights
into one deployment model, on the flat JAX keys
(``utils/convert_jax.py``)."""

from __future__ import annotations

from typing import Dict

import numpy as np

# top-level groups taken from each stage; the FPN neck is shared with the
# RPN, and the mask head rides with the R-CNN head
RPN_KEYS = ("backbone", "neck", "rpn")
RCNN_KEYS = ("head_body", "rcnn_out", "mask_head")
# the groups every detector has; the neck and the mask head are optional
REQUIRED = ("backbone", "rpn", "head_body", "rcnn_out")


def combine_model(rpn_params: Dict[str, np.ndarray],
                  rcnn_params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The ``backbone/…``, ``neck/…`` and ``rpn/…`` leaves of
    ``rpn_params`` with the ``head_body/…``, ``rcnn_out/…`` and
    ``mask_head/…`` leaves of ``rcnn_params``.  Raises ``KeyError`` naming
    every required group that neither supplies."""
    out = {k: v for k, v in rpn_params.items()
           if k.split("/", 1)[0] in RPN_KEYS}
    out.update({k: v for k, v in rcnn_params.items()
                if k.split("/", 1)[0] in RCNN_KEYS})
    have = {k.split("/", 1)[0] for k in out}
    missing = [g for g in REQUIRED if g not in have]
    if missing:
        raise KeyError(f"combine_model: missing submodules {missing}")
    return out
