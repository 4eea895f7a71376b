"""Inference driver (counterpart of ``mx_rcnn_tpu/eval/tester.py``:
``Predictor``, ``Predictor.predict``, ``im_detect``).

``Predictor`` binds converted weights to a model on one device;
``im_detect`` runs a batch and maps every image's boxes back to its
original frame, ready for ``ops.postprocess.per_class_nms``.  The JAX
package's program registry, mesh plans, int8 variants, mask and fused
serve programs are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Dict, Union

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.data.image import prep_images
from mx_rcnn_tpu_torch.models.detector import FasterRCNN
from mx_rcnn_tpu_torch.ops.postprocess import decode_image_boxes
from mx_rcnn_tpu_torch.utils.convert_jax import load_jax_params

INFER_DTYPES = ("float32", "bfloat16")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card, and raises
    when there is none — the port never falls back to the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class Predictor:
    """A model with bound weights on one device.

    ``params``: the flat JAX parameter layout (dict or ``.npz`` path, see
    ``utils/convert_jax.py``).  ``dtype``: ``"float32"`` keeps the
    weights as loaded; ``"bfloat16"`` rounds every float32 parameter and
    FrozenBN statistic through bfloat16, the JAX package's bf16 parameter
    variant.  Compute runs in ``cfg.tpu.COMPUTE_DTYPE``; outputs are
    float32 either way.  With float32 compute on the card, TF32 is
    switched off for cuDNN and cuBLAS, which would otherwise run float32
    convolutions in TF32.
    """

    def __init__(self, model: FasterRCNN, params: Union[Dict[str, np.ndarray],
                                                        str, os.PathLike],
                 cfg: Config, device=None, dtype: str = "float32"):
        if dtype not in INFER_DTYPES:
            raise ValueError(f"infer dtype must be one of {INFER_DTYPES}, "
                             f"got {dtype!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.infer_dtype = dtype
        if self.device.type == "cuda" and cfg.tpu.COMPUTE_DTYPE == "float32":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        load_jax_params(model, params)
        if dtype == "bfloat16":
            with torch.no_grad():
                for t in (*model.parameters(), *model.buffers()):
                    t.copy_(t.to(torch.bfloat16))
        self.model = model.to(self.device).eval()

    def batch_put(self, batch: dict) -> dict:
        """Move a batch to the device.  A staged raw batch (keys
        ``raw_hw``/``prep_ratio`` beside uint8 ``images``, from
        ``data.image.stage_raw_to_bucket``) is prepped on the device into
        the network input; ``im_info`` and host keys stay numpy."""
        out = dict(batch)
        images = self._put(batch["images"])
        if "raw_hw" in batch:
            net = self.cfg.network
            images = prep_images(
                images, self._put(out.pop("raw_hw")),
                self._put(out.pop("prep_ratio")),
                self._put(batch["im_info"], torch.float32),
                pixel_means=net.PIXEL_MEANS, pixel_stds=net.PIXEL_STDS,
                s2d=net.HOST_S2D)
        out["images"] = images
        return out

    def _put(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, dtype)

    @torch.inference_mode()
    def predict(self, images, im_info):
        """``FasterRCNN.predict`` on the device → ``(rois, roi_valid,
        cls_prob, bbox_deltas, roi_scores)``, tensors on the device."""
        return self.model.predict(self._put(images),
                                  self._put(im_info, torch.float32))


def im_detect(predictor: Predictor, batch: dict):
    """Forward one batch → per-image ``(scores (R, K), boxes (R, 4K),
    valid (R,))`` numpy triples in ORIGINAL image coordinates, one per
    valid batch row (``batch_valid``, default all)."""
    rois, roi_valid, cls_prob, bbox_deltas, _ = predictor.predict(
        batch["images"], batch["im_info"])
    rois, roi_valid, cls_prob, bbox_deltas = (
        t.cpu().numpy() for t in (rois, roi_valid, cls_prob, bbox_deltas))
    im_info = np.asarray(batch["im_info"])
    n = int(np.sum(batch.get("batch_valid", np.ones(len(rois), bool))))
    return [(cls_prob[b], decode_image_boxes(rois[b], bbox_deltas[b], im_info[b]),
             roi_valid[b]) for b in range(n)]
