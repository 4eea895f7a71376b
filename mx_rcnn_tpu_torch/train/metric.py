"""The six reference training metrics and Mask R-CNN's mask loss
(counterpart of ``mx_rcnn_tpu/train/metric.py``; reference
``rcnn/core/metric.py``).

| Reference class    | Key         | Definition                                    |
|--------------------|-------------|-----------------------------------------------|
| RPNAccMetric       | RPNAcc      | argmax accuracy over anchors with label != −1 |
| RPNLogLossMetric   | RPNLogLoss  | the RPN softmax CE (valid-normalized)         |
| RPNL1LossMetric    | RPNL1Loss   | the RPN smooth-L1 loss                        |
| RCNNAccMetric      | RCNNAcc     | argmax accuracy over weighted sampled RoIs    |
| RCNNLogLossMetric  | RCNNLogLoss | the RCNN softmax CE (batch-normalized)        |
| RCNNL1LossMetric   | RCNNL1Loss  | the RCNN smooth-L1 loss                       |
| (Mask R-CNN)       | MaskLoss    | the mask head's sigmoid BCE                   |

``metric_scalars`` leaves its scalars on the device (no synchronisation);
``MetricBank`` keeps the running means of the values the trainer fetches.
"""

from __future__ import annotations

import torch


def metric_scalars(aux: dict) -> dict:
    """Fold a train step's ``aux`` into the named 0-dim tensors: the six
    reference metrics, and ``MaskLoss`` where the graph has a mask head."""
    out = {}
    if "rpn_label" in aux:
        valid = aux["rpn_label"] != -1
        correct = (aux["rpn_pred"] == aux["rpn_label"]) & valid
        out["RPNAcc"] = (correct.to(torch.float32).sum()
                         / torch.clamp_min(valid.to(torch.float32).sum(), 1.0))
        out["RPNLogLoss"] = aux["rpn_cls_loss"].detach()
        out["RPNL1Loss"] = aux["rpn_bbox_loss"].detach()
    if "rcnn_label" in aux:
        w = aux["rcnn_label_weight"]
        correct = (aux["rcnn_pred"] == aux["rcnn_label"]).to(torch.float32) * w
        out["RCNNAcc"] = correct.sum() / torch.clamp_min(w.sum(), 1.0)
        out["RCNNLogLoss"] = aux["rcnn_cls_loss"].detach()
        out["RCNNL1Loss"] = aux["rcnn_bbox_loss"].detach()
    if "mask_loss" in aux:
        out["MaskLoss"] = aux["mask_loss"].detach()
    return out


class MetricBank:
    """Running means over an epoch — the CompositeEvalMetric analogue."""

    def __init__(self):
        self._sum: dict = {}
        self._n = 0

    def update(self, scalars: dict):
        for k, v in scalars.items():
            self._sum[k] = self._sum.get(k, 0.0) + float(v)
        self._n += 1

    def reset(self):
        self._sum.clear()
        self._n = 0

    def get(self) -> dict:
        if self._n == 0:
            return {}
        return {k: v / self._n for k, v in self._sum.items()}

    def format(self) -> str:
        return "\t".join(f"{k}={v:.5f}" for k, v in self.get().items())
