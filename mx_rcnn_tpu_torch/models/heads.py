"""RPN, R-CNN and mask output heads (counterpart of
``mx_rcnn_tpu/models/heads.py``: ``RPNHead``, ``RCNNOutput``,
``MaskHead``).

RPN: 3×3 conv (512) + relu → sibling 1×1 convs ``rpn_cls_score`` (2A) and
``rpn_bbox_pred`` (4A).  Outputs keep the JAX package's layout: NHWC
features flattened to (B, H·W·A, 2) / (B, H·W·A, 4), so the anchor index
is ``(y·W + x)·A + a`` and the 2A channels are ordered ``a·2 + k`` (a
torchvision-style (2, A) split would pair the wrong logits).

Mask (Mask R-CNN): 4 × [3×3 conv 256 + relu] → 2×2 stride-2 transpose
conv + relu → 1×1 conv to K channels, (R, 14, 14, C) → (R, 28, 28, K)
logits.  flax's ``ConvTranspose`` (``transpose_kernel=False``) applies its
kernel unflipped: output pixel ``(2i + dy, 2j + dx)`` takes ``kernel[1 −
dy, 1 − dx]``, where ``torch``'s transpose conv takes ``weight[dy, dx]``.
The port keeps the ``torch`` weight, (in, out, kh, kw), and
``utils/convert_jax.py`` flips both spatial axes on the way in and out.

Parameters are float32 (the trainable leaves); each call casts weight and
bias to the compute dtype, as flax's ``dtype=`` does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mx_rcnn_tpu_torch.models.backbones import nchw_to_nhwc, nhwc_to_nchw


class RPNHead(nn.Module):
    def __init__(self, cin: int = 1024, num_anchors: int = 9,
                 channels: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_anchors = num_anchors
        self.dtype = dtype
        self.rpn_conv_3x3 = nn.Conv2d(cin, channels, 3, padding=1)
        self.rpn_cls_score = nn.Conv2d(channels, 2 * num_anchors, 1)
        self.rpn_bbox_pred = nn.Conv2d(channels, 4 * num_anchors, 1)

    def _conv(self, conv: nn.Conv2d, x):
        return F.conv2d(x, conv.weight.to(self.dtype),
                        conv.bias.to(self.dtype), padding=conv.padding)

    def forward(self, feat):
        """feat (B, H, W, C) NHWC → (cls_logits (B, H·W·A, 2) f32,
        bbox_deltas (B, H·W·A, 4) f32)."""
        b = feat.shape[0]
        x = F.relu(self._conv(self.rpn_conv_3x3,
                              nhwc_to_nchw(feat.to(self.dtype))))
        cls = nchw_to_nhwc(self._conv(self.rpn_cls_score, x)).reshape(b, -1, 2)
        bbox = nchw_to_nhwc(self._conv(self.rpn_bbox_pred, x)).reshape(b, -1, 4)
        return cls.to(torch.float32), bbox.to(torch.float32)


class RCNNOutput(nn.Module):
    """``cls_score`` (K) and ``bbox_pred`` (4K) FCs on the head embedding."""

    def __init__(self, cin: int = 2048, num_classes: int = 21,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.cls_score = nn.Linear(cin, num_classes)
        self.bbox_pred = nn.Linear(cin, 4 * num_classes)

    def _fc(self, fc: nn.Linear, x):
        return F.linear(x, fc.weight.to(self.dtype),
                        fc.bias.to(self.dtype)).to(torch.float32)

    def forward(self, x):
        x = x.to(self.dtype)
        return self._fc(self.cls_score, x), self._fc(self.bbox_pred, x)


class MaskHead(nn.Module):
    """Mask R-CNN head: (…, 14, 14, C) NHWC pooled RoI features → (…, 28,
    28, K) float32 per-class logits."""

    def __init__(self, cin: int = 256, num_classes: int = 81,
                 channels: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for i in range(1, 5):
            self.add_module(f"mask_conv{i}", nn.Conv2d(
                cin if i == 1 else channels, channels, 3, padding=1))
        self.mask_deconv = nn.ConvTranspose2d(channels, channels, 2, stride=2)
        self.mask_out = nn.Conv2d(channels, num_classes, 1)

    def _conv(self, conv: nn.Conv2d, x):
        return F.conv2d(x, conv.weight.to(self.dtype),
                        conv.bias.to(self.dtype), padding=conv.padding)

    def forward(self, x):
        lead = x.shape[:-3]
        x = nhwc_to_nchw(x.reshape((-1,) + tuple(x.shape[-3:]))
                         .to(self.dtype))
        for i in range(1, 5):
            x = F.relu(self._conv(getattr(self, f"mask_conv{i}"), x))
        d = self.mask_deconv
        x = F.relu(F.conv_transpose2d(x, d.weight.to(self.dtype),
                                      d.bias.to(self.dtype), stride=2))
        x = nchw_to_nhwc(self._conv(self.mask_out, x)).to(torch.float32)
        return x.reshape(tuple(lead) + tuple(x.shape[1:]))
