"""ResNet backbone with frozen BN (counterpart of
``mx_rcnn_tpu/models/backbones.py``: ``StemConvS2D``, ``FrozenBN``,
``ScaledConv``, ``Bottleneck``, ``ResNetStage``, ``ResNetConv`` with
``all_stages``, ``ResNetStage5``).

Modules take and return NHWC at their boundary, like the JAX package; the
convolutions run on the NCHW view of the same memory (``channels_last``),
so no layout copy is made.  Frozen BN (``use_global_stats``) is an affine
per output channel, applied in the folded form ``conv(x, W·scale) +
shift``, as the JAX package does: ``ScaledConv`` keeps the UNFOLDED
float32 kernel as its trainable parameter and the four FrozenBN
statistics as buffers, and folds on every call — ``kernel · scale`` in
float32, then cast to the compute dtype for the convolution.  Weight decay
and the elementwise gradient clip therefore act on the same leaf as in the
JAX package.  ``gamma``/``beta`` are frozen by every ResNet preset; a
config that trains them is refused (``train/optim.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 2e-5

RESNET_UNITS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor → NCHW view (channels_last memory, no copy)."""
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ScaledConv(nn.Module):
    """Conv followed by FrozenBN, in the folded form: ``kernel`` (out, in,
    k, k) float32 is the parameter, ``gamma``/``beta``/``mean``/``var``
    (out,) float32 are buffers.  ``forward`` convolves with
    ``(kernel · scale)`` cast to ``dtype`` and adds ``shift``.  Operates on
    NCHW views."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.padding = kernel_size // 2
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(
            cout, cin, kernel_size, kernel_size, dtype=torch.float32))
        for name, init in (("gamma", 1.0), ("beta", 0.0), ("mean", 0.0),
                           ("var", 1.0)):
            self.register_buffer(name, torch.full((cout,), init,
                                                  dtype=torch.float32))

    def folded(self):
        """(weight, bias) in the compute dtype: ``kernel · scale`` folded
        in float32 then cast, and the BN shift."""
        scale = self.gamma / torch.sqrt(self.var + BN_EPS)
        shift = self.beta - self.mean * scale
        weight = self.kernel * scale[:, None, None, None]
        return weight.to(self.dtype), shift.to(self.dtype)

    def forward(self, x):
        weight, bias = self.folded()
        return F.conv2d(x, weight, bias, self.stride, self.padding)


class StemConvS2D(ScaledConv):
    """The ResNet 7×7/2 stem (+ bn1), computed as a 4×4/1 conv on
    the 2×2 space-to-depth input.

    With the 7×7 kernel left-padded to 8×8 and regrouped as
    (A, di, B, dj, c), ``y = conv(s2d(x), K', pad (2, 1))`` equals the
    strided conv exactly.  The weight keeps the reference (64, 3, 7, 7)
    form; the regroup is taken per call.  Input is 12-channel s2d
    (``HOST_S2D``, channel order (di, dj, c)) or 3-channel (regrouped here;
    odd sizes fall back to the direct strided conv).
    """

    def __init__(self, features: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__(3, features, 7, 2, dtype)

    @staticmethod
    def s2d_weight(weight: torch.Tensor) -> torch.Tensor:
        """(o, 3, 7, 7) → the (o, 12, 4, 4) kernel of the s2d input."""
        o = weight.shape[0]
        kp = F.pad(weight, (1, 0, 1, 0))                    # (o, 3, 8, 8)
        kp = kp.reshape(o, 3, 4, 2, 4, 2)                   # o, c, A, di, B, dj
        return kp.permute(0, 3, 5, 1, 2, 4).reshape(o, 12, 4, 4)

    def forward(self, x):                                   # NCHW view
        weight, bias = self.folded()
        b, c, h, w = x.shape
        if c == 3:
            if h % 2 or w % 2:
                return F.conv2d(x, weight, bias, 2, 3)
            x = (x.reshape(b, 3, h // 2, 2, w // 2, 2)      # b, c, H, di, W, dj
                 .permute(0, 3, 5, 1, 2, 4).reshape(b, 12, h // 2, w // 2))
        elif c != 12:
            raise ValueError(f"stem takes 3- or 12-channel input, got {c}")
        x = F.pad(x, (2, 1, 2, 1))
        return F.conv2d(x, self.s2d_weight(weight), bias)


class Bottleneck(nn.Module):
    """ResNet bottleneck: 1×1 → 3×3 (stride) → 1×1, each conv with its
    FrozenBN, projection shortcut on the first unit of a stage, add, relu."""

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 project: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ScaledConv(cin, filters, 1, 1, dtype)
        self.conv2 = ScaledConv(filters, filters, 3, stride, dtype)
        self.conv3 = ScaledConv(filters, filters * 4, 1, 1, dtype)
        self.sc_conv = (ScaledConv(cin, filters * 4, 1, stride, dtype)
                        if project else None)

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = self.sc_conv(x) if self.sc_conv is not None else x
        return F.relu(out + sc)


class ResNetStage(nn.Module):
    """One stage: the first unit downsamples/projects, the rest are
    identity units.  Children are named ``unit1``… like the JAX tree."""

    def __init__(self, units: int, cin: int, filters: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.units = units
        self.add_module("unit1", Bottleneck(cin, filters, stride, True, dtype))
        for i in range(2, units + 1):
            self.add_module(f"unit{i}", Bottleneck(filters * 4, filters, 1,
                                                   False, dtype))

    def forward(self, x):
        for i in range(1, self.units + 1):
            x = getattr(self, f"unit{i}")(x)
        return x


class ResNetConv(nn.Module):
    """Stages 1–4 of the ResNet body: NHWC (B, H, W, 3|12) → stride-16,
    1024-channel NHWC features.  With ``all_stages`` (FPN) the body also
    holds ``stage4`` and returns the pyramid ``(C2, C3, C4, C5)`` at
    strides 4–32 (256 … 2048 channels), as the JAX ``ResNetConv(
    all_stages=True)`` does."""

    def __init__(self, depth: str = "resnet50",
                 dtype: torch.dtype = torch.float32, all_stages: bool = False):
        super().__init__()
        units = RESNET_UNITS[depth]
        self.dtype = dtype
        self.all_stages = all_stages
        self.conv1 = StemConvS2D(64, dtype)
        self.stage1 = ResNetStage(units[0], 64, 64, 1, dtype)
        self.stage2 = ResNetStage(units[1], 256, 128, 2, dtype)
        self.stage3 = ResNetStage(units[2], 512, 256, 2, dtype)
        if all_stages:
            self.stage4 = ResNetStage(units[3], 1024, 512, 2, dtype)

    def forward(self, x):
        x = nhwc_to_nchw(x.to(self.dtype))
        x = F.relu(self.conv1(x))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf, like flax
        c2 = self.stage1(x)
        c3 = self.stage2(c2)
        c4 = self.stage3(c3)
        if not self.all_stages:
            return nchw_to_nhwc(c4)
        c5 = self.stage4(c4)
        return tuple(nchw_to_nhwc(c) for c in (c2, c3, c4, c5))


class ResNetStage5(nn.Module):
    """ResNet stage 5 as the R-CNN head body: (…, 14, 14, 1024) pooled RoI
    features → stride 2 → global average pool → (…, 2048)."""

    def __init__(self, depth: str = "resnet50",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stage4 = ResNetStage(RESNET_UNITS[depth][3], 1024, 512, 2, dtype)

    def forward(self, x):
        lead = x.shape[:-3]
        x = nhwc_to_nchw(x.reshape((-1,) + tuple(x.shape[-3:])).to(self.dtype))
        x = self.stage4(x)
        return x.mean(dim=(-2, -1)).reshape(tuple(lead) + (x.shape[1],))
