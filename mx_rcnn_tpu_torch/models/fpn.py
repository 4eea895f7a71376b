"""FPN Faster R-CNN and Mask R-CNN (counterpart of
``mx_rcnn_tpu/models/fpn.py``: ``FPNNeck``, ``_upsample2``,
``FPNBoxHead``, ``FPNFasterRCNN``'s ``_pyramid``, ``_anchors_for_level``,
``_rpn_over_levels``, ``_assign_level``, ``_pool_levels``, ``_box_head``,
the training graphs ``__call__``, ``rpn_train`` and ``rcnn_train`` with
``_rpn_losses``, ``_propose_train`` and ``_rcnn_losses``, and ``predict``,
``predict_with_feats``, ``masks_from_feats``, ``predict_masks`` and
``predict_rpn``).

* neck: lateral 1×1 convs on C2–C5, nearest 2× top-down upsampling,
  3×3 smoothing → P2–P5 (256 channels); P6 = P5[:, ::2, ::2] (flax's
  ``max_pool`` with window 1 and stride 2), for the RPN only;
* RPN: one shared head over P2–P6, one scale × 3 ratios an anchor position
  at each level's stride; per-level top-k, then one joint NMS
  (``ops/proposal.py:propose_fpn``, on the CUDA NMS kernels);
* RoI features: the level ``floor(4 + log2(√(w·h)/224 + 1e-8))`` clamped
  to P2–P5; every RoI is pooled from all four levels and the assigned one
  kept by a one-hot product, the JAX package's arithmetic (at P2 of
  800×1344 the box head's ROIAlign intermediate is ~430 MB in bf16);
* box head: fc6/fc7 (1024) on the 7×7×256 pooled features flattened in
  (h, w, c) order — the port pools NHWC, so its flatten is the JAX one —
  then ``cls_score``/``bbox_pred``;
* mask head (``HAS_MASK``): 14×14 ROIAlign on the assigned level →
  ``heads.MaskHead`` → the label's 28×28 logits → sigmoid.

Training (``forward``) is the C4 graph's over the pyramid: one
``assign_anchor`` an image over the concatenated P2–P6 anchors (the fused
assign kernels under ``ASSIGN_FUSED``) and the two RPN losses;
``propose_fpn`` at the TRAIN config on the detached RPN outputs (the NMS
kernels); the gt appended, ``sample_rois``, the box head on the sampled
RoIs and the two R-CNN losses; and, for a mask config given ``gt_masks``,
the mask head on 14×14 pools of the sampled RoIs, the label's channel,
``ops/mask_target.py``'s targets on each RoI's matched gt, and
``mask_bce`` weighted by ``is_fg · (label > 0)``, per image and then
averaged over the batch as the JAX ``vmap(...).mean()`` does.
``rpn_train`` and ``rcnn_train`` are the alternate-training stage graphs;
``rcnn_train`` of a mask config raises, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.models.backbones import (ResNetConv, nchw_to_nhwc,
                                                nhwc_to_nchw)
from mx_rcnn_tpu_torch.models.detector import (assign_targets, compute_dtype,
                                               rcnn_loss_terms, rpn_loss_terms,
                                               sample_targets)
from mx_rcnn_tpu_torch.models.heads import MaskHead, RCNNOutput, RPNHead
from mx_rcnn_tpu_torch.models.losses import fg_prob, mask_bce
from mx_rcnn_tpu_torch.ops.anchors import all_anchors, generate_anchors
from mx_rcnn_tpu_torch.ops.mask_target import mask_targets_for_rois
from mx_rcnn_tpu_torch.ops.proposal import propose_fpn
from mx_rcnn_tpu_torch.ops.roi_align import roi_align

# the JAX package's refusal (mx_rcnn_tpu/models/fpn.py:rcnn_train)
NO_MASK_ALTERNATE = ("alternate training has no mask-target path; train "
                     "mask configs end2end (train_end2end.py)")


def _conv(conv: nn.Conv2d, x, dtype):
    return F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype),
                    padding=conv.padding)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest 2× (``jax.image.resize(..., "nearest")`` to exactly
    twice the size: each source pixel repeated 2 × 2)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class FPNNeck(nn.Module):
    """C2–C5 (NHWC) → P2–P6 (NHWC, ``out_channels`` each)."""

    def __init__(self, in_channels=(256, 512, 1024, 2048),
                 out_channels: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for lvl, cin in zip(range(2, 6), in_channels, strict=True):
            self.add_module(f"lateral{lvl}", nn.Conv2d(cin, out_channels, 1))
        for lvl in range(2, 6):
            self.add_module(f"post{lvl}", nn.Conv2d(out_channels,
                                                    out_channels, 3,
                                                    padding=1))

    def _level_conv(self, name: str, x):
        return nchw_to_nhwc(_conv(getattr(self, name),
                                  nhwc_to_nchw(x.to(self.dtype)), self.dtype))

    def forward(self, c2, c3, c4, c5):
        p5 = self._level_conv("lateral5", c5)
        p4 = self._level_conv("lateral4", c4) + upsample2(p5)
        p3 = self._level_conv("lateral3", c3) + upsample2(p4)
        p2 = self._level_conv("lateral2", c2) + upsample2(p3)
        p2, p3, p4, p5 = (self._level_conv(f"post{lvl}", p)
                          for lvl, p in zip(range(2, 6), (p2, p3, p4, p5)))
        return p2, p3, p4, p5, p5[:, ::2, ::2]


class FPNBoxHead(nn.Module):
    """(…, 7, 7, C) → flattened in (h, w, c) order → fc6 → relu → fc7 →
    relu → (…, 1024)."""

    def __init__(self, cin: int = 7 * 7 * 256, width: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc6 = nn.Linear(cin, width)
        self.fc7 = nn.Linear(width, width)

    def forward(self, x):
        x = x.reshape(tuple(x.shape[:-3]) + (-1,)).to(self.dtype)
        for fc in (self.fc6, self.fc7):
            x = F.relu(F.linear(x, fc.weight.to(self.dtype),
                                fc.bias.to(self.dtype)))
        return x


def assign_level(rois: torch.Tensor) -> torch.Tensor:
    """(…, 4) RoIs → pyramid level index 0..3 (P2..P5), the FPN paper's
    eq. 1 in float32 as the JAX package computes it."""
    w = rois[..., 2] - rois[..., 0] + 1.0
    h = rois[..., 3] - rois[..., 1] + 1.0
    k = torch.floor(4.0 + torch.log2(torch.sqrt(w * h) / 224.0 + 1e-8))
    return torch.clamp(k, 2.0, 5.0).to(torch.int64) - 2


class FPNFasterRCNN(nn.Module):
    """Multi-level two-stage detector on a ResNet body, with a mask head
    when ``cfg.network.HAS_MASK``."""

    def __init__(self, cfg: Config):
        super().__init__()
        net = cfg.network
        if not net.NETWORK.startswith("resnet"):
            raise NotImplementedError(
                f"FPN needs a ResNet body, got {net.NETWORK!r}")
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        ch = net.FPN_OUT_CHANNELS
        self.backbone = ResNetConv(net.NETWORK, self.dtype, all_stages=True)
        self.neck = FPNNeck(out_channels=ch, dtype=self.dtype)
        self.rpn = RPNHead(ch, net.NUM_ANCHORS, ch, self.dtype)
        self.head_body = FPNBoxHead(7 * 7 * ch, 1024, self.dtype)
        self.rcnn_out = RCNNOutput(1024, cfg.NUM_CLASSES, self.dtype)
        self.has_mask = bool(net.HAS_MASK)
        if self.has_mask:
            self.mask_head = MaskHead(ch, cfg.NUM_CLASSES, 256, self.dtype)
        self._anchors: Dict[Tuple[int, int, int, torch.device],
                            torch.Tensor] = {}

    # ---- shared pieces -----------------------------------------------------

    @property
    def _strides(self):
        return self.cfg.network.FPN_FEAT_STRIDES

    def _pyramid(self, images):
        """NHWC images → (P2, P3, P4, P5, P6), NHWC, compute dtype."""
        return self.neck(*self.backbone(images))

    def _anchors_for_level(self, feat_h: int, feat_w: int, stride: int,
                           device: torch.device) -> torch.Tensor:
        key = (feat_h, feat_w, stride, device)
        if key not in self._anchors:
            net = self.cfg.network
            base = generate_anchors(base_size=stride, ratios=net.ANCHOR_RATIOS,
                                    scales=(net.FPN_ANCHOR_SCALES[0],))
            self._anchors[key] = torch.from_numpy(all_anchors(
                feat_h, feat_w, stride, base)).to(device)
        return self._anchors[key]

    def _rpn_over_levels(self, feats):
        """The shared RPN head over P2–P6 → per level ``(cls (B, N_l, 2),
        bbox (B, N_l, 4), anchors (N_l, 4))``."""
        out = []
        for feat, stride in zip(feats, self._strides, strict=True):
            cls, bbox = self.rpn(feat)
            out.append((cls, bbox, self._anchors_for_level(
                feat.shape[1], feat.shape[2], stride, feat.device)))
        return out

    @staticmethod
    def _propose(levels, im_info, conf):
        """``propose_fpn`` over the levels' RPN outputs with ``conf``'s
        (TRAIN or TEST) settings → ``(rois, roi_scores, roi_valid)``."""
        return propose_fpn([fg_prob(c) for c, _, _ in levels],
                           [b for _, b, _ in levels],
                           [a for _, _, a in levels],
                           im_info.to(torch.float32),
                           pre_nms_top_n=conf.RPN_PRE_NMS_TOP_N,
                           post_nms_top_n=conf.RPN_POST_NMS_TOP_N,
                           nms_thresh=conf.RPN_NMS_THRESH,
                           min_size=conf.RPN_MIN_SIZE,
                           use_kernel=conf.CXX_PROPOSAL)

    def _proposals(self, feats, im_info):
        return self._propose(self._rpn_over_levels(feats), im_info,
                             self.cfg.TEST)

    def _pool_levels(self, feats, rois, pooled: int):
        """(B, R, 4) image-frame RoIs → (B, R, P, P, C) pooled from each
        RoI's level: all four levels pooled, the assigned one selected by a
        one-hot product in the compute dtype."""
        lvl = assign_level(rois)
        acc = None
        for li in range(4):
            p = roi_align(feats[li].to(self.dtype), rois,
                          spatial_scale=1.0 / self._strides[li],
                          pooled_size=pooled,
                          sampling_ratio=self.cfg.tpu.ROI_SAMPLING_RATIO,
                          mode=self.cfg.tpu.ROI_MODE)
            sel = (lvl == li).to(p.dtype)[..., None, None, None]
            acc = p * sel if acc is None else acc + p * sel
        return acc

    def _box_head(self, feats, rois):
        return self.rcnn_out(self.head_body(self._pool_levels(feats, rois, 7)))

    def _label_channel(self, logits, labels):
        """(B, R, M, M, K) per-class mask logits → (B, R, M, M), each RoI's
        ``labels`` channel (a gather: the JAX one-hot product picks the
        same float32 value)."""
        idx = labels.to(torch.int64)[:, :, None, None, None].expand(
            -1, -1, logits.shape[2], logits.shape[3], 1)
        return torch.gather(logits, -1, idx)[..., 0]

    # ---- the training pieces (end to end and the stage graphs) -------------

    def _rpn_losses(self, levels, im_info, gt_boxes, gt_valid, draws,
                    generator) -> dict:
        """One ``assign_anchor`` an image over the concatenated level
        anchors, then the two RPN losses (normalised by ``RPN_BATCH_SIZE ·
        B``)."""
        cls = torch.cat([c for c, _, _ in levels], dim=1)
        bbox = torch.cat([b for _, b, _ in levels], dim=1)
        anchors = torch.cat([a for _, _, a in levels], dim=0)
        assign = assign_targets(self.cfg, anchors, gt_boxes, gt_valid,
                                im_info, draws, generator)
        return rpn_loss_terms(self.cfg, cls, bbox, assign, gt_boxes.shape[0])

    def _rcnn_losses(self, feats, rois, roi_valid, gt_boxes, gt_classes,
                     gt_valid, draws, generator):
        """``sample_rois`` on the proposals with the gt appended, the box
        head on the sampled RoIs and its two losses → ``(aux, targets)``."""
        tgt = sample_targets(self.cfg, rois, roi_valid, gt_boxes, gt_classes,
                             gt_valid, draws, generator)
        cls_logits, bbox_out = self._box_head(feats, tgt["rois"])
        return rcnn_loss_terms(self.cfg, cls_logits, bbox_out, tgt,
                               gt_boxes.shape[0]), tgt

    def _mask_loss(self, feats, tgt, gt_masks, gt_boxes):
        """The mask head on the sampled RoIs against their targets: the
        BCE of each image's weighted RoIs, averaged over the batch."""
        logits = self.mask_head(self._pool_levels(feats, tgt["rois"], 14))
        logit = self._label_channel(logits, tgt["label"])
        with torch.no_grad():
            targets = mask_targets_for_rois(
                gt_masks, gt_boxes, tgt["rois"], tgt["gt_index"],
                out_size=self.cfg.TRAIN.MASK_SIZE)
            weight = tgt["is_fg"].to(torch.float32) * (tgt["label"] > 0)
        return mask_bce(logit, targets, weight).mean()

    # ---- the training graphs -----------------------------------------------

    def forward(self, images, im_info, gt_boxes, gt_classes, gt_valid,
                gt_masks: Optional[torch.Tensor] = None, *,
                draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None):
        """One training forward pass (``FasterRCNN.forward``'s contract
        over the pyramid).

        Args:
          images: (B, H, W, 3|12) NHWC network input (after device prep).
          im_info: (B, 3) float32; gt_boxes (B, G, 4) float32; gt_classes
            (B, G) int; gt_valid (B, G) bool.
          gt_masks: (B, G, S, S) gt-box-frame masks (``uint8`` or float),
            for the mask loss of a ``HAS_MASK`` config; without them the
            mask head gets no loss, as in the JAX package.
          draws: optional ``{"rpn": (fg, bg), "rcnn": (fg, bg)}``, (B, N)
            over the concatenated anchors and (B, TRAIN post-NMS + G);
            drawn from ``generator`` when absent.

        Returns ``(total_loss, aux)`` with the four losses, ``mask_loss``
        when it is computed, and the raw pieces of the metrics.
        """
        draws = draws or {}
        im_info = im_info.to(torch.float32)
        feats = self._pyramid(images)
        levels = self._rpn_over_levels(feats)
        aux = self._rpn_losses(levels, im_info, gt_boxes, gt_valid,
                               draws.get("rpn"), generator)
        with torch.no_grad():
            # the Proposal op: non-differentiable by contract
            rois, _, roi_valid = self._propose(levels, im_info,
                                               self.cfg.TRAIN)
        rcnn, tgt = self._rcnn_losses(feats, rois, roi_valid, gt_boxes,
                                      gt_classes, gt_valid, draws.get("rcnn"),
                                      generator)
        aux.update(rcnn)
        total = (aux["rpn_cls_loss"] + aux["rpn_bbox_loss"]
                 + aux["rcnn_cls_loss"] + aux["rcnn_bbox_loss"])
        if self.has_mask and gt_masks is not None:
            aux["mask_loss"] = self._mask_loss(feats, tgt, gt_masks, gt_boxes)
            total = total + aux["mask_loss"]
        return total, aux

    def rpn_train(self, images, im_info, gt_boxes, gt_valid, *,
                  draws: Optional[dict] = None,
                  generator: Optional[torch.Generator] = None):
        """The RPN-only graph over the pyramid (alternate stages 1 and 4):
        ``draws``: optional ``{"rpn": (fg, bg)}``, each (B, N)."""
        levels = self._rpn_over_levels(self._pyramid(images))
        aux = self._rpn_losses(levels, im_info.to(torch.float32), gt_boxes,
                               gt_valid, (draws or {}).get("rpn"), generator)
        return aux["rpn_cls_loss"] + aux["rpn_bbox_loss"], aux

    def rcnn_train(self, images, im_info, rois, roi_valid, gt_boxes,
                   gt_classes, gt_valid, *, draws: Optional[dict] = None,
                   generator: Optional[torch.Generator] = None):
        """The box head on given proposals (alternate stages 3 and 6):
        ``rois`` (B, P, 4) in the scaled frame; ``draws``: optional
        ``{"rcnn": (fg, bg)}``, each (B, P + G).  A mask config raises:
        the stage pipeline has no mask targets, and a mask head left at
        its initial weights would give garbage masks."""
        if self.has_mask:
            raise NotImplementedError(NO_MASK_ALTERNATE)
        del im_info  # the RoIs arrive in the scaled frame
        aux, _ = self._rcnn_losses(self._pyramid(images),
                                   rois.to(torch.float32), roi_valid,
                                   gt_boxes, gt_classes, gt_valid,
                                   (draws or {}).get("rcnn"), generator)
        return aux["rcnn_cls_loss"] + aux["rcnn_bbox_loss"], aux

    # ---- inference ---------------------------------------------------------

    def predict(self, images, im_info):
        """NHWC images, im_info (B, 3) → ``(rois, roi_valid, cls_prob,
        bbox_deltas, roi_scores)``, as ``FasterRCNN.predict``."""
        return self.predict_with_feats(images, im_info)[0]

    def predict_with_feats(self, images, im_info):
        """:meth:`predict` and the pyramid P2–P6 (compute dtype), so that
        the mask branch reuses it without running the body again."""
        feats = self._pyramid(images)
        rois, roi_scores, roi_valid = self._proposals(feats, im_info)
        cls_logits, bbox_deltas = self._box_head(feats, rois)
        cls_prob = torch.softmax(cls_logits, dim=-1)
        return (rois, roi_valid, cls_prob, bbox_deltas, roi_scores), feats

    def masks_from_feats(self, feats, boxes, labels):
        """The mask branch over a computed pyramid: (B, R, 4) boxes in the
        scaled frame and (B, R) labels → (B, R, 28, 28) float32 sigmoid
        probabilities of each box's label."""
        logits = self.mask_head(self._pool_levels(feats, boxes, 14))
        return torch.sigmoid(self._label_channel(logits, labels))

    def predict_masks(self, images, im_info, boxes, labels):
        """The mask branch from raw images (the pyramid computed again)."""
        del im_info
        return self.masks_from_feats(self._pyramid(images), boxes, labels)

    def predict_rpn(self, images, im_info):
        """RPN-only inference → ``(rois, roi_scores, roi_valid)``."""
        return self._proposals(self._pyramid(images), im_info)
