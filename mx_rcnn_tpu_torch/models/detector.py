"""Faster R-CNN graphs (counterpart of ``mx_rcnn_tpu/models/detector.py``:
``FasterRCNN.__call__``/``predict``/``predict_rpn``, ``_rcnn_head``,
``_anchors_for``, ``build_model``).

Inference: conv body (ResNet stages 1–4, or VGG-16's 13 convs) → RPN head
→ ``fg_prob`` → ``propose`` (the CUDA NMS kernels) → ROIAlign (14×14 for
ResNet, 7×7 for VGG) → head body (ResNet stage 5, or VGG's fc6/fc7) →
``cls_score``/``bbox_pred`` → softmax.

Training (``forward``, the reference's ``get_resnet_train`` /
``get_vgg_train``): the same body and RPN → batched ``assign_anchor`` (the
fused assign kernels when ``cfg.tpu.ASSIGN_FUSED``) → ``propose`` on the
detached RPN outputs with the TRAIN settings → gt appended →
``sample_rois`` → the R-CNN head on the sampled RoIs, VGG's with dropout
on → the four losses.  Labels, targets and proposals carry no gradient;
everything else is autograd.  ``rpn_train`` and ``rcnn_train`` are the
alternate-training graphs: the RPN half with its losses, and the R-CNN
half on given proposals.  ``build_model`` hands FPN and Mask R-CNN configs
to ``models/fpn.py``, which shares the training pieces here
(``assign_targets``, ``sample_targets``, ``rpn_loss_terms``,
``rcnn_loss_terms``).

Random draws: ``draws`` may carry the step's uniforms and dropout masks
(``{"rpn": (fg, bg), "rcnn": (fg, bg), "dropout": (keep6, keep7)}``);
each one absent is drawn from ``generator`` (``jax.random`` streams differ
from torch's, so parity with the JAX package feeds its draws in).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.models.backbones import (VGGFC, ResNetConv,
                                               ResNetStage5, VGGConv)
from mx_rcnn_tpu_torch.models.heads import RCNNOutput, RPNHead
from mx_rcnn_tpu_torch.models import losses as L
from mx_rcnn_tpu_torch.models.losses import fg_prob
from mx_rcnn_tpu_torch.ops.anchors import all_anchors, generate_anchors
from mx_rcnn_tpu_torch.ops.assign_anchor import assign_anchor
from mx_rcnn_tpu_torch.ops.proposal import propose
from mx_rcnn_tpu_torch.ops.roi_align import roi_align
from mx_rcnn_tpu_torch.ops.sample_rois import sample_rois

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: Config) -> torch.dtype:
    name = cfg.tpu.COMPUTE_DTYPE
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"COMPUTE_DTYPE must be one of {sorted(COMPUTE_DTYPES)},"
                         f" got {name!r}")
    return COMPUTE_DTYPES[name]


def assign_targets(cfg: Config, anchors, gt_boxes, gt_valid, im_info, draws,
                   generator) -> dict:
    """``assign_anchor`` with the TRAIN settings (no gradient)."""
    tr = cfg.TRAIN
    with torch.no_grad():
        return assign_anchor(
            anchors, gt_boxes, gt_valid, im_info,
            batch_size=tr.RPN_BATCH_SIZE, fg_fraction=tr.RPN_FG_FRACTION,
            pos_overlap=tr.RPN_POSITIVE_OVERLAP,
            neg_overlap=tr.RPN_NEGATIVE_OVERLAP,
            allowed_border=tr.RPN_ALLOWED_BORDER,
            clobber_positives=tr.RPN_CLOBBER_POSITIVES,
            iou_bf16=tr.RPN_ASSIGN_IOU_BF16,
            fused=cfg.tpu.ASSIGN_FUSED, draws=draws, generator=generator)


def sample_targets(cfg: Config, rois, roi_valid, gt_boxes, gt_classes,
                   gt_valid, draws, generator) -> dict:
    """ProposalTarget (no gradient): the gt appended to ``rois``, then
    ``sample_rois`` with the TRAIN settings."""
    tr = cfg.TRAIN
    with torch.no_grad():
        return sample_rois(
            torch.cat([rois, gt_boxes], dim=1),
            torch.cat([roi_valid, gt_valid], dim=1),
            gt_boxes, gt_classes, gt_valid,
            num_classes=cfg.NUM_CLASSES, batch_rois=tr.BATCH_ROIS,
            fg_fraction=tr.FG_FRACTION, fg_thresh=tr.FG_THRESH,
            bg_thresh_hi=tr.BG_THRESH_HI, bg_thresh_lo=tr.BG_THRESH_LO,
            bbox_means=tr.BBOX_MEANS, bbox_stds=tr.BBOX_STDS,
            draws=draws, generator=generator)


def rpn_loss_terms(cfg: Config, rpn_cls, rpn_bbox, assign, b: int) -> dict:
    """The two RPN losses and the raw pieces of their metrics."""
    tr = cfg.TRAIN
    return {
        "rpn_cls_loss": L.softmax_ce_ignore(rpn_cls, assign["label"]),
        "rpn_bbox_loss": L.smooth_l1(rpn_bbox, assign["bbox_target"],
                                     assign["bbox_weight"], sigma=3.0,
                                     norm=float(tr.RPN_BATCH_SIZE) * b),
        "rpn_label": assign["label"],
        "rpn_pred": torch.argmax(rpn_cls.detach(), dim=-1),
    }


def rcnn_loss_terms(cfg: Config, cls_logits, bbox_out, tgt, b: int) -> dict:
    """The two R-CNN losses of the head's outputs on the sampled RoIs and
    the raw pieces of their metrics."""
    tr = cfg.TRAIN
    return {
        "rcnn_cls_loss": L.softmax_ce_weighted(cls_logits, tgt["label"],
                                               tgt["label_weight"]),
        "rcnn_bbox_loss": L.smooth_l1(bbox_out, tgt["bbox_target"],
                                      tgt["bbox_weight"], sigma=1.0,
                                      norm=float(tr.BATCH_ROIS) * b),
        "rcnn_label": tgt["label"],
        "rcnn_pred": torch.argmax(cls_logits.detach(), dim=-1),
        "rcnn_label_weight": tgt["label_weight"],
    }


class FasterRCNN(nn.Module):
    """Single-level Faster R-CNN with a ResNet-50/101/152 or VGG-16
    trunk."""

    def __init__(self, cfg: Config):
        super().__init__()
        net = cfg.network
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        if net.NETWORK.startswith("resnet"):
            self.backbone = ResNetConv(net.NETWORK, self.dtype)
            self.head_body = ResNetStage5(net.NETWORK, self.dtype)
            feat_ch, emb = 1024, 2048
            self._pooled = 14  # ROIAlign 14×14 → stage 5 stride 2 → 7×7
        elif net.NETWORK == "vgg16":
            self.backbone = VGGConv(self.dtype)
            self.head_body = VGGFC(self.dtype)
            feat_ch, emb = 512, 4096
            self._pooled = 7
        else:
            raise ValueError(f"unknown backbone {net.NETWORK}")
        self.rpn = RPNHead(feat_ch, net.NUM_ANCHORS, 512, self.dtype)
        self.rcnn_out = RCNNOutput(emb, cfg.NUM_CLASSES, self.dtype)
        self._anchors: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def _anchors_for(self, feat_h: int, feat_w: int,
                     device: torch.device) -> torch.Tensor:
        """All anchors of a feature shape, built in numpy once per shape."""
        key = (feat_h, feat_w, device)
        if key not in self._anchors:
            net = self.cfg.network
            base = generate_anchors(base_size=net.RPN_FEAT_STRIDE,
                                    ratios=net.ANCHOR_RATIOS,
                                    scales=net.ANCHOR_SCALES)
            self._anchors[key] = torch.from_numpy(all_anchors(
                feat_h, feat_w, net.RPN_FEAT_STRIDE, base)).to(device)
        return self._anchors[key]

    def _proposals(self, feat, im_info):
        te = self.cfg.TEST
        anchors = self._anchors_for(feat.shape[1], feat.shape[2], feat.device)
        rpn_cls, rpn_bbox = self.rpn(feat)
        return propose(fg_prob(rpn_cls), rpn_bbox, anchors,
                       im_info.to(torch.float32),
                       pre_nms_top_n=te.RPN_PRE_NMS_TOP_N,
                       post_nms_top_n=te.RPN_POST_NMS_TOP_N,
                       nms_thresh=te.RPN_NMS_THRESH, min_size=te.RPN_MIN_SIZE,
                       use_kernel=te.CXX_PROPOSAL)

    def _rcnn_head(self, feat, rois, deterministic: bool = True, keep=None,
                   generator: Optional[torch.Generator] = None):
        """feat (B, Hf, Wf, C); rois (B, R, 4) image frame → (B, R, K),
        (B, R, 4K) float32.  A VGG head body takes ``deterministic``
        (False in training: dropout on), ``keep`` (the ``(keep6, keep7)``
        masks, or ``None`` to draw them) and ``generator``."""
        pooled = roi_align(feat.to(self.dtype), rois,
                           spatial_scale=1.0 / self.cfg.network.RCNN_FEAT_STRIDE,
                           pooled_size=self._pooled,
                           sampling_ratio=self.cfg.tpu.ROI_SAMPLING_RATIO,
                           mode=self.cfg.tpu.ROI_MODE)
        if isinstance(self.head_body, VGGFC):
            emb = self.head_body(pooled, deterministic=deterministic,
                                 keep=keep, generator=generator)
        else:
            emb = self.head_body(pooled)
        return self.rcnn_out(emb)

    def _rcnn_losses(self, feat, tgt, b: int, draws: dict, generator) -> dict:
        """The R-CNN head on the sampled RoIs, in training (dropout on),
        and its two losses."""
        cls_logits, bbox_out = self._rcnn_head(
            feat, tgt["rois"], deterministic=False, keep=draws.get("dropout"),
            generator=generator)
        return rcnn_loss_terms(self.cfg, cls_logits, bbox_out, tgt, b)

    def forward(self, images, im_info, gt_boxes, gt_classes, gt_valid, *,
                draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None):
        """One training forward pass.

        Args:
          images: (B, H, W, 3|12) NHWC network input (after device prep).
          im_info: (B, 3) float32 (effective h, effective w, scale).
          gt_boxes: (B, G, 4) float32; gt_classes: (B, G) int;
            gt_valid: (B, G) bool.
          draws: optional ``{"rpn": (fg, bg), "rcnn": (fg, bg), "dropout":
            (keep6, keep7)}``: uniforms for ``assign_anchor`` ((B, N) each)
            and ``sample_rois`` ((B, post_nms + G) each), and a VGG head's
            bool keep masks ((B, BATCH_ROIS, 4096) each); each drawn from
            ``generator`` when absent.

        Returns ``(total_loss, aux)`` with the JAX package's keys: the four
        losses and the raw pieces of the six reference metrics.
        """
        tr = self.cfg.TRAIN
        b = images.shape[0]
        draws = draws or {}
        im_info = im_info.to(torch.float32)

        feat = self.backbone(images)
        anchors = self._anchors_for(feat.shape[1], feat.shape[2], feat.device)
        rpn_cls, rpn_bbox = self.rpn(feat)                 # (B, N, 2), (B, N, 4)
        assign = assign_targets(self.cfg, anchors, gt_boxes, gt_valid, im_info,
                                draws.get("rpn"), generator)
        with torch.no_grad():
            # the Proposal op: non-differentiable by contract
            rois, _, roi_valid = propose(
                fg_prob(rpn_cls), rpn_bbox, anchors, im_info,
                pre_nms_top_n=tr.RPN_PRE_NMS_TOP_N,
                post_nms_top_n=tr.RPN_POST_NMS_TOP_N,
                nms_thresh=tr.RPN_NMS_THRESH, min_size=tr.RPN_MIN_SIZE,
                use_kernel=tr.CXX_PROPOSAL)
        tgt = sample_targets(self.cfg, rois, roi_valid, gt_boxes, gt_classes,
                             gt_valid, draws.get("rcnn"), generator)
        aux = {**rpn_loss_terms(self.cfg, rpn_cls, rpn_bbox, assign, b),
               **self._rcnn_losses(feat, tgt, b, draws, generator)}
        total = (aux["rpn_cls_loss"] + aux["rpn_bbox_loss"]
                 + aux["rcnn_cls_loss"] + aux["rcnn_bbox_loss"])
        return total, aux

    def rpn_train(self, images, im_info, gt_boxes, gt_valid, *,
                  draws: Optional[dict] = None,
                  generator: Optional[torch.Generator] = None):
        """The RPN-only training graph (alternate training, stages 1 and
        4): body → RPN head → ``assign_anchor`` → the two RPN losses.
        ``draws``: optional ``{"rpn": (fg, bg)}``, each (B, N).  Returns
        ``(total_loss, aux)`` with the RPN keys of :meth:`forward`."""
        b = images.shape[0]
        im_info = im_info.to(torch.float32)
        feat = self.backbone(images)
        anchors = self._anchors_for(feat.shape[1], feat.shape[2], feat.device)
        rpn_cls, rpn_bbox = self.rpn(feat)
        assign = assign_targets(self.cfg, anchors, gt_boxes, gt_valid, im_info,
                                (draws or {}).get("rpn"), generator)
        aux = rpn_loss_terms(self.cfg, rpn_cls, rpn_bbox, assign, b)
        return aux["rpn_cls_loss"] + aux["rpn_bbox_loss"], aux

    def rcnn_train(self, images, im_info, rois, roi_valid, gt_boxes,
                   gt_classes, gt_valid, *, draws: Optional[dict] = None,
                   generator: Optional[torch.Generator] = None):
        """The Fast R-CNN training graph on given proposals (alternate
        training, stages 3 and 6): body → the gt appended to ``rois`` (B, P,
        4, scaled frame) → ``sample_rois`` → the R-CNN head → its two
        losses.  ``draws``: optional ``{"rcnn": (fg, bg), "dropout":
        (keep6, keep7)}``, the uniforms (B, P + G) each, the keep masks as
        in :meth:`forward`.  Returns ``(total_loss, aux)`` with the R-CNN
        keys of :meth:`forward`."""
        del im_info  # the RoIs arrive in the scaled frame
        b = images.shape[0]
        draws = draws or {}
        feat = self.backbone(images)
        tgt = sample_targets(self.cfg, rois.to(torch.float32), roi_valid,
                             gt_boxes, gt_classes, gt_valid,
                             draws.get("rcnn"), generator)
        aux = self._rcnn_losses(feat, tgt, b, draws, generator)
        return aux["rcnn_cls_loss"] + aux["rcnn_bbox_loss"], aux

    def predict(self, images, im_info):
        """Inference forward: NHWC images (B, H, W, 3|12), im_info (B, 3) →
        ``(rois, roi_valid, cls_prob, bbox_deltas, roi_scores)``; rois in
        the scaled image frame."""
        feat = self.backbone(images)
        rois, roi_scores, roi_valid = self._proposals(feat, im_info)
        cls_logits, bbox_deltas = self._rcnn_head(feat, rois)
        cls_prob = torch.softmax(cls_logits, dim=-1)
        return rois, roi_valid, cls_prob, bbox_deltas, roi_scores

    def predict_rpn(self, images, im_info):
        """RPN-only inference → ``(rois, roi_scores, roi_valid)``."""
        return self._proposals(self.backbone(images), im_info)


def build_model(cfg: Config) -> nn.Module:
    """``FasterRCNN``, or ``models/fpn.py:FPNFasterRCNN`` for the FPN and
    Mask R-CNN presets (``HAS_FPN``)."""
    if cfg.network.HAS_FPN:
        from mx_rcnn_tpu_torch.models.fpn import FPNFasterRCNN
        return FPNFasterRCNN(cfg)
    if cfg.network.HAS_MASK:
        raise ValueError("HAS_MASK needs HAS_FPN: the mask head pools from "
                         "the pyramid")
    return FasterRCNN(cfg)
