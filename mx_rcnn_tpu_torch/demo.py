"""Single-image demo (counterpart of the JAX package's ``demo.py``;
reference ``demo.py``), on the card unless given ``--device cpu``.

    python -m mx_rcnn_tpu_torch.demo --prefix model/e2e --epoch 10 \\
        --image photo.jpg
    python -m mx_rcnn_tpu_torch.demo --dataset coco --prefix model/e2e \\
        --epoch 6 --image photo.jpg --thresh 0.3

The image file (``data/image.py:get_image``) is staged into the
configured bucket on the host and prepped on the device, as serving does
(``Predictor.batch_put``) → the forward → the boxes mapped back to the
image (``im_detect``) → per class, the rows scoring above ``--thresh``
(default 0.5) through the host NMS (``ops/postprocess.py:per_class_nms``
with no per-image cap, on ``ops/nms.py:nms``, the native NMS's stable tie
order) → one log line a detection.  Class names are VOC's at 21
classes and ``class{i}`` otherwise.  ``--out`` (drawing the boxes) needs
cv2, which the port does not use, and raises.
"""

from __future__ import annotations

import argparse

from mx_rcnn_tpu_torch.data.image import get_image, stage_raw_to_bucket
from mx_rcnn_tpu_torch.data.pascal_voc import VOC_CLASSES
from mx_rcnn_tpu_torch.eval.tester import Predictor, im_detect, resolve_device
from mx_rcnn_tpu_torch.logger import logger, setup_logging
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.ops.postprocess import per_class_nms
from mx_rcnn_tpu_torch.tools.common import (add_common_args, config_from_args,
                                            load_eval_params)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Demo: detect one image "
                                     "(PyTorch port)")
    add_common_args(parser, train=False)
    parser.add_argument("--prefix", default="model/e2e",
                        help="checkpoint prefix: {prefix}-{epoch:04d}.npz")
    parser.add_argument("--epoch", type=int, default=10,
                        help="checkpoint epoch to load")
    parser.add_argument("--image", required=True)
    parser.add_argument("--out", default="",
                        help="write a drawing of the detections here (needs "
                             "cv2: not ported)")
    parser.add_argument("--thresh", type=float, default=0.5,
                        help="per-class score threshold")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; raises "
                             "without one)")
    return parser.parse_args(argv)


def demo_net(args) -> list:
    """Detect ``args.image`` → ``[(class name, (5,) float32 [x1, y1, x2,
    y2, score]), ...]``, class by class, each class's rows in the NMS's
    keep order."""
    setup_logging()
    if args.out:
        raise NotImplementedError("demo --out draws with cv2, which the "
                                  "port does not use; drawing is not ported")
    device = resolve_device(args.device)
    cfg = config_from_args(args, train=False)
    predictor = Predictor(build_model(cfg), load_eval_params(args), cfg,
                          device=device)

    stride = max(cfg.network.IMAGE_STRIDE, cfg.network.RPN_FEAT_STRIDE)
    staged, raw_hw, ratio, im_info = stage_raw_to_bucket(
        get_image(args.image), cfg.tpu.SCALES[0], stride)
    batch = predictor.batch_put({
        "images": staged[None], "raw_hw": raw_hw[None],
        "prep_ratio": ratio[None], "im_info": im_info[None]})
    (scores, boxes, valid), = im_detect(predictor, batch)

    if cfg.NUM_CLASSES == len(VOC_CLASSES):
        classes = list(VOC_CLASSES)
    else:
        classes = [f"class{i}" for i in range(cfg.NUM_CLASSES)]

    all_dets = []
    per_class = per_class_nms(scores, boxes, valid, cfg.NUM_CLASSES,
                              args.thresh, cfg.TEST.NMS, 0)
    for k in range(1, cfg.NUM_CLASSES):
        for d in per_class[k]:
            all_dets.append((classes[k], d))
            logger.info("%s: %.3f at [%.1f, %.1f, %.1f, %.1f]",
                        classes[k], d[4], *d[:4])
    return all_dets


if __name__ == "__main__":
    demo_net(parse_args())
