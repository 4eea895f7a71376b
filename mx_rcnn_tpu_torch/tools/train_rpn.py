"""Stage tool: RPN-only training (counterpart of
``mx_rcnn_tpu/tools/train_rpn.py``; reference ``rcnn/tools/train_rpn.py``,
alternate training stages 1 and 4), on the card unless given ``--device
cpu``.

    python -m mx_rcnn_tpu_torch.tools.train_rpn --synthetic --num-steps 5

The loader is end2end's ``AnchorLoader``; the graph is
``FasterRCNN.rpn_train``, or ``FPNFasterRCNN.rpn_train`` over the pyramid
for an FPN network (body, RPN head, the RPN losses; the assign kernels
when ``tpu.ASSIGN_FUSED``).  With ``--prefix`` every epoch writes
``{prefix}-{epoch:04d}.npz``.  ``--loader-workers`` and ``--prefetch``
shape the loader (``data/loader.py``); its workers end with the stage.
"""

from __future__ import annotations

import argparse

from mx_rcnn_tpu_torch.data.loader import AnchorLoader
from mx_rcnn_tpu_torch.eval.tester import resolve_device
from mx_rcnn_tpu_torch.logger import logger, setup_logging
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.tools.common import (add_common_args, cap_steps,
                                            config_from_args, get_imdb,
                                            get_train_roidb,
                                            init_or_load_params)
from mx_rcnn_tpu_torch.train.resilience import ResilienceOptions
from mx_rcnn_tpu_torch.train.trainer import fit


def train_rpn(args, cfg=None, params=None, roidb=None,
              frozen_shared: bool = False):
    """Train the RPN from ``params`` (default: ``--pretrained`` over seeded
    random weights) on ``roidb`` (default: the flipped, filtered training
    set) → ``fit``'s ``TrainState``.  ``frozen_shared`` freezes
    ``FIXED_PARAMS_SHARED`` (stage 4) instead of ``FIXED_PARAMS``."""
    setup_logging()
    device = resolve_device(args.device)
    cfg = cfg or config_from_args(args, train=True)
    batch_size = args.batch_images or cfg.TRAIN.BATCH_IMAGES
    if roidb is None:
        roidb = get_train_roidb(get_imdb(args, cfg), cfg)
    loader = cap_steps(AnchorLoader(roidb, cfg, batch_size,
                                    shuffle=cfg.TRAIN.SHUFFLE), args)
    model = build_model(cfg)
    if params is None:
        params = init_or_load_params(args, model)
    fixed = (cfg.network.FIXED_PARAMS_SHARED if frozen_shared
             else cfg.network.FIXED_PARAMS)
    logger.info("train_rpn: %d images, frozen=%s", len(roidb), fixed)
    try:
        return fit(cfg, model, params, loader, begin_epoch=args.begin_epoch,
                   end_epoch=args.end_epoch, prefix=args.prefix, graph="rpn",
                   seed=args.seed, frequent=args.frequent, device=device,
                   fixed_prefixes=fixed, resume=getattr(args, "resume", False),
                   resilience=ResilienceOptions.from_args(args))
    finally:
        loader.close_workers()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train the RPN "
                                     "(PyTorch port)")
    add_common_args(parser, train=True)
    return parser.parse_args(argv)


if __name__ == "__main__":
    train_rpn(parse_args())
