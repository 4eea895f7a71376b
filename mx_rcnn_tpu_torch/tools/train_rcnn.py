"""Stage tool: Fast R-CNN training on cached proposals (counterpart of
``mx_rcnn_tpu/tools/train_rcnn.py``; reference
``rcnn/tools/train_rcnn.py``, alternate training stages 3 and 6), on the
card unless given ``--device cpu``.

    python -m mx_rcnn_tpu_torch.tools.train_rcnn --synthetic \\
        --proposals data/cache/synthetic_n64_rpn_proposals.pkl

``--proposals`` names a ``test_rpn`` cache (aligned with the gt roidb);
it is attached before the flip, which mirrors it.  ``ROIIter`` ships the
proposals, and ``FasterRCNN.rcnn_train`` (``FPNFasterRCNN.rcnn_train`` for
an FPN network; a mask network raises) samples the RoIs on the device.
Selective-search proposals are not ported.  With ``--prefix`` every epoch
writes ``{prefix}-{epoch:04d}.npz``.  ``--loader-workers`` and
``--prefetch`` shape the loader; its workers end with the stage.
"""

from __future__ import annotations

import argparse

from mx_rcnn_tpu_torch.data.loader import ROIIter
from mx_rcnn_tpu_torch.eval.tester import resolve_device
from mx_rcnn_tpu_torch.logger import logger, setup_logging
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.tools.common import (add_common_args, cap_steps,
                                            config_from_args, get_imdb,
                                            get_train_roidb,
                                            init_or_load_params)
from mx_rcnn_tpu_torch.train.resilience import ResilienceOptions
from mx_rcnn_tpu_torch.train.trainer import fit
from mx_rcnn_tpu_torch.utils.load_data import load_proposals


def train_rcnn(args, cfg=None, params=None, roidb=None,
               frozen_shared: bool = False):
    """Train the R-CNN head from ``params`` (default: ``--pretrained`` over
    seeded random weights) on ``roidb`` (default: the gt roidb with
    ``--proposals`` attached, flipped, filtered) → ``fit``'s
    ``TrainState``.  Raises ``ValueError`` when no record has proposals.
    ``frozen_shared`` freezes ``FIXED_PARAMS_SHARED`` (stage 6)."""
    setup_logging()
    device = resolve_device(args.device)
    cfg = cfg or config_from_args(args, train=True)
    batch_size = args.batch_images or cfg.TRAIN.BATCH_IMAGES
    if roidb is None:
        imdb = get_imdb(args, cfg)
        source = getattr(args, "proposals", "")
        base = None
        if source == "selective_search":
            raise NotImplementedError(
                "--proposals selective_search: selective-search proposals "
                "are not ported (ROADMAP.md A.5); pass a test_rpn .pkl")
        if source:
            base = load_proposals(imdb.gt_roidb(), source)
        roidb = get_train_roidb(imdb, cfg, roidb=base)
    if not any("proposals" in r for r in roidb):
        raise ValueError("roidb has no cached proposals — run test_rpn, or "
                         "pass --proposals <cache.pkl>")
    loader = cap_steps(ROIIter(roidb, cfg, batch_size,
                               shuffle=cfg.TRAIN.SHUFFLE), args)
    model = build_model(cfg)
    if params is None:
        params = init_or_load_params(args, model)
    fixed = (cfg.network.FIXED_PARAMS_SHARED if frozen_shared
             else cfg.network.FIXED_PARAMS)
    logger.info("train_rcnn: %d images, frozen=%s", len(roidb), fixed)
    try:
        return fit(cfg, model, params, loader, begin_epoch=args.begin_epoch,
                   end_epoch=args.end_epoch, prefix=args.prefix,
                   graph="rcnn", seed=args.seed, frequent=args.frequent,
                   device=device, fixed_prefixes=fixed,
                   resume=getattr(args, "resume", False),
                   resilience=ResilienceOptions.from_args(args))
    finally:
        loader.close_workers()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train Fast R-CNN on "
                                     "proposals (PyTorch port)")
    add_common_args(parser, train=True)
    parser.add_argument("--proposals", default="",
                        help="a test_rpn .pkl cache path; default expects "
                             "proposals already in the roidb")
    return parser.parse_args(argv)


if __name__ == "__main__":
    train_rcnn(parse_args())
