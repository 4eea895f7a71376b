"""End-to-end Faster R-CNN training (counterpart of the JAX package's
``train_end2end.py``), on the card unless given ``--device cpu``.

    python -m mx_rcnn_tpu_torch.train_end2end --synthetic --num-steps 5
    python -m mx_rcnn_tpu_torch.train_end2end --image_set 2007_trainval \\
        --dataset_path data/VOCdevkit --pretrained model/resnet101.npz

generate_config (+ ``--cfg PATH=VALUE`` overrides, ``--lr``,
``--lr_step``, ``--no_flip``, ``--no_shuffle``, ``--loader-workers``,
``--prefetch``) → the dataset
(``tools/common.py:get_imdb``: PASCAL VOC read from disk, or the synthetic
imdb with ``--synthetic``) → flip → filter → ``AnchorLoader`` of
``--batch_images`` (default ``TRAIN.BATCH_IMAGES``) → seeded random
weights in the JAX layout with the ``--pretrained`` ``.npz`` laid over
them (``tools/common.py:init_or_load_params``) → ``fit`` over epochs
``--begin_epoch`` … ``--end_epoch − 1``, with an epoch checkpoint
``{prefix}-{epoch:04d}.npz`` that ``eval/tester.py:Predictor`` loads.
``--synthetic`` sets ``PIXEL_STDS=127`` as the JAX driver does: random
weights cannot absorb the raw 0..255 pixel scale.

A run that survives interruption (``train/resilience.py``)::

    python -m mx_rcnn_tpu_torch.train_end2end ... --prefix model/e2e \
        --save-every-n-steps 500 --auto-resume --nan-policy skip

writes a step checkpoint every 500 steps under ``model/e2e-steps/``, saves
one more and exits 0 on SIGTERM, and when rerun with the same command
continues from the latest checkpoint, the loader fast-forwarded to the
batch.  ``--resume --begin_epoch E`` continues from epoch ``E``'s
checkpoint.
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


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train Faster R-CNN end2end "
                                 "(PyTorch port)")
    add_common_args(ap, train=True)
    return ap.parse_args(argv)


def train_net(args):
    setup_logging()
    device = resolve_device(args.device)
    cfg = config_from_args(args, train=True)
    imdb = get_imdb(args, cfg)
    roidb = get_train_roidb(imdb, cfg)
    batch_size = args.batch_images or cfg.TRAIN.BATCH_IMAGES
    loader = cap_steps(AnchorLoader(roidb, cfg, batch_size,
                                    shuffle=cfg.TRAIN.SHUFFLE), args)
    logger.info("training on %d images, %d steps/epoch, batch %d, on %s",
                len(roidb), loader.steps_per_epoch, batch_size, device)
    model = build_model(cfg)
    params = init_or_load_params(args, model)
    try:
        return fit(cfg, model, params, loader, begin_epoch=args.begin_epoch,
                   end_epoch=args.end_epoch, prefix=args.prefix,
                   seed=args.seed, frequent=args.frequent, device=device,
                   resume=args.resume,
                   resilience=ResilienceOptions.from_args(args))
    finally:
        loader.close_workers()


if __name__ == "__main__":
    train_net(parse_args())
