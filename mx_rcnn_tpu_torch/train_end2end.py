"""End-to-end Faster R-CNN training (counterpart of the JAX package's
``train_end2end.py``), on the card unless given ``--device cpu``.

    python -m mx_rcnn_tpu_torch.train_end2end --synthetic --num-steps 5
    python -m mx_rcnn_tpu_torch.train_end2end --image_set 2007_trainval \
        --dataset_path data/VOCdevkit

generate_config (+ ``--cfg PATH=VALUE`` overrides) → the dataset
(``tools/common.py:get_imdb``: PASCAL VOC read from disk, or the synthetic
imdb with ``--synthetic``) → flip → filter → ``AnchorLoader`` → seeded
random weights in the JAX layout
(``utils/convert_jax.py:random_params``) → ``fit``, with an epoch
checkpoint ``{prefix}-{epoch:04d}.npz`` that ``eval/tester.py:Predictor``
loads.  ``--synthetic`` sets ``PIXEL_STDS=127`` as the JAX driver does:
random weights cannot absorb the raw 0..255 pixel scale.
"""

from __future__ import annotations

import argparse
import os

from mx_rcnn_tpu_torch.data.loader import AnchorLoader
from mx_rcnn_tpu_torch.eval.tester import resolve_device
from mx_rcnn_tpu_torch.logger import logger, setup_logging
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.tools.common import (add_common_args, config_from_args,
                                            get_imdb, get_train_roidb)
from mx_rcnn_tpu_torch.train.trainer import fit
from mx_rcnn_tpu_torch.utils.convert_jax import random_params


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train Faster R-CNN end2end "
                                 "(PyTorch port)")
    add_common_args(ap)
    ap.add_argument("--num-steps", type=int, default=0, dest="num_steps",
                    help="cap steps per epoch (smoke runs)")
    ap.add_argument("--end_epoch", type=int, default=10)
    ap.add_argument("--prefix", default="model/e2e",
                    help="checkpoint prefix: {prefix}-{epoch:04d}.npz")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights and sampling seed; the loader shuffles "
                         "with its own")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    return ap.parse_args(argv)


class CappedLoader:
    """At most ``n`` batches per epoch of the wrapped loader."""

    def __init__(self, inner, n: int):
        self._inner = inner
        self._n = n
        self.batch_size = inner.batch_size

    @property
    def steps_per_epoch(self) -> int:
        return min(self._n, self._inner.steps_per_epoch)

    def __iter__(self):
        for _, batch in zip(range(self.steps_per_epoch), self._inner):
            yield batch


def train_net(args):
    setup_logging()
    device = resolve_device(args.device)
    cfg = config_from_args(args, train=True)
    imdb = get_imdb(args, cfg)
    roidb = get_train_roidb(imdb, cfg)
    batch_size = cfg.TRAIN.BATCH_IMAGES
    loader = AnchorLoader(roidb, cfg, batch_size, shuffle=cfg.TRAIN.SHUFFLE)
    if args.num_steps:
        loader = CappedLoader(loader, args.num_steps)
    logger.info("training on %d images, %d steps/epoch, batch %d, on %s",
                len(roidb), loader.steps_per_epoch, batch_size, device)
    model = build_model(cfg)
    params = random_params(model, seed=args.seed)
    if os.path.dirname(args.prefix):
        os.makedirs(os.path.dirname(args.prefix), exist_ok=True)
    return fit(cfg, model, params, loader, end_epoch=args.end_epoch,
               prefix=args.prefix, seed=args.seed, device=device)


if __name__ == "__main__":
    train_net(parse_args())
