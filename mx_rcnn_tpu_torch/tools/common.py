"""Shared driver plumbing (counterpart of ``mx_rcnn_tpu/tools/common.py``:
``add_common_args``, ``parse_cfg_overrides``, ``config_from_args``,
``get_imdb``, ``get_train_roidb``, ``init_or_load_params``,
``CappedLoader``, ``load_eval_params``).

The dataset factory covers PASCAL VOC, COCO (``data/coco_dataset.py``,
box evaluation) and the synthetic dataset.  Checkpoints are the port's flat
``{prefix}-{epoch:04d}.npz`` (``train/checkpoint.py``), de-normalized, as
``train_end2end`` writes them.  ``--loader-workers`` (every driver) and
``--prefetch`` (the training drivers, ``test`` and ``tools/test_rpn``)
set ``tpu.LOADER_WORKERS`` and ``tpu.PREFETCH``.  The training drivers
take ``--resume`` and the fault-tolerance flags ``--save-every-n-steps``,
``--auto-resume`` and ``--nan-policy`` (``train/resilience.py``), and
``get_train_roidb`` applies ``MXR_FAULT_BAD_RECORD``.  Not ported among
the training flags: ``--dist-*``, ``--obs-port``, ``--steps-per-dispatch``,
``--tuned-pipeline``, ``--replay-*`` and ``--device-prep``.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os

import numpy as np

from mx_rcnn_tpu_torch.config import (Config, generate_config, list_datasets,
                                      list_networks)
from mx_rcnn_tpu_torch.data.coco_dataset import COCODataset
from mx_rcnn_tpu_torch.data.pascal_voc import PascalVOC
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.logger import logger
from mx_rcnn_tpu_torch.train.checkpoint import epoch_path, load_params_npz
from mx_rcnn_tpu_torch.train.resilience import (add_resilience_args,
                                                inject_roidb_faults)
from mx_rcnn_tpu_torch.utils.convert_jax import Params, random_params


def add_common_args(parser: argparse.ArgumentParser,
                    train: bool = True) -> argparse.ArgumentParser:
    """The flags every driver of the port shares (the JAX drivers' names),
    and with ``train`` those of the training drivers."""
    parser.add_argument("--network", default="resnet101",
                        choices=list_networks())
    parser.add_argument("--dataset", default="PascalVOC",
                        choices=list_datasets())
    parser.add_argument("--image_set", default=None,
                        help="override the preset image set")
    parser.add_argument("--root_path", default="data",
                        help="cache directory root (root_path/cache)")
    parser.add_argument("--dataset_path", default=None,
                        help="dataset location (default: the preset's)")
    parser.add_argument("--synthetic", action="store_true",
                        help="use the synthetic dataset (no files needed)")
    parser.add_argument("--synthetic_images", type=int, default=64)
    parser.add_argument("--cfg", action="append", default=[],
                        metavar="PATH=VALUE",
                        help="config override, repeatable: double-underscore "
                             "paths with python-literal values (e.g. --cfg "
                             "tpu__SCALES='((128,192),)')")
    parser.add_argument("--loader-workers", type=int, default=None,
                        dest="loader_workers", metavar="N",
                        help="input-pipeline worker processes "
                             "(tpu.LOADER_WORKERS, data/workers.py): N > 0 "
                             "loads records in N processes over a "
                             "shared-memory ring in /dev/shm, batches "
                             "bit-identical to the serial producer (0); "
                             "serving: the request staging pool")
    if not train:
        return parser
    add_prefetch_arg(parser)
    parser.add_argument("--prefix", default="model/e2e",
                        help="checkpoint prefix: {prefix}-{epoch:04d}.npz")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; raises "
                             "without one)")
    parser.add_argument("--pretrained", default="",
                        help="flat .npz of initial weights (either "
                             "package's layout): each leaf whose key and "
                             "shape match replaces the seeded random one")
    parser.add_argument("--pretrained_epoch", type=int, default=0,
                        help="accepted for the reference's command lines; "
                             "unused")
    parser.add_argument("--begin_epoch", type=int, default=0)
    parser.add_argument("--end_epoch", type=int, default=10)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--lr_step", default=None,
                        help="comma-separated epochs, e.g. '7'")
    parser.add_argument("--frequent", type=int, default=20,
                        help="fetch and log the metrics every N steps")
    parser.add_argument("--no_flip", action="store_true")
    parser.add_argument("--no_shuffle", action="store_true")
    parser.add_argument("--resume", action="store_true",
                        help="continue from epoch --begin_epoch's checkpoint "
                             "under --prefix: parameters, momentum, step "
                             "and sampling generator")
    parser.add_argument("--batch_images", type=int, default=None,
                        help="images per step (default "
                             "TRAIN.BATCH_IMAGES)")
    parser.add_argument("--seed", type=int, default=0,
                        help="weights and sampling seed; the loader "
                             "shuffles with its own")
    parser.add_argument("--num-steps", type=int, default=0, dest="num_steps",
                        help="cap steps per epoch (smoke runs)")
    add_resilience_args(parser)
    return parser


def add_prefetch_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--prefetch", type=int, default=None,
                        metavar="DEPTH",
                        help="batches the loader's prefetch thread keeps "
                             "ready (tpu.PREFETCH); the default 0 loads on "
                             "the consuming thread, which measured faster "
                             "on the card with the numpy PNG decode")


def parse_cfg_overrides(items) -> dict:
    """``--cfg PATH=VALUE`` (python literals) → overrides dict."""
    overrides = {}
    for item in items or []:
        key, sep, val = item.partition("=")
        if not sep:
            raise ValueError(f"--cfg expects PATH=VALUE, got {item!r}")
        overrides[key] = ast.literal_eval(val)
    return overrides


def config_from_args(args, train: bool = True) -> Config:
    """generate_config + ``--cfg`` overrides, ``--loader-workers`` and
    ``--prefetch``, and for training ``--lr``, ``--lr_step``,
    ``--no_flip`` and ``--no_shuffle``; ``--image_set``
    lands on IMAGE_SET for training and TEST_IMAGE_SET for evaluation;
    ``--synthetic`` sets ``PIXEL_STDS=127`` (random weights cannot absorb
    the raw 0..255 pixel scale)."""
    overrides = parse_cfg_overrides(args.cfg)
    if getattr(args, "loader_workers", None) is not None:
        overrides["tpu__LOADER_WORKERS"] = int(args.loader_workers)
    if getattr(args, "prefetch", None) is not None:
        overrides["tpu__PREFETCH"] = int(args.prefetch)
    if train:
        if args.lr is not None:
            overrides["TRAIN__LR"] = args.lr
        if args.lr_step is not None:
            overrides["TRAIN__LR_STEP"] = tuple(
                int(e) for e in str(args.lr_step).split(","))
        if args.no_flip:
            overrides["TRAIN__FLIP"] = False
        if args.no_shuffle:
            overrides["TRAIN__SHUFFLE"] = False
    cfg = generate_config(args.network, args.dataset, **overrides)
    if getattr(args, "image_set", None):
        field = "IMAGE_SET" if train else "TEST_IMAGE_SET"
        cfg = cfg.replace(dataset=dataclasses.replace(
            cfg.dataset, **{field: args.image_set}))
    if getattr(args, "dataset_path", None):
        cfg = cfg.replace(dataset=dataclasses.replace(
            cfg.dataset, DATASET_PATH=args.dataset_path))
    if args.synthetic:
        cfg = cfg.replace(network=dataclasses.replace(
            cfg.network, PIXEL_STDS=(127.0, 127.0, 127.0)))
    return cfg


def get_imdb(args, cfg: Config, test: bool = False):
    """The dataset of a driver: synthetic, or the config's dataset on its
    training or test image set."""
    if args.synthetic:
        s = cfg.tpu.SCALES[0]
        return SyntheticDataset(num_images=args.synthetic_images,
                                num_classes=cfg.NUM_CLASSES, height=s[0],
                                width=s[1])
    name = cfg.dataset.DATASET
    image_set = cfg.dataset.TEST_IMAGE_SET if test else cfg.dataset.IMAGE_SET
    if name == "PascalVOC":
        return PascalVOC(image_set, args.root_path, cfg.dataset.DATASET_PATH)
    if name == "coco":
        return COCODataset(image_set, args.root_path, cfg.dataset.DATASET_PATH)
    raise KeyError(name)


def get_train_roidb(imdb, cfg: Config, roidb=None) -> list:
    """gt (or a given roidb) → flipped copies when ``TRAIN.FLIP`` → records
    without gt dropped → the records ``MXR_FAULT_BAD_RECORD`` names
    corrupted (``train/resilience.py:inject_roidb_faults``; after the
    filter, so that they reach the epoch plan)."""
    if roidb is None:
        roidb = imdb.gt_roidb()
    if cfg.TRAIN.FLIP:
        roidb = imdb.append_flipped_images(roidb)
    return inject_roidb_faults(imdb.filter_roidb(roidb))


def init_or_load_params(args, model) -> Params:
    """Seeded random weights for ``model`` (``random_params`` with
    ``args.seed``), then each leaf of ``--pretrained`` whose key and shape
    match (:func:`_overlay`).  The file's weights are taken as they are,
    not re-normalised.  Raises ``FileNotFoundError`` for a missing
    file."""
    params = random_params(model, seed=args.seed)
    path = args.pretrained
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        params = _overlay(params, load_params_npz(path))
        logger.info("loaded pretrained params from %s", path)
    return params


def _overlay(params: Params, loaded: Params) -> Params:
    """``params`` with each leaf of ``loaded`` whose key and shape match;
    a key of a different shape keeps its initial leaf, with a warning, and
    keys the model does not have are ignored."""
    out = {}
    for k, v in params.items():
        if k in loaded and np.shape(loaded[k]) == np.shape(v):
            out[k] = np.asarray(loaded[k])
        else:
            if k in loaded:
                logger.warning("shape mismatch at %s: %s vs %s — kept init",
                               k, np.shape(loaded[k]), np.shape(v))
            out[k] = v
    return out


class CappedLoader:
    """At most ``n`` batches per epoch of the wrapped loader.  The ``put``
    hook and ``close_workers`` reach the wrapped loader,
    and the wrapped epoch is closed where the cap stops it, so that its
    prefetch thread and worker tickets end with it.

    ``advance_epochs`` and ``skip_next`` (the fast-forward of a resume)
    reach the wrapped loader too, as the JAX package's ``CappedLoader``
    forwards them: a skip of ``m`` batches shrinks the next epoch to
    ``n − m`` batches, so that it ends where the uninterrupted capped
    epoch ends."""

    def __init__(self, inner, n: int):
        self._inner = inner
        self._n = n
        self._skip = 0
        self.batch_size = inner.batch_size

    @property
    def steps_per_epoch(self) -> int:
        return min(self._n, self._inner.steps_per_epoch)

    def advance_epochs(self, n: int) -> None:
        self._inner.advance_epochs(n)

    def skip_next(self, m: int) -> None:
        self._inner.skip_next(m)
        self._skip = m

    @property
    def put(self):
        return self._inner.put

    @put.setter
    def put(self, v):
        self._inner.put = v

    def close_workers(self):
        close = getattr(self._inner, "close_workers", None)
        if close is not None:
            close()

    def __iter__(self):
        skip, self._skip = self._skip, 0
        it = iter(self._inner)
        try:
            for _ in range(max(self.steps_per_epoch - skip, 0)):
                try:
                    yield next(it)
                except StopIteration:
                    return
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()


def cap_steps(loader, args):
    """``loader`` capped at ``--num-steps`` batches an epoch when set."""
    return CappedLoader(loader, args.num_steps) if args.num_steps else loader


def load_eval_params(args) -> dict:
    """The de-normalized flat parameters of epoch ``args.epoch`` under
    ``args.prefix`` (``{prefix}-{epoch:04d}.npz``)."""
    return load_params_npz(epoch_path(args.prefix, args.epoch))
