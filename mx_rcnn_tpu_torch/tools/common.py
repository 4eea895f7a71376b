"""Shared driver plumbing (counterpart of ``mx_rcnn_tpu/tools/common.py``:
``parse_cfg_overrides``, ``config_from_args``, ``get_imdb``,
``get_train_roidb``, ``load_eval_params``).

The dataset factory covers PASCAL VOC and the synthetic dataset; COCO
raises until its reader is ported.  Checkpoints are the port's flat
``{prefix}-{epoch:04d}.npz`` (``train/checkpoint.py``), de-normalized, as
``train_end2end`` writes them.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses

from mx_rcnn_tpu_torch.config import (Config, generate_config, list_datasets,
                                      list_networks)
from mx_rcnn_tpu_torch.data.pascal_voc import PascalVOC
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.train.checkpoint import epoch_path, load_params_npz


def add_common_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags every driver of the port shares (the JAX drivers' names)."""
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
    return parser


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
    """generate_config + ``--cfg`` overrides; ``--image_set`` lands on
    IMAGE_SET for training and TEST_IMAGE_SET for evaluation;
    ``--synthetic`` sets ``PIXEL_STDS=127`` (random weights cannot absorb
    the raw 0..255 pixel scale)."""
    cfg = generate_config(args.network, args.dataset,
                          **parse_cfg_overrides(args.cfg))
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
        raise NotImplementedError("the COCO reader is not ported yet "
                                  "(ROADMAP.md A.5.4)")
    raise KeyError(name)


def get_train_roidb(imdb, cfg: Config, roidb=None) -> list:
    """gt (or a given roidb) → flipped copies when ``TRAIN.FLIP`` → records
    without gt dropped."""
    if roidb is None:
        roidb = imdb.gt_roidb()
    if cfg.TRAIN.FLIP:
        roidb = imdb.append_flipped_images(roidb)
    return imdb.filter_roidb(roidb)


def load_eval_params(args) -> dict:
    """The de-normalized flat parameters of epoch ``args.epoch`` under
    ``args.prefix`` (``{prefix}-{epoch:04d}.npz``)."""
    return load_params_npz(epoch_path(args.prefix, args.epoch))
