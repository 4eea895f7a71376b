"""4-step alternate Faster R-CNN training (counterpart of the JAX
package's ``train_alternate.py``; reference ``train_alternate.py``), on the
card unless given ``--device cpu``.

    python -m mx_rcnn_tpu_torch.train_alternate --synthetic --num-steps 5 \\
        --pretrained model/resnet101.npz --end_epoch 1

1. train the RPN from the initial weights (``tools/train_rpn.py``);
2. proposals of every training record from it (``tools/test_rpn.py``);
3. train Fast R-CNN on them from the initial weights
   (``tools/train_rcnn.py``);
4. train the RPN again from stage 3's weights, ``FIXED_PARAMS_SHARED``
   frozen;
5. proposals again, from stage 4;
6. train Fast R-CNN again from stage 4's weights, ``FIXED_PARAMS_SHARED``
   frozen;
7. ``utils/combine_model.py``: stage 4's backbone, FPN neck and RPN with
   stage 6's head.

An FPN network (``--network resnet101_fpn``) runs the same stages on its
pyramid graphs, its ``FIXED_PARAMS_SHARED`` freezing the neck's
``lateral``/``post`` convs in stages 4 and 6.

The stages run in one process and hand each other their weights, as the
JAX driver does; ``--loader-workers`` and ``--prefetch`` reach every
stage's loader through the config; they write no checkpoints (``--rpn_epochs`` and
``--rcnn_epochs`` set their lengths, default ``--end_epoch``), so the
training drivers' ``--resume``, ``--auto-resume``, ``--save-every-n-steps``
and ``--nan-policy rollback`` are refused; ``--nan-policy halt`` and
``skip`` act in every training stage.  The final
model is saved de-normalised as the port's flat ``{prefix}-{end_epoch:04d}
.npz``, which ``python -m mx_rcnn_tpu_torch.test --epoch end_epoch`` loads;
the JAX driver saves it through orbax's ``CheckpointManager``, which is not
ported (ROADMAP.md A.5.3).  Mask configs raise before any stage runs,
with the JAX driver's message: the alternate graphs have no mask targets.
"""

from __future__ import annotations

import argparse

from mx_rcnn_tpu_torch.eval.tester import resolve_device
from mx_rcnn_tpu_torch.logger import logger, setup_logging
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.models.fpn import NO_MASK_ALTERNATE
from mx_rcnn_tpu_torch.tools.common import (add_common_args, config_from_args,
                                            get_imdb, get_train_roidb,
                                            init_or_load_params)
from mx_rcnn_tpu_torch.tools.test_rpn import test_rpn
from mx_rcnn_tpu_torch.tools.train_rcnn import train_rcnn
from mx_rcnn_tpu_torch.tools.train_rpn import train_rpn
from mx_rcnn_tpu_torch.train.checkpoint import (denormalize_for_save,
                                                epoch_path, save_params_npz)
from mx_rcnn_tpu_torch.utils.combine_model import combine_model
from mx_rcnn_tpu_torch.utils.convert_jax import Params, export_jax_params


def checkpoint_flags(args) -> list:
    """The flags of ``args`` that need checkpoints, which no stage writes."""
    return [flag for flag, on in (
        ("--resume", args.resume),
        ("--auto-resume", args.auto_resume),
        ("--save-every-n-steps", args.save_every_n_steps > 0),
        ("--nan-policy rollback", args.nan_policy == "rollback")) if on]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train Faster R-CNN "
                                     "alternately (PyTorch port)")
    add_common_args(parser, train=True)
    parser.add_argument("--rpn_epochs", type=int, default=None,
                        help="epochs per RPN stage (default: end_epoch)")
    parser.add_argument("--rcnn_epochs", type=int, default=None,
                        help="epochs per R-CNN stage (default: end_epoch)")
    args = parser.parse_args(argv)
    bad = checkpoint_flags(args)
    if bad:
        parser.error(f"{', '.join(bad)}: the alternate stages write no "
                     f"checkpoints")
    return args


def alternate_train(args) -> Params:
    """The seven stages → the combined flat parameters (the training
    parametrisation), also saved de-normalised under ``--prefix``."""
    setup_logging()
    resolve_device(args.device)  # raise before any work without a card
    bad = checkpoint_flags(args)
    if bad:
        raise ValueError(f"{', '.join(bad)}: the alternate stages write no "
                         f"checkpoints")
    cfg = config_from_args(args, train=True)
    if cfg.network.HAS_MASK:
        raise NotImplementedError(NO_MASK_ALTERNATE)
    imdb = get_imdb(args, cfg)
    roidb = get_train_roidb(imdb, cfg)
    params = init_or_load_params(args, build_model(cfg))
    rpn_ep = args.rpn_epochs or args.end_epoch
    rcnn_ep = args.rcnn_epochs or args.end_epoch

    def stage_args(end_epoch):
        a = argparse.Namespace(**vars(args))
        a.begin_epoch, a.end_epoch, a.prefix = 0, end_epoch, None
        return a

    def trained(state) -> Params:
        return export_jax_params(state.model)

    logger.info("=== stage 1: train RPN ===")
    s1 = trained(train_rpn(stage_args(rpn_ep), cfg=cfg, params=params,
                           roidb=roidb))
    logger.info("=== stage 2: generate proposals ===")
    roidb = test_rpn(args, cfg=cfg, params=s1, imdb=imdb, roidb=roidb)
    del s1
    logger.info("=== stage 3: train RCNN on proposals ===")
    s3 = trained(train_rcnn(stage_args(rcnn_ep), cfg=cfg, params=params,
                            roidb=roidb))
    logger.info("=== stage 4: train RPN round 2 (shared conv frozen) ===")
    s4 = trained(train_rpn(stage_args(rpn_ep), cfg=cfg, params=s3,
                           roidb=roidb, frozen_shared=True))
    del s3
    logger.info("=== stage 5: proposals round 2 ===")
    roidb = test_rpn(args, cfg=cfg, params=s4, imdb=imdb, roidb=roidb)
    logger.info("=== stage 6: train RCNN round 2 (shared conv frozen) ===")
    s6 = trained(train_rcnn(stage_args(rcnn_ep), cfg=cfg, params=s4,
                            roidb=roidb, frozen_shared=True))
    logger.info("=== stage 7: combine_model ===")
    final = combine_model(s4, s6)
    path = epoch_path(args.prefix, args.end_epoch)
    save_params_npz(path, denormalize_for_save(final, cfg))
    logger.info("combined checkpoint saved to %s", path)
    return final


if __name__ == "__main__":
    alternate_train(parse_args())
