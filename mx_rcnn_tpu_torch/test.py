"""Detection evaluation driver (counterpart of the JAX package's
``test.py:test_rcnn``), on the card unless given ``--device cpu``.

    python -m mx_rcnn_tpu_torch.test --prefix model/e2e --epoch 10 \\
        --image_set 2007_test --dataset_path data/VOCdevkit

config (+ ``--cfg`` overrides) → ``PascalVOC`` (or ``--synthetic``) →
``TestLoader`` (``--prefetch`` batches ahead on its thread, default 0) →
``Predictor`` on the checkpoint ``{prefix}-{epoch:04d}
.npz`` → ``pred_eval`` (host or ``--device-postprocess`` route, serial
with ``--eval-inflight 0`` or overlapped) → per-class AP and mAP.  Flags
of the JAX driver whose machinery is not ported raise by name.
"""

from __future__ import annotations

import argparse

from mx_rcnn_tpu_torch.data.loader import TestLoader
from mx_rcnn_tpu_torch.eval.tester import (INFER_DTYPES, Predictor, pred_eval,
                                           resolve_device)
from mx_rcnn_tpu_torch.logger import logger, setup_logging
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.tools.common import (add_common_args,
                                            add_prefetch_arg,
                                            config_from_args, get_imdb,
                                            load_eval_params)

# flags of the JAX driver whose machinery the port has not ported
NOT_PORTED = {"vis": "--vis", "calibrate_shard": "--calibrate-shard",
              "devices": "--devices", "program_cache": "--program-cache",
              "obs_port": "--obs-port"}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Test a Faster R-CNN "
                                     "network (PyTorch port)")
    add_common_args(parser, train=False)
    add_prefetch_arg(parser)
    parser.add_argument("--prefix", default="model/e2e",
                        help="checkpoint prefix: {prefix}-{epoch:04d}.npz")
    parser.add_argument("--epoch", type=int, default=10,
                        help="checkpoint epoch to load")
    parser.add_argument("--batch_images", type=int, default=1,
                        help="images per eval batch")
    parser.add_argument("--thresh", type=float, default=1e-3,
                        help="per-class score threshold")
    parser.add_argument("--dets_cache", default="",
                        help="pickle all_boxes here for tools/reeval.py")
    parser.add_argument("--eval-inflight", type=int, default=None,
                        dest="eval_inflight",
                        help="overlapped-eval window (default "
                             "cfg.tpu.EVAL_INFLIGHT=2); 0 runs the serial "
                             "loop")
    parser.add_argument("--eval-host-workers", type=int, default=None,
                        dest="eval_host_workers",
                        help="host post-process threads (default "
                             "cfg.tpu.EVAL_HOST_WORKERS=2)")
    parser.add_argument("--device-postprocess", action="store_true",
                        dest="device_postprocess",
                        help="decode, per-class NMS and cap on the device "
                             "(the NMS kernels); the host reads back only "
                             "max_per_image rows per image")
    parser.add_argument("--infer_dtype", "--infer-dtype", default="float32",
                        dest="infer_dtype",
                        choices=list(INFER_DTYPES) + ["int8",
                                                      "int8-activation"],
                        help="parameter variant; the int8 ones are not "
                             "ported")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; raises "
                             "without one)")
    # not ported: accepted so that they raise by name
    parser.add_argument("--vis", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--calibrate-shard", type=int, default=0,
                        dest="calibrate_shard", help=argparse.SUPPRESS)
    parser.add_argument("--devices", type=int, default=0,
                        help=argparse.SUPPRESS)
    parser.add_argument("--program-cache", default="", dest="program_cache",
                        help=argparse.SUPPRESS)
    parser.add_argument("--obs-port", type=int, default=0, dest="obs_port",
                        help=argparse.SUPPRESS)
    return parser.parse_args(argv)


def test_rcnn(args) -> dict:
    setup_logging()
    for dest, flag in NOT_PORTED.items():
        if getattr(args, dest):
            raise NotImplementedError(f"{flag} is not ported to "
                                      f"mx_rcnn_tpu_torch (ROADMAP.md)")
    if args.infer_dtype not in INFER_DTYPES:
        raise NotImplementedError(f"--infer_dtype {args.infer_dtype} is not "
                                  f"ported (ROADMAP.md A.8)")
    device = resolve_device(args.device)
    cfg = config_from_args(args, train=False)
    imdb = get_imdb(args, cfg, test=True)
    roidb = imdb.gt_roidb()
    predictor = Predictor(build_model(cfg), load_eval_params(args), cfg,
                          device=device, dtype=args.infer_dtype)
    loader = TestLoader(roidb, cfg, batch_size=args.batch_images,
                        prefetch=args.prefetch)
    stats = pred_eval(predictor, loader, imdb, thresh=args.thresh,
                      det_cache=args.dets_cache or None,
                      inflight=args.eval_inflight,
                      host_workers=args.eval_host_workers,
                      device_postprocess=args.device_postprocess)
    logger.info("evaluation done: mAP %.4f, %s", stats["mAP"],
                stats["eval_pipeline"])
    return stats


test_rcnn.__test__ = False  # a driver, not a pytest test

if __name__ == "__main__":
    test_rcnn(parse_args())
