"""Re-score cached detections (counterpart of
``mx_rcnn_tpu/tools/reeval.py``): load a pickled ``all_boxes`` (``test
--dets_cache``) and run ``imdb.evaluate_detections`` again, with no model
and no device.

    python -m mx_rcnn_tpu_torch.tools.reeval --detections dets.pkl \\
        --image_set 2007_test --dataset_path data/VOCdevkit
"""

from __future__ import annotations

import argparse
import pickle

from mx_rcnn_tpu_torch.logger import logger, setup_logging
from mx_rcnn_tpu_torch.tools.common import (add_common_args, config_from_args,
                                            get_imdb)


def reeval(args) -> dict:
    setup_logging()
    cfg = config_from_args(args, train=False)
    imdb = get_imdb(args, cfg, test=True)
    with open(args.detections, "rb") as f:
        all_boxes = pickle.load(f)
    stats = imdb.evaluate_detections(all_boxes)
    logger.info("reeval: %s", {k: round(float(v), 4) for k, v in stats.items()
                               if isinstance(v, (int, float))})
    return stats


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Re-evaluate cached "
                                     "detections (PyTorch port)")
    add_common_args(parser, train=False)
    parser.add_argument("--detections", required=True,
                        help="pickled all_boxes path")
    return parser.parse_args(argv)


if __name__ == "__main__":
    reeval(parse_args())
