"""Stage tool: RPN proposal generation (counterpart of
``mx_rcnn_tpu/tools/test_rpn.py``; reference ``rcnn/tools/test_rpn.py``,
alternate training stages 2 and 5), on the card unless given ``--device
cpu``.

    python -m mx_rcnn_tpu_torch.tools.test_rpn --synthetic \\
        --prefix model/rpn --epoch 1

The RPN-only test graph (``FasterRCNN.predict_rpn``: the NMS kernels,
once a batch) over the roidb, one image a batch, through ``Predictor``;
each record gets its proposals in the original frame, and the list is
pickled to ``{root_path}/cache/{imdb.name}_rpn_proposals.pkl``.  The
records are read on this thread, or with ``--prefetch`` on the loader's
prefetch thread.
"""

from __future__ import annotations

import argparse
import os

from mx_rcnn_tpu_torch.data.loader import TestLoader
from mx_rcnn_tpu_torch.eval.tester import (Predictor, generate_proposals,
                                           resolve_device)
from mx_rcnn_tpu_torch.logger import logger, setup_logging
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.tools.common import (add_common_args,
                                            add_prefetch_arg,
                                            config_from_args, get_imdb,
                                            load_eval_params)


def test_rpn(args, cfg=None, params=None, imdb=None, roidb=None) -> list:
    """Proposals for every record of ``roidb`` (default: ``imdb``'s gt
    roidb) from ``params`` (default: the checkpoint ``--prefix``/
    ``--epoch``) → the roidb, each record with ``proposals``."""
    setup_logging()
    device = resolve_device(args.device)
    cfg = cfg or config_from_args(args, train=False)
    if imdb is None:
        imdb = get_imdb(args, cfg)
    if roidb is None:
        roidb = imdb.gt_roidb()
    if params is None:
        params = load_eval_params(args)
    predictor = Predictor(build_model(cfg), params, cfg, device=device)
    loader = TestLoader(roidb, cfg, batch_size=1)
    cache = os.path.join(imdb.cache_path, f"{imdb.name}_rpn_proposals.pkl")
    roidb = generate_proposals(predictor, loader, roidb, cache_path=cache)
    n = sum(len(r.get("proposals", ())) for r in roidb)
    logger.info("test_rpn: %d proposals over %d images", n, len(roidb))
    return roidb


test_rpn.__test__ = False  # a driver, not a pytest test


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Generate RPN proposals "
                                     "(PyTorch port)")
    add_common_args(parser, train=False)
    add_prefetch_arg(parser)
    parser.add_argument("--prefix", default="model/e2e",
                        help="checkpoint prefix: {prefix}-{epoch:04d}.npz")
    parser.add_argument("--epoch", type=int, default=10,
                        help="checkpoint epoch to load")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; raises "
                             "without one)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    test_rpn(parse_args())
