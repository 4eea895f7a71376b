"""The data flywheel (counterpart of ``mx_rcnn_tpu/flywheel``): so far only
:mod:`hardness`, the one hardness definition that the cascade's serving
gate routes on.  Request capture, the miner, the loop and the fleet are
not ported yet (ROADMAP.md A.7.7, A.12)."""

from mx_rcnn_tpu_torch.flywheel.hardness import (HARDNESS_MAX, SCORE_BANDS,
                                                 build_device_hardness,
                                                 hardness,
                                                 hardness_from_records,
                                                 score_stats)

__all__ = ["HARDNESS_MAX", "SCORE_BANDS", "build_device_hardness",
           "hardness", "hardness_from_records", "score_stats"]
