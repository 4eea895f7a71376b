"""Training callbacks (counterpart of ``mx_rcnn_tpu/train/callback.py``;
reference ``rcnn/core/callback.py``)."""

from __future__ import annotations

import time

from mx_rcnn_tpu_torch.logger import logger


class Speedometer:
    """Images-per-second logger, reset each epoch (the reference's
    ``mx.callback.Speedometer`` as ``train_end2end.py`` wires it).
    Intervals are taken on ``time.perf_counter``; what they measure is
    the host's view of the loop (the trainer synchronises with the card
    when it fetches metrics)."""

    def __init__(self, batch_size: int, frequent: int = 20):
        self.batch_size = batch_size
        self.frequent = frequent
        self._tic = None
        self._count = 0

    def reset(self):
        self._tic = None
        self._count = 0

    def __call__(self, epoch: int, step: int, metric_str: str = ""):
        self._count += 1
        if self._tic is None:
            self._tic = time.perf_counter()
            self._count = 0
            return None
        if self._count % self.frequent == 0:
            dt = time.perf_counter() - self._tic
            speed = self.frequent * self.batch_size / max(dt, 1e-9)
            logger.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s",
                        epoch, step, speed, metric_str)
            self._tic = time.perf_counter()
            return speed
        return None
