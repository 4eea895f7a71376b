"""The port's overlapped eval loop (``eval/pipeline.py``) under stress, on
the CPU: a stub predictor whose outputs are a seeded function of the
batch's image indices, many batches of uneven validity, more host workers
than cores and a shortened thread switch interval.  ``all_boxes`` must
equal the serial loop's bit for bit at every depth, on both post-process
routes, and every image must be counted once.  Plus ``_Progress``: one
line per hundred images whatever the batch size.
"""

import logging
import os
import sys
import time

import numpy as np
import pytest
import torch

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.eval import tester
from mx_rcnn_tpu_torch.ops.postprocess import device_postprocess

torch.set_num_threads(2)

K, R = 5, 40


class StubPredictor:
    """Outputs depend only on the batch's image indices (seeded), so any
    two loops see the same numbers for the same image."""

    def __init__(self):
        self.cfg = generate_config("resnet50", "PascalVOC")

    def batch_put(self, batch):
        return batch

    def predict(self, images, im_info):
        rows = [np.random.RandomState(int(i)) for i in images]
        ctr = np.stack([r.rand(R, 2) * 300 for r in rows])
        wh = np.stack([r.rand(R, 2) * 80 + 8 for r in rows])
        rois = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
        logits = np.stack([r.randn(R, K) * 2 for r in rows])
        prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        deltas = np.stack([r.randn(R, 4 * K) * 0.1 for r in rows])
        valid = np.stack([r.rand(R) > 0.1 for r in rows])
        time.sleep(0.001)
        return tuple(torch.from_numpy(np.asarray(x, t)) for x, t in (
            (rois, np.float32), (valid, bool), (prob, np.float32),
            (deltas, np.float32), (valid, np.float32)))

    def predict_detections(self, images, im_info, max_per_image, thresh):
        rois, valid, prob, deltas, _ = self.predict(images, im_info)
        return device_postprocess(
            rois, valid, prob, deltas, torch.as_tensor(im_info),
            num_classes=K, thresh=thresh, nms_thresh=0.3,
            max_per_image=max_per_image)


class StubLoader:
    """``n`` images in batches of ``bs``, the last padded; the image index
    travels as the batch's "images"."""

    def __init__(self, n, bs):
        self.n, self.bs = n, bs
        self.put = None  # the loader contract: pred_eval sets it

    def __iter__(self):
        for batch in self._produce():
            yield batch if self.put is None else self.put(batch)

    def _produce(self):
        for s in range(0, self.n, self.bs):
            idx = list(range(s, min(s + self.bs, self.n)))
            pad = self.bs - len(idx)
            yield {"images": np.asarray(idx + [idx[-1]] * pad),
                   "im_info": np.tile(np.float32([[300, 300, 1.0]]),
                                      (self.bs, 1)),
                   "indices": np.asarray(idx + [idx[-1]] * pad, np.int32),
                   "batch_valid": np.asarray([True] * len(idx)
                                             + [False] * pad)}


class CapturingIMDB:
    num_classes = K

    def __init__(self, n):
        self.num_images = n

    def evaluate_detections(self, all_boxes):
        self.boxes = all_boxes
        return {"mAP": 0.0}


def run(n, bs, inflight, devpost, workers=2):
    imdb = CapturingIMDB(n)
    stats = tester.pred_eval(StubPredictor(), StubLoader(n, bs), imdb,
                             thresh=0.05, max_per_image=20,
                             inflight=inflight, host_workers=workers,
                             device_postprocess=devpost)
    return imdb.boxes, stats["eval_pipeline"]


@pytest.mark.parametrize("devpost", [False, True], ids=["host", "device"])
def test_overlapped_loop_under_stress_equals_serial(devpost):
    n, bs = 61, 3
    serial, _ = run(n, bs, 0, devpost)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for inflight in (1, 2, 5):
            got, meta = run(n, bs, inflight, devpost,
                            workers=2 * (os.cpu_count() or 4))
            assert meta["images"] == n and meta["inflight"] == inflight
            for k in range(1, K):
                for i in range(n):
                    assert got[k][i] is not None, (k, i)
                    np.testing.assert_array_equal(got[k][i], serial[k][i])
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("bs", [1, 3, 7, 64])
def test_progress_logs_once_per_hundred_images(bs, caplog):
    progress = tester._Progress(250)
    with caplog.at_level(logging.INFO, logger="mx_rcnn_tpu_torch"):
        done = 0
        while done < 250:
            done = min(done + bs, 250)
            progress.update(done)
    lines = [r for r in caplog.records if "im_detect:" in r.getMessage()]
    assert len(lines) == 2
