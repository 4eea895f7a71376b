"""The loaders (counterparts of ``mx_rcnn_tpu/data/loader.py:AnchorLoader``,
``ROIIter`` and ``TestLoader`` on their device-prep route; reference
``rcnn/core/loader.py``).

Anchor targets are assigned on the card, inside the train step, so a
batch carries only what the step needs: raw ``uint8`` pixels staged in the
orientation's bucket (``data/image.py:stage_raw_to_bucket``) with their
``raw_hw``/``prep_ratio``/``flip`` sidecars, ``im_info``, and the gt
scaled into the resized frame and padded to ``MAX_GT``.  The pixels are
resampled, mirrored and normalised on the card
(``train/trainer.py:batch_put``).  Aspect grouping puts each batch in one
bucket shape; a seeded ``RandomState`` draws the shuffle, the wrap of a
short last batch and the scale, in the JAX package's order, so both
loaders plan the same epochs.  Records without inline pixels (``image_array``)
are read from their file by ``data/image.py:get_image``, unflipped: the
card mirrors them.

``ROIIter`` is ``AnchorLoader``'s plan with each record's cached
proposals beside it (alternate training, stages 3 and 6).  ``TestLoader``
walks the roidb in order, one scale, and pads the last
batch with repeats of its last image (``indices``, ``batch_valid``).

Not ported: the host cv2 path, the worker pool, the prefetch thread (a
batch is read and staged on the consumer's thread), replay mixing,
bad-record isolation and multi-host partitions.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.data.image import get_image, stage_raw_to_bucket
from mx_rcnn_tpu_torch.logger import logger


def _load_record(rec: dict, cfg: Config, scale: Tuple[int, int]) -> dict:
    """roidb record → one staged sample (host numpy)."""
    im = rec["image_array"] if "image_array" in rec else get_image(
        rec["image"])
    stride = max(cfg.network.IMAGE_STRIDE, cfg.network.RPN_FEAT_STRIDE)
    staged, raw_hw, ratio, im_info = stage_raw_to_bucket(
        np.ascontiguousarray(im), scale, stride)
    s = float(im_info[2])
    g = cfg.tpu.MAX_GT
    boxes = np.zeros((g, 4), np.float32)
    classes = np.zeros((g,), np.int32)
    valid = np.zeros((g,), bool)
    n = min(len(rec["boxes"]), g)
    if n:
        boxes[:n] = rec["boxes"][:n] * s  # gt scaled into the resized frame
        classes[:n] = rec["gt_classes"][:n]
        valid[:n] = True
    return dict(images=staged, im_info=im_info, gt_boxes=boxes,
                gt_classes=classes, gt_valid=valid, raw_hw=raw_hw,
                prep_ratio=ratio, flip=np.bool_(rec.get("flipped", False)))


def _stack(samples: List[dict]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class AnchorLoader:
    """End-to-end training loader: iterable over epochs, each pass yields
    dict batches of ``batch_size`` images (numpy).  A short last group is
    wrapped by re-sampling from the group, like the reference."""

    def __init__(self, roidb: list, cfg: Config, batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        if not roidb:
            raise ValueError("empty roidb")
        self.roidb = list(roidb)
        self.cfg = cfg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        # aspect grouping: horizontal (w >= h) vs vertical index pools
        self._groups = [
            [i for i, r in enumerate(roidb) if r["width"] >= r["height"]],
            [i for i, r in enumerate(roidb) if r["width"] < r["height"]],
        ]
        self._len = sum(len(g) // batch_size + (1 if len(g) % batch_size else 0)
                        for g in self._groups if g)

    def __len__(self) -> int:
        return self._len

    @property
    def steps_per_epoch(self) -> int:
        return self._len

    def _epoch_indices(self) -> List[np.ndarray]:
        batches = []
        for g in self._groups:
            if not g:
                continue
            idx = np.asarray(g)
            if self.shuffle:
                self._rng.shuffle(idx)
            for i in range(0, len(idx), self.batch_size):
                chunk = idx[i:i + self.batch_size]
                if len(chunk) < self.batch_size:  # wrap like the reference
                    extra = self._rng.choice(idx, self.batch_size - len(chunk))
                    chunk = np.concatenate([chunk, extra])
                batches.append(chunk)
        if self.shuffle:
            order = self._rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        return batches

    def _epoch_plan(self) -> List[Tuple[np.ndarray, Tuple[int, int]]]:
        """(batch indices, scale bucket) for one epoch: one scale per batch
        when shuffling over several ``SCALES``, else ``SCALES[0]``."""
        batches = self._epoch_indices()
        scales = self.cfg.tpu.SCALES
        if self.shuffle and len(scales) > 1:
            chosen = [scales[self._rng.randint(len(scales))] for _ in batches]
        else:
            chosen = [scales[0]] * len(batches)
        return list(zip(batches, chosen))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for chunk, scale in self._epoch_plan():
            yield _stack([_load_record(self.roidb[int(i)], self.cfg, scale)
                          for i in chunk])


class ROIIter(AnchorLoader):
    """Fast R-CNN training loader over cached proposals: ``AnchorLoader``'s
    epochs (the same plan from the same seed), each sample with ``rois``
    (``TRAIN.RPN_POST_NMS_TOP_N``, 4), the record's ``proposals`` scaled by
    its ``im_info[2]`` into the resized frame, padded or cut to the cap,
    and ``roi_valid`` marking the real rows.  The first rows are kept
    where a record has more than the cap: right for score-sorted RPN
    caches, so a warning names how many records lose rows."""

    def __init__(self, roidb: list, cfg: Config, batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        super().__init__(roidb, cfg, batch_size, shuffle, seed)
        cap = cfg.TRAIN.RPN_POST_NMS_TOP_N
        over = sum(len(r.get("proposals", ())) > cap for r in roidb)
        if over:
            logger.warning(
                "%d/%d images carry more than TRAIN.RPN_POST_NMS_TOP_N=%d "
                "proposals; ROIIter keeps the FIRST %d rows — fine for "
                "score-sorted RPN caches, lossy for unranked sources like "
                "selective search (raise the cap if the tail matters)",
                over, len(roidb), cap, cap)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        p_max = self.cfg.TRAIN.RPN_POST_NMS_TOP_N
        for chunk, scale in self._epoch_plan():
            samples = []
            for i in chunk:
                rec = self.roidb[int(i)]
                s = _load_record(rec, self.cfg, scale)
                props = np.asarray(rec.get("proposals", np.zeros((0, 4))),
                                   np.float32)
                rois = np.zeros((p_max, 4), np.float32)
                valid = np.zeros((p_max,), bool)
                n = min(len(props), p_max)
                if n:
                    rois[:n] = props[:n] * s["im_info"][2]
                    valid[:n] = True
                s["rois"] = rois
                s["roi_valid"] = valid
                samples.append(s)
            yield _stack(samples)


class TestLoader:
    """Evaluation loader: the roidb in order, no shuffle, ``SCALES[0]``;
    the last batch is padded with repeats of its last image, and
    ``batch_valid`` marks the real rows, ``indices`` their roidb index.
    Batches are staged raw ``uint8`` with the ``raw_hw``/``prep_ratio``
    sidecars, prepped on the card by ``Predictor.batch_put``.  A batch
    holds one bucket shape, so a batch of several images must not mix
    landscape and portrait images."""

    __test__ = False  # not a pytest class

    def __init__(self, roidb: list, cfg: Config, batch_size: int = 1):
        self.roidb = roidb
        self.cfg = cfg
        self.batch_size = batch_size

    def __len__(self) -> int:
        return (len(self.roidb) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        scale = self.cfg.tpu.SCALES[0]
        n = len(self.roidb)
        for start in range(0, n, self.batch_size):
            idx = list(range(start, min(start + self.batch_size, n)))
            pad = self.batch_size - len(idx)
            samples = [_load_record(self.roidb[i], self.cfg, scale)
                       for i in idx]
            shapes = {s["images"].shape for s in samples}
            if len(shapes) > 1:
                raise ValueError(
                    f"images {idx} fall in different buckets {sorted(shapes)}"
                    f": a batch holds one orientation (use batch size 1)")
            samples += [samples[-1]] * pad
            batch = _stack(samples)
            batch["indices"] = np.asarray(idx + [idx[-1]] * pad, np.int32)
            batch["batch_valid"] = np.asarray([True] * len(idx)
                                              + [False] * pad)
            yield batch
