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

The host pipeline, as in the JAX package:

* All RNG is drawn on the consumer's thread at the start of an epoch
  (``_take_epoch_plan``); ``advance_epochs`` and ``skip_next`` replay a
  schedule for a mid-epoch resume, the same with workers on or off.
* A training loader isolates bad records (``_load_record_isolated``): a
  record that fails to load is replaced by the next one in the roidb and
  counted (``loader/bad_record``); ``MAX_CONSECUTIVE_BAD_RECORDS`` in a
  row raise.  ``TestLoader`` stays strict.
* ``cfg.tpu.LOADER_WORKERS`` > 0 loads the records in worker processes
  over a shared-memory ring (``data/workers.py``), in plan order, so the
  batches are the serial producer's bit for bit.
* ``_Prefetcher`` assembles batches on a daemon thread, ``cfg.tpu.PREFETCH``
  (``TestLoader(prefetch=…)``) ahead, and runs the ``put`` hook there (the
  trainer's and ``Predictor``'s copy to the card).  A depth of 0, the
  port's default, reads on the consumer's thread (the JAX package clamps
  the depth to 1 and defaults to 2).

Not ported: the host cv2 path, replay mixing, masks and multi-host
partitions.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.data.image import get_image, stage_raw_to_bucket
from mx_rcnn_tpu_torch.logger import logger

# A training loader substitutes a record that fails to load, but this many
# failures in a row mean the breakage is systemic (a wrong dataset path, an
# unmounted filesystem) and raise.  Module-level so tests can narrow it.
MAX_CONSECUTIVE_BAD_RECORDS = 8

Plan = List[Tuple[np.ndarray, Tuple[int, int]]]


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


def _load_record_isolated(roidb: list, i: int, cfg: Config,
                          scale: Tuple[int, int],
                          state: Optional[list] = None) -> Tuple[int, dict]:
    """``_load_record`` for a training loader: a record that fails to load
    is replaced by the next roidb record, and so on, each failure counted
    (``loader/bad_record``) and logged.  ``state`` is a one-element list,
    the count of failures in a row across the calls of one producer; a
    success resets it and ``MAX_CONSECUTIVE_BAD_RECORDS`` raise a
    ``RuntimeError`` after a ``loader_systemic`` flight dump.  Returns
    ``(actual_index, sample)``, so that a caller pairing the sample with
    other per-record data (``ROIIter``'s proposals) takes the record that
    was loaded."""
    n = len(roidb)
    state = state if state is not None else [0]
    attempt = 0
    while True:
        j = (i + attempt) % n
        try:
            out = _load_record(roidb[j], cfg, scale)
            state[0] = 0
            return j, out
        except Exception as e:  # noqa: BLE001 — isolate, count, bound
            state[0] += 1
            telemetry.get().counter("loader/bad_record")
            if state[0] >= MAX_CONSECUTIVE_BAD_RECORDS:
                telemetry.get().dump_flight(
                    "loader_systemic", consecutive_bad=state[0],
                    last_index=j, error=f"{type(e).__name__}: {e}"[:500])
                raise RuntimeError(
                    f"{state[0]} consecutive roidb records failed to load "
                    f"(last: index {j}, {type(e).__name__}: {e}) — this "
                    f"looks systemic (wrong dataset path? unmounted "
                    f"filesystem?), not a stray corrupt image") from e
            logger.warning("bad roidb record %d (%s: %s) — substituting "
                           "record %d [loader/bad_record]",
                           j, type(e).__name__, e, (j + 1) % n)
            attempt += 1


def _stack(samples: List[dict]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _iter_samples(roidb: list, cfg: Config, plan: Plan,
                  pool) -> Iterator[Tuple[int, dict]]:
    """``(actual_index, sample)`` for every row of ``plan``, in plan order:
    through the worker ``pool`` when there is one, else on the calling
    thread.  Both run ``_load_record_isolated`` per record, so the stream
    is the same; the bad-record budget counts per epoch serially and per
    worker in the pool."""
    tasks = [(int(i), scale) for chunk, scale in plan for i in chunk]
    if pool is not None:
        yield from pool.imap_records(tasks)
        return
    fail_state = [0]
    for i, scale in tasks:
        yield _load_record_isolated(roidb, i, cfg, scale, state=fail_state)


class _Prefetcher:
    """Runs a batch generator on a daemon thread into a queue bounded at
    ``depth``.  ``put`` (optional) maps each batch on that thread before it
    is queued: the copy to the card, which then overlaps the step the
    consumer runs.  ``close()`` (or the end of iteration) stops the
    producer, drains the queue and joins the thread, bounded; ``__del__``
    only signals the stop.

    An exception of the producer is raised on the consumer's side.  The
    watchdog (``watchdog_s``, <= 0 disables) bounds the consumer's wait:
    with no producer heartbeat (one a queued batch, and while blocked on a
    full queue) for that long, a ``prefetch_watchdog`` flight dump and a
    ``RuntimeError`` naming the producer's state.

    Telemetry (an active sink): ``loader/produce`` (batch assembly),
    ``loader/put_transfer`` (the hook), ``loader/queue_full_wait``
    (producer blocked: the consumer is the bottleneck) on the producer's
    side; the ``loader/queue_depth`` gauge at every get on the consumer's
    (persistently 0: the producer is the bottleneck)."""

    def __init__(self, gen, depth: int, put=None, watchdog_s: float = 600.0):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._err = None
        self._stop = threading.Event()
        self._tel = telemetry.get()
        self._watchdog_s = watchdog_s
        self._beat = time.monotonic()

        def enqueue(item) -> bool:
            """Blocking put that honours close(); False once stopped."""
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    self._beat = time.monotonic()
                    return True
                except queue.Full:
                    self._beat = time.monotonic()  # blocked on full: alive
            return False

        def run():
            # the watchdog counts from the thread's start, not from __init__
            self._beat = time.monotonic()
            tel = self._tel
            try:
                if not tel.enabled:
                    for item in gen:
                        if put is not None:
                            item = put(item)
                        if not enqueue(item):
                            return
                else:
                    t_prod = time.perf_counter()
                    for item in gen:
                        dt_prod = time.perf_counter() - t_prod
                        tel.add("loader/produce", dt_prod)
                        tel.observe("loader/produce", dt_prod)
                        if put is not None:
                            with tel.span("loader/put_transfer"):
                                item = put(item)
                        t_full = time.perf_counter()
                        if not enqueue(item):
                            return
                        tel.add("loader/queue_full_wait",
                                time.perf_counter() - t_full)
                        t_prod = time.perf_counter()
            except BaseException as e:  # raised on the consumer's side
                self._err = e
            finally:
                # ends the source: an abandoned pool epoch drains its tickets
                close = getattr(gen, "close", None)
                try:
                    if close is not None:
                        close()
                finally:
                    while True:  # the sentinel lands even on a full queue
                        try:
                            self._q.put(None, timeout=0.2)
                            break
                        except queue.Full:
                            if self._stop.is_set():
                                break

        self._t = threading.Thread(target=run, name="loader-prefetch",
                                   daemon=True)
        self._t.start()

    def close(self, timeout: float = 5.0):
        """Stop the producer and join its thread (bounded); draining the
        queue first frees a producer blocked on a full one."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=timeout)
        if self._t.is_alive():
            logger.warning("prefetch producer thread did not exit within "
                           "%.1fs of close() — still parked in the source "
                           "generator?", timeout)

    def __del__(self):
        self._stop.set()  # no join in a finalizer

    def _get(self):
        """Blocking get under the watchdog (see the class docstring)."""
        if self._watchdog_s <= 0:
            return self._q.get()
        poll = min(self._watchdog_s, 5.0)
        while True:
            try:
                return self._q.get(timeout=poll)
            except queue.Empty:
                age = time.monotonic() - self._beat
                if age < self._watchdog_s and self._t.is_alive():
                    continue  # slow but advancing, or just started
                telemetry.get().dump_flight(
                    "prefetch_watchdog", age_s=round(age, 1),
                    producer_alive=self._t.is_alive())
                raise RuntimeError(
                    f"prefetch queue empty with no producer heartbeat for "
                    f"{age:.0f}s (watchdog {self._watchdog_s:.0f}s) — "
                    f"producer thread "
                    f"{'alive' if self._t.is_alive() else 'DEAD'}, "
                    f"stop_requested={self._stop.is_set()}, "
                    f"qsize={self._q.qsize()}: the producer is stuck (hung "
                    f"filesystem read? deadlocked put hook?) or died "
                    f"without delivering its end-of-epoch sentinel") \
                    from None

    def __iter__(self):
        tel = self._tel
        try:
            while True:
                if tel.enabled:
                    # before the blocking get: persistently 0 means the
                    # consumer outruns the producer
                    tel.gauge("loader/queue_depth", self._q.qsize())
                item = self._get()
                if item is None:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            self.close()


def _serial(gen, put) -> Iterator:
    """Depth 0: the batches and the ``put`` hook on the consumer's thread."""
    try:
        for item in gen:
            yield item if put is None else put(item)
    finally:
        close = getattr(gen, "close", None)
        if close is not None:
            close()


def _prefetched(gen, depth: int, put, watchdog_s: float) -> Iterator:
    if depth <= 0:
        return _serial(gen, put)
    return iter(_Prefetcher(gen, depth, put=put, watchdog_s=watchdog_s))


class AnchorLoader:
    """End-to-end training loader: iterable over epochs, each pass yields
    dict batches of ``batch_size`` images (numpy, or what the ``put`` hook
    makes of them).  A short last group is wrapped by re-sampling from the
    group, like the reference.

    ``put`` maps each batch on the producer's thread (``fit`` installs the
    copy to the card).  With ``cfg.tpu.LOADER_WORKERS`` > 0 the worker pool is made
    on the first iteration, on the consumer's thread, and reused across
    epochs until ``close_workers()``."""

    def __init__(self, roidb: list, cfg: Config, batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        if not roidb:
            raise ValueError("empty roidb")
        self.roidb = list(roidb)
        self.cfg = cfg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.put = None
        self._pool = None
        self._rng = np.random.RandomState(seed)
        self._skip = 0  # one-shot batch skip armed by skip_next()
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

    def _epoch_plan(self) -> Plan:
        """(batch indices, scale bucket) for one epoch: one scale per batch
        when shuffling over several ``SCALES``, else ``SCALES[0]``."""
        batches = self._epoch_indices()
        scales = self.cfg.tpu.SCALES
        if self.shuffle and len(scales) > 1:
            chosen = [scales[self._rng.randint(len(scales))] for _ in batches]
        else:
            chosen = [scales[0]] * len(batches)
        return list(zip(batches, chosen))

    def advance_epochs(self, n: int) -> None:
        """Draw and discard ``n`` epoch plans: the RandomState advances as
        ``n`` iterations would, so that the next epoch is epoch ``n``'s."""
        for _ in range(n):
            self._epoch_plan()

    def skip_next(self, n: int) -> None:
        """The next iteration drops its first ``n`` batches (consumed
        before an interruption); its plan is drawn whole first, so the
        tail is the uninterrupted epoch's."""
        if n < 0:
            raise ValueError(f"skip_next: n must be >= 0, got {n}")
        self._skip = n

    def _take_epoch_plan(self) -> Plan:
        """One epoch's plan, any armed skip applied and disarmed."""
        plan = self._epoch_plan()  # the whole draw first: RNG in sequence
        skip, self._skip = self._skip, 0
        if skip > len(plan):
            raise ValueError(
                f"skip_next({skip}) exceeds the epoch's {len(plan)} batches "
                f"— the resume position does not match this loader's "
                f"schedule (another seed or batch size?)")
        return plan[skip:]

    def _ensure_pool(self):
        """The worker pool on first use, made on the consumer's thread (a
        fork from the producer's thread would copy state mid-change);
        ``LOADER_WORKERS`` = 0 keeps the serial producer."""
        workers = int(self.cfg.tpu.LOADER_WORKERS)
        if workers > 0 and self._pool is None:
            from mx_rcnn_tpu_torch.data.workers import WorkerPool

            self._pool = WorkerPool(self.cfg, self.roidb,
                                    num_workers=workers)
        return self._pool

    def close_workers(self):
        """Stop the worker processes and free the ring.  Idempotent; the
        next iteration makes a new pool."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __del__(self):
        try:
            self.close_workers()
        except Exception:
            pass

    def _sample(self, j: int, sample: dict) -> dict:
        """The parent's part of a sample of record ``j`` (none here)."""
        return sample

    def _produce(self, plan: Plan, pool) -> Iterator[Dict[str, np.ndarray]]:
        samples: List[dict] = []
        for j, s in _iter_samples(self.roidb, self.cfg, plan, pool):
            samples.append(self._sample(j, s))
            if len(samples) == self.batch_size:
                yield _stack(samples)
                samples = []

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        plan = self._take_epoch_plan()  # RNG on the consumer's thread only
        gen = self._produce(plan, self._ensure_pool())
        return _prefetched(gen, self.cfg.tpu.PREFETCH, self.put,
                           self.cfg.tpu.PREFETCH_WATCHDOG_S)


class ROIIter(AnchorLoader):
    """Fast R-CNN training loader over cached proposals: ``AnchorLoader``'s
    epochs (the same plan from the same seed), each sample with ``rois``
    (``TRAIN.RPN_POST_NMS_TOP_N``, 4), the record's ``proposals`` scaled by
    its ``im_info[2]`` into the resized frame, padded or cut to the cap,
    and ``roi_valid`` marking the real rows.  The proposals are those of
    the record actually loaded (a bad record's substitute), attached in the
    parent process.  The first rows are kept where a record has more than
    the cap: right for score-sorted RPN caches, so a warning names how many
    records lose rows."""

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

    def _sample(self, j: int, sample: dict) -> dict:
        p_max = self.cfg.TRAIN.RPN_POST_NMS_TOP_N
        props = np.asarray(self.roidb[j].get("proposals", np.zeros((0, 4))),
                           np.float32)
        rois = np.zeros((p_max, 4), np.float32)
        valid = np.zeros((p_max,), bool)
        n = min(len(props), p_max)
        if n:
            rois[:n] = props[:n] * sample["im_info"][2]
            valid[:n] = True
        sample["rois"] = rois
        sample["roi_valid"] = valid
        return sample


class TestLoader:
    """Evaluation loader: the roidb in order, no shuffle, ``SCALES[0]``;
    the last batch is padded with repeats of its last image, and
    ``batch_valid`` marks the real rows, ``indices`` their roidb index.
    Batches are staged raw ``uint8`` with the ``raw_hw``/``prep_ratio``
    sidecars, prepped on the card by ``Predictor.batch_put`` (the ``put``
    hook ``pred_eval`` installs).  Loads are strict: a bad record raises,
    since a substitute would change the metric.  ``prefetch`` (default
    ``cfg.tpu.PREFETCH``) is the depth of the prefetch thread's queue; the
    JAX package's ``TestLoader`` has no worker pool, nor has this one.  A
    batch holds one bucket shape, so a batch of several images must not
    mix landscape and portrait images."""

    __test__ = False  # not a pytest class

    def __init__(self, roidb: list, cfg: Config, batch_size: int = 1,
                 prefetch: Optional[int] = None):
        self.roidb = roidb
        self.cfg = cfg
        self.batch_size = batch_size
        self.prefetch = (int(prefetch) if prefetch is not None
                         else cfg.tpu.PREFETCH)
        self.put = None

    def __len__(self) -> int:
        return (len(self.roidb) + self.batch_size - 1) // self.batch_size

    def _produce(self) -> Iterator[Dict[str, np.ndarray]]:
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

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return _prefetched(self._produce(), self.prefetch, self.put,
                           self.cfg.tpu.PREFETCH_WATCHDOG_S)
