"""The host input pipeline's worker processes over a shared-memory ring
(counterpart of ``mx_rcnn_tpu/data/workers.py``).

``cfg.tpu.LOADER_WORKERS`` processes each run the per-record hot path
(``loader._load_record_isolated``: decode, pre-shrink, stage into the
bucket) and write the staged ``uint8`` pixels into a slot of one
``multiprocessing.shared_memory`` segment; only the small arrays (gt,
``im_info``, the prep sidecars) cross the result queue.  The parent's
collector hands the samples back in task order whatever the workers'
skew, so the batches are the serial producer's bit for bit.

* Determinism: all RNG stays in the loader's epoch plan on the consumer's
  thread; a worker is a pure function of (roidb index, scale).  Task
  ``seq`` goes to worker ``seq % N``, so a schedule (and a mid-epoch resume
  through ``advance_epochs``/``skip_next``) is the same with workers on or
  off.
* Faults: a worker that dies (a crash, an OOM kill) is respawned on a fresh
  task queue and result pipe and its in-flight tasks are reissued
  (``loader/worker_respawn``); past ``MAX_WORKER_RESPAWNS`` the pool is
  broken and raises "systemic".  A bad record inside a worker follows the
  loader's substitution contract, with the budget of failures in a row
  kept per worker.  Each worker sends its results down a pipe of its own,
  with no lock shared between processes: a worker killed in the middle of
  a send breaks only its own pipe.
* Slots hold the staged raw ``uint8`` (the port preps on the card), so a
  slot is the largest bucket's ``Hb·Wb·3`` bytes.  The ring is reserved in
  ``/dev/shm`` when it is made; one that does not fit raises with the bytes
  it asked for and what ``/dev/shm`` has.
* Workers touch numpy only, never CUDA, also when forked after the parent
  has initialised it.

The serve engine uses an image-only pool: :meth:`WorkerPool.prepare` runs
``stage_raw_to_bucket`` on a raw request in a worker.

Telemetry (an active sink): ``loader/assembly_wait`` (the collector waited
for the next sample in order: the workers are the bottleneck),
``loader/worker_busy``, per-worker ``loader/worker{N}/produce``, and the
``loader/bad_record`` / ``loader/worker_respawn`` counters.

Fault injection (tests): ``MXR_FAULT_WORKER_CRASH_IDX`` makes a worker exit
with code 3 when asked for that roidb index, only once across workers when
``MXR_FAULT_WORKER_CRASH_ONCE`` names a marker file to create;
``MXR_FAULT_WORKER_SLOW`` = ``"worker_id:seconds"`` makes that worker sleep
per task.  ``MXR_LOADER_MP_START`` picks the start method (default fork
where there is one).
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
import traceback
from multiprocessing import shared_memory
from typing import Iterable, Optional, Tuple

import numpy as np

from mx_rcnn_tpu_torch import telemetry
from mx_rcnn_tpu_torch.data.image import bucket_shape
from mx_rcnn_tpu_torch.logger import logger

# Respawns a pool allows before it calls the breakage systemic (a worker
# that dies on every task would otherwise respawn forever).  Module-level
# so tests can narrow it.
MAX_WORKER_RESPAWNS = 8

_ENV_CRASH_IDX = "MXR_FAULT_WORKER_CRASH_IDX"
_ENV_CRASH_ONCE = "MXR_FAULT_WORKER_CRASH_ONCE"
_ENV_SLOW = "MXR_FAULT_WORKER_SLOW"
_ENV_START = "MXR_LOADER_MP_START"
_SHM_DIR = "/dev/shm"


def _mp_context():
    """fork where there is one (no re-import, the roidb shared copy on
    write), else spawn; ``MXR_LOADER_MP_START`` overrides."""
    import multiprocessing as mp

    method = os.environ.get(_ENV_START)
    if not method:
        method = "fork" if "fork" in mp.get_all_start_methods() else "spawn"
    return mp.get_context(method)


def _stride(cfg) -> int:
    return max(cfg.network.IMAGE_STRIDE, cfg.network.RPN_FEAT_STRIDE)


def slot_bytes_for(cfg) -> int:
    """A ring slot: the largest staged sample the config can give, the
    largest bucket's ``Hb·Wb·3`` uint8 bytes (both orientations of a scale
    have the same area)."""
    return max(h * w * 3 for h, w in (bucket_shape(s, _stride(cfg))
                                      for s in cfg.tpu.SCALES))


def shm_free_bytes() -> Optional[int]:
    """Bytes free in ``/dev/shm``, None where there is none."""
    try:
        st = os.statvfs(_SHM_DIR)
    except OSError:
        return None
    return st.f_bavail * st.f_frsize


def _create_shm(size: int) -> shared_memory.SharedMemory:
    """A new segment of ``size`` bytes with its pages reserved: tmpfs
    grants a segment lazily, and a write past its limit would kill the
    writer with SIGBUS instead of raising here."""
    free = shm_free_bytes()

    def short(cause: str) -> RuntimeError:
        return RuntimeError(
            f"loader worker pool: cannot allocate its shared-memory ring of "
            f"{size} bytes ({cause}); {_SHM_DIR} has "
            f"{'no filesystem' if free is None else f'{free} bytes free'} — "
            f"raise the container's shm size, or lower --loader-workers")

    if free is not None and size > free:
        raise short("not enough room")
    try:
        shm = shared_memory.SharedMemory(create=True, size=size)
    except OSError as e:
        raise short(f"{type(e).__name__}: {e}") from e
    fd = getattr(shm, "_fd", -1)
    if fd >= 0 and hasattr(os, "posix_fallocate"):
        try:
            os.posix_fallocate(fd, 0, size)
        except OSError as e:
            shm.close()
            shm.unlink()
            raise short(f"{type(e).__name__}: {e}") from e
    return shm


def _attach_shm(name: str) -> shared_memory.SharedMemory:
    """Attach to the pool's segment without registering it with this
    process's resource tracker: through Python 3.12 every attach registers
    it for unlink at exit, so a worker's exit would tear the segment down
    under the parent (bpo-39959; ``track=False`` from 3.13)."""
    from multiprocessing import resource_tracker

    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


def _maybe_crash(index: int):
    """The crash injection (see the module docstring)."""
    want = os.environ.get(_ENV_CRASH_IDX)
    if want is None or int(want) != int(index):
        return
    marker = os.environ.get(_ENV_CRASH_ONCE)
    if marker:
        try:  # atomic create: exactly one crash across all workers
            fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
        except FileExistsError:
            return
    os._exit(3)


def _worker_main(worker_id: int, cfg, roidb, shm_name: str, slot_bytes: int,
                 task_q, result_conn):
    """One worker: takes ``(seq, kind, payload, scale, slot)`` tasks until
    the None sentinel.

    * ``"record"``: payload is a roidb index → ``_load_record_isolated``
      (substitution included); pixels into the slot; the actual index, the
      rest of the sample and the number of records skipped back.
    * ``"image"``: payload is a raw RGB uint8 array (serving) →
      ``stage_raw_to_bucket``; pixels into the slot; ``raw_hw``,
      ``ratio`` and ``im_info`` back.
    """
    import signal

    # the parent handles SIGINT for all, and a forked child must not run
    # the parent's handlers
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    # a fork inherits the parent's open telemetry stream: leave it alone
    telemetry.reset_null()

    from mx_rcnn_tpu_torch.data import loader as loader_mod
    from mx_rcnn_tpu_torch.data.image import stage_raw_to_bucket

    shm = _attach_shm(shm_name)
    fail_state = [0]  # bad records in a row, this worker's budget
    slow_s = 0.0
    slow = os.environ.get(_ENV_SLOW)
    if slow:
        wid, _, sec = slow.partition(":")
        if int(wid) == worker_id:
            slow_s = float(sec)
    try:
        while True:
            msg = task_q.get()
            if msg is None:
                return
            seq, kind, payload, scale, slot = msg
            t0 = time.perf_counter()
            try:
                if slow_s:
                    time.sleep(slow_s)
                if kind == "record":
                    index = int(payload)
                    _maybe_crash(index)
                    j, sample = loader_mod._load_record_isolated(
                        roidb, index, cfg, scale, state=fail_state)
                    img = sample.pop("images")
                    meta = {"index": j, "sample": sample,
                            "bad": (j - index) % len(roidb)}
                else:
                    img, raw_hw, ratio, im_info = stage_raw_to_bucket(
                        np.asarray(payload), scale, _stride(cfg))
                    meta = {"raw_hw": raw_hw, "ratio": ratio,
                            "im_info": im_info, "bad": 0}
                if img.nbytes > slot_bytes:
                    raise ValueError(f"a staged sample of {img.nbytes} bytes "
                                     f"exceeds the {slot_bytes}-byte slot")
                view = np.ndarray(img.shape, img.dtype, buffer=shm.buf[
                    slot * slot_bytes:slot * slot_bytes + img.nbytes])
                view[...] = img
                del view
                meta["shape"] = tuple(img.shape)
                meta["dtype"] = img.dtype.str
                meta["dur_s"] = time.perf_counter() - t0
                result_conn.send(("ok", seq, meta))
            except BaseException as e:  # raised at the collector
                result_conn.send(("err", seq, f"{type(e).__name__}: {e}\n"
                                              f"{traceback.format_exc()}"))
    finally:
        shm.close()
        result_conn.close()


class _Pending:
    __slots__ = ("worker", "msg", "done", "meta", "error")

    def __init__(self, worker: int, msg: tuple):
        self.worker = worker
        self.msg = msg
        self.done = False
        self.meta = None
        self.error: Optional[str] = None


class WorkerPool:
    """``num_workers`` processes over one shared-memory ring of
    ``max(2N + 2, 4)`` slots (every worker busy with one task and the next
    queued, plus room for completions parked out of order).  One
    pool a loader (or serve engine), reused across epochs; the segment is
    made once and unlinked by ``close()``.  ``roidb`` is None for an
    image-only pool (serving)."""

    def __init__(self, cfg, roidb: Optional[list] = None,
                 num_workers: int = 1):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.cfg = cfg
        self.roidb = roidb
        self.num_workers = int(num_workers)
        self.slot_bytes = slot_bytes_for(cfg)
        self.n_slots = max(2 * self.num_workers + 2, 4)
        self.ring_bytes = self.n_slots * self.slot_bytes
        self.max_respawns = MAX_WORKER_RESPAWNS
        self._ctx = _mp_context()
        self._shm = _create_shm(self.ring_bytes)
        self._closed = False
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._procs = []
        try:
            self._task_qs = [self._ctx.Queue()
                             for _ in range(self.num_workers)]
            self._readers: dict = {}  # result pipe -> worker id
            self._free: queue.Queue = queue.Queue()
            for s in range(self.n_slots):
                self._free.put(s)
            self._pending: dict = {}  # seq -> _Pending
            self._seq = 0
            self._broken: Optional[BaseException] = None
            self.respawns = 0
            for w in range(self.num_workers):
                self._procs.append(self._spawn(w))
            self._collector = threading.Thread(
                target=self._collect_loop, name="loader-pool-collector",
                daemon=True)
            self._collector.start()
        except BaseException:
            self._teardown(timeout=1.0)
            raise

    @property
    def shm_name(self) -> str:
        return self._shm.name

    # -- lifecycle -------------------------------------------------------

    def _spawn(self, worker_id: int):
        reader, writer = self._ctx.Pipe(duplex=False)
        p = self._ctx.Process(
            target=_worker_main,
            args=(worker_id, self.cfg, self.roidb, self._shm.name,
                  self.slot_bytes, self._task_qs[worker_id], writer),
            name=f"loader-worker-{worker_id}", daemon=True)
        p.start()
        writer.close()  # the worker's alone: its death closes the pipe
        self._readers[reader] = worker_id
        return p

    def close(self, timeout: float = 5.0):
        """Stop the workers, join the collector and unlink the segment,
        every wait bounded.  Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._teardown(timeout)

    def _teardown(self, timeout: float):
        self._closed = True
        for q_ in getattr(self, "_task_qs", ()):
            try:
                q_.put(None)
            except (ValueError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=timeout)
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        collector = getattr(self, "_collector", None)
        if collector is not None and collector.is_alive():
            collector.join(timeout=timeout)
        for q_ in getattr(self, "_task_qs", ()):
            try:
                q_.close()
                q_.cancel_join_thread()
            except (ValueError, OSError):
                pass
        with self._lock:
            readers, self._readers = list(getattr(self, "_readers", ())), {}
        for r in readers:
            r.close()
        try:
            self._shm.close()
            self._shm.unlink()
        except FileNotFoundError:
            pass

    def alive_workers(self) -> int:
        return sum(p.is_alive() for p in self._procs)

    def __del__(self):  # close() bounds every wait
        try:
            self.close(timeout=1.0)
        except Exception:
            pass

    # -- submission and collection ---------------------------------------

    def _raise_if_unusable_locked(self):
        if self._broken is not None:
            raise RuntimeError(str(self._broken))
        if self._closed:
            raise RuntimeError("worker pool closed")

    def _take_slot(self) -> int:
        while True:
            try:
                return self._free.get(timeout=0.2)
            except queue.Empty:
                with self._lock:
                    self._raise_if_unusable_locked()

    def _submit(self, kind: str, payload, scale) -> int:
        slot = self._take_slot()  # blocks: at most n_slots in flight
        with self._cond:
            try:
                self._raise_if_unusable_locked()
            except RuntimeError:
                self._free.put(slot)
                raise
            seq = self._seq
            self._seq += 1
            w = seq % self.num_workers  # the same plan, the same workers
            msg = (seq, kind, payload, tuple(scale), slot)
            self._pending[seq] = _Pending(w, msg)
            # under the lock: a respawn between the registration and the
            # put would reissue this task on the fresh queue and the put
            # would then queue it twice (mp.Queue.put does not block)
            self._task_qs[w].put(msg)
        return seq

    def _wait(self, seq: int, timeout: Optional[float] = None
              ) -> Tuple[np.ndarray, dict]:
        """Block for ticket ``seq`` (``timeout`` seconds at most, None for
        no bound); copy its pixels out of the slot, free the slot, return
        (pixels, metadata)."""
        tel = telemetry.get()
        t0 = time.perf_counter()
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                t = self._pending.get(seq)
                if t is None:
                    raise RuntimeError(f"unknown pool ticket {seq}")
                if t.done:
                    del self._pending[seq]
                    break
                self._raise_if_unusable_locked()  # no collector once closed
                if end is not None and time.monotonic() >= end:
                    raise TimeoutError(f"pool ticket {seq} not done within "
                                       f"{timeout} s")
                if not self._cond.wait(timeout=0.5):
                    self._check_workers_locked()
            if tel.enabled:
                busy = {p.worker for p in self._pending.values()
                        if not p.done}
                tel.gauge("loader/worker_busy", len(busy) / self.num_workers)
        slot = t.msg[4]
        if t.error is not None:
            self._free.put(slot)
            raise RuntimeError(
                f"loader worker {t.worker} task failed: {t.error}")
        meta = t.meta
        base = slot * self.slot_bytes
        view = np.ndarray(meta["shape"], np.dtype(meta["dtype"]),
                          buffer=self._shm.buf[base:base + self.slot_bytes])
        img = np.array(view, copy=True)  # the slot is freed below
        del view
        self._free.put(slot)
        if tel.enabled:
            dt = time.perf_counter() - t0
            tel.add("loader/assembly_wait", dt)
            tel.observe("loader/assembly_wait", dt)
            tel.add(f"loader/worker{t.worker}/produce", meta["dur_s"])
            if meta.get("bad"):
                tel.counter("loader/bad_record", meta["bad"])
        return img, meta

    def _collect_loop(self):
        from multiprocessing.connection import wait

        while True:
            with self._lock:
                if self._closed:
                    return
                readers = list(self._readers)
            ready = wait(readers, timeout=0.2) if readers else []
            if not ready:
                time.sleep(0.0 if readers else 0.2)
                with self._cond:
                    self._check_workers_locked()
                continue
            for r in ready:
                try:
                    status, seq, payload = r.recv()
                except Exception:  # EOF: the worker died (or a torn send)
                    with self._cond:
                        if self._readers.pop(r, None) is not None:
                            r.close()
                        self._check_workers_locked()
                    continue
                with self._cond:
                    t = self._pending.get(seq)
                    if t is None or t.done:
                        continue  # stale: a reissued task raced its original
                    t.done = True
                    if status == "ok":
                        t.meta = payload
                    else:
                        t.error = payload
                    self._cond.notify_all()

    def _check_workers_locked(self):
        """Respawn dead workers and reissue their in-flight tasks on a fresh
        queue (the dead worker's may still hold unread tasks, which would
        run twice).  Called under the lock by the collector and by blocked
        waiters."""
        if self._closed or self._broken is not None:
            return
        for w, p in enumerate(self._procs):
            if p.is_alive():
                continue
            lost = sorted(s for s, t in self._pending.items()
                          if t.worker == w and not t.done)
            self.respawns += 1
            telemetry.get().counter("loader/worker_respawn")
            if self.respawns > self.max_respawns:
                err = RuntimeError(
                    f"loader worker {w} died (exit {p.exitcode}) and the "
                    f"pool exceeded {self.max_respawns} respawns — this "
                    f"looks systemic (OOM-killed decode? a record crashing "
                    f"native code?), not a stray fault")
                self._broken = err
                telemetry.get().dump_flight(
                    "loader_systemic", worker=w, exitcode=p.exitcode,
                    respawns=self.respawns, max_respawns=self.max_respawns)
                for s in lost:
                    self._pending[s].done = True
                    self._pending[s].error = str(err)
                self._cond.notify_all()
                return
            logger.warning(
                "loader worker %d died (exit %s) — respawning, reissuing "
                "%d in-flight task(s) [loader/worker_respawn]",
                w, p.exitcode, len(lost))
            for r, wid in list(self._readers.items()):
                if wid == w:  # the dead worker's pipe, not yet at EOF here
                    del self._readers[r]
            # the dead worker's queue may hold tasks no process will read:
            # its feeder thread must not hold up this process's exit
            self._task_qs[w].cancel_join_thread()
            self._task_qs[w] = self._ctx.Queue()
            self._procs[w] = self._spawn(w)
            for s in lost:
                self._task_qs[w].put(self._pending[s].msg)

    # -- the two entry points --------------------------------------------

    def imap_records(self, tasks: Iterable[Tuple[int, tuple]]):
        """Ordered map over ``(roidb_index, scale)`` tasks → ``(actual_index,
        sample)`` (the ``_load_record_isolated`` contract), in task order,
        up to ``n_slots`` in flight.  The oldest outstanding task is always
        queued on or run by its worker, so the ordered assembly cannot
        deadlock.  Abandoned, it drains its outstanding tickets, so that
        their slots return to the ring the pool keeps."""
        tasks = list(tasks)
        tickets: collections.deque = collections.deque()
        i = 0
        try:
            while tickets or i < len(tasks):
                while i < len(tasks) and len(tickets) < self.n_slots:
                    idx, scale = tasks[i]
                    tickets.append(self._submit("record", int(idx), scale))
                    i += 1
                img, meta = self._wait(tickets.popleft())
                sample = {"images": img, **meta["sample"]}
                yield meta["index"], sample
        finally:
            while tickets:
                try:
                    self._wait(tickets.popleft())
                except Exception:
                    pass

    def prepare(self, image: np.ndarray, scale,
                timeout: Optional[float] = None):
        """Serving: ``stage_raw_to_bucket(image, scale, stride)`` in a
        worker (the raw uint8 in through the task queue, the staged pixels
        back through the ring) → ``(staged, raw_hw, ratio, im_info)``.
        Thread-safe; blocks the calling thread only, ``timeout`` seconds at
        most (None: no bound)."""
        seq = self._submit("image", np.ascontiguousarray(image), scale)
        img, meta = self._wait(seq, timeout)
        return img, meta["raw_hw"], meta["ratio"], meta["im_info"]
