"""Background checkpoint writer: the training loop never waits on IO.

Counterpart of ``mxnet_tpu/checkpoint/writer.py``, with the same
telemetry names.  ``AsyncCheckpointWriter`` owns a daemon thread
draining a bounded job queue; each job serializes a snapshot already
copied to the host (``snapshot.capture``) and publishes it through the
crash-safe manifest protocol.  Transient IO errors retry with
exponential backoff; a job that exhausts its retries is logged and
counted (``checkpoint_failures``) without stopping training.  After
every commit the writer applies keep-N rotation.  An atexit hook drains
the queue so a job that exits normally keeps its last checkpoint.
"""
from __future__ import annotations

import atexit
import logging
import queue
import threading
import time

from . import manifest as _mf
from . import snapshot as _snap
from ..telemetry import REGISTRY

__all__ = ["AsyncCheckpointWriter", "BLOCK_MS", "SAVE_MS", "BYTES",
           "QUEUE_DEPTH", "SAVES", "FAILURES"]

BLOCK_MS = REGISTRY.histogram(
    "checkpoint_block_ms",
    "training-thread blocking time per checkpoint (device->host snapshot "
    "+ enqueue; the async path's only cost)", unit="ms")
SAVE_MS = REGISTRY.histogram(
    "checkpoint_save_ms",
    "wall time to serialize + atomically publish one checkpoint "
    "(writer thread for async saves)", unit="ms")
BYTES = REGISTRY.counter(
    "checkpoint_bytes", "cumulative bytes committed to checkpoints",
    unit="bytes")
QUEUE_DEPTH = REGISTRY.gauge(
    "checkpoint_queue_depth", "snapshots waiting in the async writer queue")
SAVES = REGISTRY.counter(
    "checkpoint_saves", "checkpoints committed (manifest published)")
FAILURES = REGISTRY.counter(
    "checkpoint_failures", "checkpoint writes abandoned after retries")


def write_with_retry(state, prefix, tag, retries=3, backoff=0.05,
                     logger=None, keep=0):
    """Serialize+publish one checkpoint with retry-with-backoff on
    OSError (transient NFS/GCS-fuse blips), then keep-N rotation.
    Returns the manifest; raises after the final attempt fails."""
    log = logger or logging
    t0 = time.perf_counter()
    attempt = 0
    while True:
        try:
            man = _snap.write_checkpoint(state, prefix, tag)
            break
        except OSError as e:
            attempt += 1
            if attempt > retries:
                FAILURES.inc()
                raise
            delay = backoff * (2 ** (attempt - 1))
            log.warning("checkpoint %s tag %s: write failed (%s), "
                        "retry %d/%d in %.2fs", prefix, tag, e,
                        attempt, retries, delay)
            time.sleep(delay)
    SAVE_MS.observe((time.perf_counter() - t0) * 1e3)
    SAVES.inc()
    BYTES.inc(int(man.get("total_bytes", 0)))
    if keep and keep > 0:
        for old in _mf.list_tags(prefix)[:-keep]:
            _mf.delete_checkpoint(prefix, old)
    return man


class AsyncCheckpointWriter:
    """One daemon writer thread + bounded-latency drain support."""

    def __init__(self, retries=3, backoff=0.05, logger=None,
                 max_pending=4):
        self.retries = retries
        self.backoff = backoff
        self.logger = logger or logging
        # bounded: each queued job holds a full host copy of the
        # training state, so a writer slower than the save cadence must
        # apply backpressure (submit blocks) instead of growing RSS by
        # one model per outstanding snapshot until OOM
        self._q = queue.Queue(maxsize=max(int(max_pending), 1))
        self._thread = None
        self._lock = threading.Lock()
        self._closed = False

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="mx-checkpoint-writer",
                    daemon=True)
                self._thread.start()
                atexit.register(self.drain, 60.0)

    def submit(self, state, prefix, tag, keep=0):
        """Enqueue one snapshot for background commit. Non-blocking
        until ``max_pending`` snapshots are in flight; beyond that the
        put blocks — backpressure, not unbounded host memory."""
        if self._closed:
            raise RuntimeError("checkpoint writer is closed")
        self._ensure_thread()
        if self._q.full():
            self.logger.warning(
                "checkpoint writer saturated (%d pending) — save cadence "
                "outruns storage; blocking until a slot frees",
                self._q.qsize())
        self._q.put((state, prefix, tag, keep))
        QUEUE_DEPTH.set(self._q.qsize())

    def _run(self):
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                state, prefix, tag, keep = job
                try:
                    write_with_retry(state, prefix, tag,
                                     retries=self.retries,
                                     backoff=self.backoff,
                                     logger=self.logger, keep=keep)
                except Exception:
                    # already counted by write_with_retry where it
                    # applies; never kill the writer loop
                    self.logger.exception(
                        "checkpoint %s tag %s: abandoned after %d "
                        "retries", prefix, tag, self.retries)
            finally:
                self._q.task_done()
                QUEUE_DEPTH.set(self._q.qsize())

    @property
    def pending(self):
        return self._q.unfinished_tasks

    def drain(self, timeout=None):
        """Block until every submitted checkpoint has committed (or
        ``timeout`` seconds elapsed). Returns True when fully drained."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._q.unfinished_tasks:
            if self._thread is None or not self._thread.is_alive():
                return self._q.unfinished_tasks == 0
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.005)
        return True

    def close(self, timeout=None):
        """Drain, then stop the writer thread. Idempotent, and bounded
        by ``timeout`` even when storage is wedged: if the queue never
        drained, the stop sentinel is only best-effort enqueued (the
        thread is a daemon — it cannot hold up process exit)."""
        if self._closed:
            return
        self._closed = True
        ok = self.drain(timeout)
        if self._thread is not None and self._thread.is_alive():
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass
            self._thread.join(timeout)
        return ok
