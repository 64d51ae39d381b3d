"""mx.checkpoint: asynchronous, crash-safe, full-state checkpoints.

Counterpart of ``mxnet_tpu/checkpoint`` (the JAX package's
docs/CHECKPOINT.md), writing and reading the same files, so a
checkpoint of either package restores in the other.  The reference's
``save_checkpoint``/``do_checkpoint`` is a blocking, non-atomic,
parameters-only write: optimizer state, the 2-bit error-feedback
residuals, the random streams and the lr-scheduler position are lost
on restart.  This package keeps them:

* **Full state**: parameters, auxiliary states, name-keyed optimizer
  state (f32 masters included), error-feedback residuals (whichever
  owner holds them: the fused fit step, the bucketed kvstore or the
  store's dict), the loss scaler, the random streams, the lr-scheduler
  position, epoch and step (``snapshot.capture``).
* **Async**: the training thread waits only for the device-to-host
  copy (``checkpoint_block_ms``); serialization and IO run on a
  background writer (``writer.AsyncCheckpointWriter``).
* **Crash-safe**: tmp + fsync + atomic rename per file, a JSON manifest
  with per-tensor checksums as the commit point, keep-N rotation,
  retries with backoff on IO errors (``manifest.py``); :func:`latest`
  validates the checksums and falls back to the newest intact
  checkpoint.
* **Preemption**: a SIGTERM handler triggers an emergency synchronous
  save and a clean stop at the next step boundary
  (``preemption.PreemptionHandler``; wired by ``Module.fit``).
* **The reference's files**: ``<prefix>-%04d.params``,
  ``-symbol.json`` and ``.states`` keep their layout:
  ``Module.load`` and ``model.load_checkpoint`` read them.

Use::

    mod.fit(data, num_epoch=10, checkpoint_every=500,
            checkpoint_prefix="ckpt/run7")          # async, in the loop

    mgr = checkpoint.CheckpointManager("ckpt/run7", module=mod)
    mgr.save(epoch=3, step=1500)                    # explicit async save
    mgr.drain()

    man = checkpoint.latest("ckpt/run7")            # newest intact
    checkpoint.restore(mod2, "ckpt/run7")           # full-state resume

Checkpoints sharded over several processes (the JAX package's
``sharded.py`` and ``multihost.py``) come with the multi-GPU slice
(ROADMAP A.8): their entry points raise.
"""
from __future__ import annotations

import logging
import os
import time

from . import manifest
from . import preemption
from . import snapshot
from . import writer as writer_mod
from ..base import MXNetError
from .manifest import latest
from .preemption import PreemptionHandler
from .snapshot import capture, capture_params, load, restore, \
    write_checkpoint
from .writer import AsyncCheckpointWriter, write_with_retry

__all__ = ["CheckpointManager", "AsyncCheckpointWriter",
           "PreemptionHandler", "latest", "load", "resolve_params",
           "restore", "save", "capture", "capture_params",
           "write_checkpoint", "manifest", "snapshot", "preemption",
           "save_sharded", "load_sharded", "latest_sharded"]

_SHARDED_LATER = ("sharded and multi-host checkpoints come with the "
                  "multi-GPU slice of the PyTorch port (ROADMAP A.8)")


def save_sharded(*args, **kwargs):
    raise MXNetError("checkpoint.save_sharded: " + _SHARDED_LATER)


def load_sharded(*args, **kwargs):
    raise MXNetError("checkpoint.load_sharded: " + _SHARDED_LATER)


def latest_sharded(*args, **kwargs):
    raise MXNetError("checkpoint.latest_sharded: " + _SHARDED_LATER)


def resolve_params(prefix, tag=None, epoch=None, what="reload"):
    """A checkpoint reference as ``(arg_params, aux_params, version)``:
    ``epoch`` loads ``prefix-%04d.params`` directly, else ``tag`` (or
    the newest intact checkpoint) resolves through the manifest.  IO and
    corruption failures raise ``MXNetError`` prefixed with ``what``."""
    if epoch is not None:
        from .. import model as _model
        try:
            arg_params, aux_params = _model.load_params(prefix, epoch)
        except OSError as e:
            raise MXNetError("%s: %s" % (what, e)) from e
        return arg_params, aux_params, int(epoch)
    try:
        _sym, arg_params, aux_params, man = load(prefix, tag)
    except OSError as e:
        raise MXNetError("%s: %s" % (what, e)) from e
    return arg_params, aux_params, int(man["tag"])


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def save(prefix, tag, arg_params, aux_params=None, symbol=None,
         epoch=None, step=None, keep=0, retries=3, backoff=0.05):
    """Synchronous parameters checkpoint from dicts: the
    ``<prefix>-%04d.params`` file (and ``-symbol.json``) plus the
    manifest.  Returns the manifest."""
    state = capture_params(arg_params, aux_params, symbol=symbol,
                           epoch=epoch, step=step)
    return write_with_retry(state, prefix, tag, retries=retries,
                            backoff=backoff, keep=keep)


class CheckpointManager:
    """Drives the checkpoints of one training run.

    Parameters
    ----------
    prefix : checkpoint path prefix (``dir/name``); files follow the
        ``%s-%04d.*`` layout.
    module : the Module whose state is captured (optional for
        restore-only use).
    every : steps between the saves :meth:`tick` makes (0: only
        explicit :meth:`save` calls).
    keep : keep-N rotation (default ``MXNET_CHECKPOINT_KEEP`` or 3; 0
        keeps everything).
    async_write : serialize and write on the background writer (the
        default); False makes every save synchronous.
    save_optimizer : include the optimizer state and its position.
    install_preemption : install the SIGTERM emergency-save handler
        (default: ``MXNET_CHECKPOINT_PREEMPT`` is not 0).
    retries / backoff : the retry policy of each write.
    """

    def __init__(self, prefix, module=None, every=0, keep=None,
                 async_write=True, save_optimizer=True,
                 install_preemption=None, retries=3, backoff=0.05,
                 logger=None):
        d = os.path.dirname(prefix)
        if d and not os.path.isdir(d):
            os.makedirs(d, exist_ok=True)
        self.prefix = prefix
        self.every = int(every or 0)
        self.keep = _env_int("MXNET_CHECKPOINT_KEEP", 3) \
            if keep is None else int(keep)
        self.logger = logger or logging
        self._module = module
        self._async = bool(async_write)
        self._save_optimizer = bool(save_optimizer)
        self._retries = retries
        self._backoff = backoff
        self._writer = AsyncCheckpointWriter(retries=retries,
                                             backoff=backoff,
                                             logger=self.logger)
        # continue the tag sequence past the checkpoints already there:
        # a resumed run's tags must come above the restore point, or
        # latest() would keep resolving to the state before it
        self._steps = max(manifest.list_tags(prefix), default=0)
        self._closed = False
        if install_preemption is None:
            install_preemption = os.environ.get(
                "MXNET_CHECKPOINT_PREEMPT", "1") != "0"
        self._preempt = PreemptionHandler(logger=self.logger).install() \
            if install_preemption else None

    # -- state ----------------------------------------------------------
    @property
    def preempted(self):
        return self._preempt is not None and self._preempt.triggered

    @property
    def preemption(self):
        return self._preempt

    # -- saving ---------------------------------------------------------
    def save(self, epoch=None, step=None, tag=None, block=False):
        """Snapshot the module now (waiting only for the device-to-host
        copy) and commit it: on the writer's thread normally, here when
        ``block`` or the manager is synchronous.  Returns the manifest
        of a commit made here, None for a queued one."""
        if self._module is None:
            raise ValueError("CheckpointManager needs a module to save")
        t0 = time.perf_counter()
        state = capture(self._module, epoch=epoch, step=step,
                        include_optimizer=self._save_optimizer)
        if tag is None:
            tag = step
        if tag is None:
            self._steps += 1       # explicit save: advance, never
            tag = self._steps      # overwrite the newest tag
        try:
            self._steps = max(self._steps, int(tag))
        except (TypeError, ValueError):
            pass
        if block or not self._async:
            # a commit made here counts in checkpoint_save_ms only:
            # checkpoint_block_ms stays the async path's snapshot cost
            return write_with_retry(state, self.prefix, tag,
                                    retries=self._retries,
                                    backoff=self._backoff,
                                    logger=self.logger, keep=self.keep)
        self._writer.submit(state, self.prefix, tag, keep=self.keep)
        writer_mod.BLOCK_MS.observe((time.perf_counter() - t0) * 1e3)
        return None

    def emergency_save(self, epoch=None, step=None):
        """Preemption: drain the queued async writes first (two threads
        must never write one prefix at once), then one synchronous full
        save of the freshest state."""
        self.logger.warning(
            "checkpoint: emergency save to %s (step %s)", self.prefix,
            step if step is not None else self._steps)
        self._writer.drain()
        return self.save(epoch=epoch, step=step, block=True)

    def tick(self, epoch=None):
        """Per-step hook of the fit loop: counts steps, saves every
        ``every``-th, and on a pending preemption makes the emergency
        save.  Returns True when the loop should stop (preempted)."""
        self._steps += 1
        if self.preempted:
            self.emergency_save(epoch=epoch, step=self._steps)
            return True
        if self.every and self._steps % self.every == 0:
            self.save(epoch=epoch, step=self._steps)
        return False

    # -- reading --------------------------------------------------------
    def latest(self):
        return latest(self.prefix)

    def restore(self, module=None, tag=None):
        return restore(module if module is not None else self._module,
                       self.prefix, tag=tag, logger=self.logger)

    # -- lifecycle ------------------------------------------------------
    def drain(self, timeout=None):
        return self._writer.drain(timeout)

    def close(self, timeout=None):
        """Drain pending writes, stop the writer, restore the signal
        handlers.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._writer.close(timeout)
        if self._preempt is not None:
            self._preempt.uninstall()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
