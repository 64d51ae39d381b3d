"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py``: ``Speedometer`` (throughput
and the current train metrics every ``frequent`` batches, in the
reference's log-line format, ``Epoch[e] Batch [n]\\tSpeed: r
samples/sec\\tname=value``), ``ProgressBar``, ``log_train_metric``
(``Iter[e] Batch[n] Train-name=value`` every ``period`` batches),
``LogValidationMetricsCallback`` and the epoch-end checkpoint callbacks
``do_checkpoint`` and ``module_checkpoint``.  A callback that reads a
metric folds the fused step's device accumulator in (a host sync), so
its period sets how often the fit loop waits for the card.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint",
           "module_checkpoint", "log_train_metric",
           "LogValidationMetricsCallback"]


def _metric_pairs(metric):
    return [] if metric is None else list(metric.get_name_value())


class Speedometer:
    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._mark = None
        self._mark_count = 0

    def __call__(self, param):
        """``param`` is a ``model.BatchEndParam``."""
        count, now = param.nbatch, time.monotonic()
        if self._mark is None or count < self._mark_count:
            self._mark, self._mark_count = now, count    # (re)arm
            return
        if count - self._mark_count < self.frequent or count % self.frequent:
            return
        rate = (count - self._mark_count) * self.batch_size \
            / max(now - self._mark, 1e-9)
        self._mark, self._mark_count = now, count
        metric = param.eval_metric
        pairs = _metric_pairs(metric)
        if pairs:
            if self.auto_reset:
                metric.reset()
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                         param.epoch, param.nbatch, rate,
                         "".join("\t%s=%f" % (n, v) for n, v in pairs))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, rate)


class ProgressBar:
    """Log ``[===---] pct%`` of the epoch at each batch end (``total``
    batches an epoch)."""

    def __init__(self, total, length=80):
        self.total = total
        self.bar_len = length

    def __call__(self, param):
        frac = min(max(param.nbatch / float(self.total), 0.0), 1.0)
        n_fill = round(self.bar_len * frac)
        bar = "=" * n_fill + "-" * (self.bar_len - n_fill)
        logging.info("[%s] %s%s\r", bar, -(-int(frac * 1000) // 10), "%")


def do_checkpoint(prefix, period=1, async_write=False):
    """Epoch-end callback saving ``prefix-symbol.json`` and
    ``prefix-%04d.params`` every ``period`` epochs
    (``model.save_checkpoint``).  ``async_write=True`` hands the saved
    parameters to ``mx.checkpoint``'s background writer, which commits
    the same epoch-numbered files crash-safely with a manifest; call
    ``.drain()`` on the callback before reading them."""
    stride = max(int(period), 1)
    writer = None

    def _on_epoch_end(epoch, sym, arg, aux):
        nonlocal writer
        done = epoch + 1
        if done % stride:
            return
        if not async_write:
            from .model import save_checkpoint
            save_checkpoint(prefix, done, sym, arg, aux)
            return
        from . import checkpoint as _ckpt
        if writer is None:
            writer = _ckpt.AsyncCheckpointWriter()
        writer.submit(_ckpt.capture_params(arg, aux, symbol=sym, epoch=done),
                      prefix, done)

    def _drain(timeout=None):
        """Wait for the queued saves (a no-op when writing in place)."""
        return True if writer is None else writer.drain(timeout)

    def _close(timeout=None):
        """Drain and stop the writer thread."""
        return True if writer is None else writer.close(timeout)

    _on_epoch_end.drain = _drain
    _on_epoch_end.close = _close
    return _on_epoch_end


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False,
                      async_write=False):
    """Epoch-end callback calling ``mod.save_checkpoint`` every
    ``period`` epochs.  ``async_write=True`` makes it a full
    ``mx.checkpoint`` snapshot (optimizer state with
    ``save_optimizer_states``, residuals, random streams, lr position)
    committed on the background writer under the same epoch-numbered
    files, which ``Module.load(prefix, epoch)`` reads."""
    stride = max(int(period), 1)
    manager = None

    def _on_epoch_end(epoch, sym=None, arg=None, aux=None):
        nonlocal manager
        done = epoch + 1
        if done % stride:
            return
        if not async_write:
            mod.save_checkpoint(prefix, done, save_optimizer_states)
            return
        if manager is None:
            from .checkpoint import CheckpointManager
            manager = CheckpointManager(
                prefix, module=mod, keep=0,
                save_optimizer=save_optimizer_states,
                install_preemption=False)
        manager.save(epoch=done, tag=done)

    def _drain(timeout=None):
        """Wait for the queued saves (a no-op when writing in place)."""
        return True if manager is None else manager.drain(timeout)

    def _close(timeout=None):
        """Drain and stop the manager's writer thread."""
        if manager is not None:
            manager.close(timeout)
        return True

    _on_epoch_end.drain = _drain
    _on_epoch_end.close = _close
    return _on_epoch_end


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the train metrics every ``period``
    batches (``Iter[e] Batch[n] Train-name=value``), resetting the
    metric after each log with ``auto_reset``."""

    def _on_batch_end(param):
        if param.nbatch % period:
            return
        for name, value in _metric_pairs(param.eval_metric):
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset and param.eval_metric is not None:
            param.eval_metric.reset()
    return _on_batch_end


class LogValidationMetricsCallback:
    """Eval-end callback logging ``Epoch[e] Validation-name=value``."""

    def __call__(self, param):
        for name, value in _metric_pairs(param.eval_metric):
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
