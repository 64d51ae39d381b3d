"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py``, reduced to ``Speedometer``:
log throughput and the current train metrics every ``frequent``
batches, in the reference's log-line format
(``Epoch[e] Batch [n]\\tSpeed: r samples/sec\\tname=value``).
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer"]


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
        pairs = [] if metric is None else metric.get_name_value()
        if pairs:
            if self.auto_reset:
                metric.reset()
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                         param.epoch, param.nbatch, rate,
                         "".join("\t%s=%f" % (n, v) for n, v in pairs))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, rate)
