"""Index samplers for DataLoader (counterpart of
``mxnet_tpu/gluon/data/sampler.py``, reference
python/mxnet/gluon/data/sampler.py): the same classes and
``last_batch`` policies.  RandomSampler shuffles with the port's host
stream (``random.host_rng``), which ``mx.random.seed`` seeds."""
from __future__ import annotations

from ... import random as _random

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]

_LAST_BATCH_POLICIES = ("keep", "discard", "rollover")


class Sampler:
    """Iterable over sample indices with a known length."""

    def __len__(self):
        raise NotImplementedError

    def __iter__(self):
        raise NotImplementedError


class _RangeSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __len__(self):
        return self._length


class SequentialSampler(_RangeSampler):
    """Indices 0..length-1 in order."""

    def __iter__(self):
        yield from range(self._length)


class RandomSampler(_RangeSampler):
    """A fresh uniform permutation of 0..length-1 each epoch."""

    def __iter__(self):
        yield from _random.host_rng().permutation(self._length).tolist()


class BatchSampler(Sampler):
    """Group an index sampler into batch-sized lists.

    ``last_batch`` controls the final partial batch: ``'keep'`` yields it
    short, ``'discard'`` drops it, ``'rollover'`` saves it to lead the next
    epoch.
    """

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in _LAST_BATCH_POLICIES:
            raise ValueError(
                f"last_batch must be one of 'keep', 'discard', or "
                f"'rollover', but got {last_batch}")
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        pending = self._prev
        self._prev = []
        for idx in self._sampler:
            pending.append(idx)
            if len(pending) == self._batch_size:
                yield pending
                pending = []
        if not pending:
            return
        if self._last_batch == "keep":
            yield pending
        elif self._last_batch == "rollover":
            self._prev = pending
        # 'discard': drop the remainder

    def __len__(self):
        n, b = len(self._sampler), self._batch_size
        if self._last_batch == "keep":
            return -(-n // b)
        if self._last_batch == "discard":
            return n // b
        return (n + len(self._prev)) // b  # rollover
