"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``,
reference python/mxnet/gluon/data/dataloader.py), with the batches made
in the calling thread (``num_workers=0``).  Worker processes and the
thread pool stay queued (ROADMAP A.6) and raise.  The default batchify
stacks samples into NDArrays on the current context (the card unless
the caller asks for the CPU).
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (reference default_batchify_fn):
    NDArrays with ``stack``, tuples field by field, anything else
    through numpy (float64 becomes float32)."""
    from ... import ndarray as nd
    if isinstance(data[0], nd.NDArray):
        return nd.stack(*data, axis=0)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(list(field)) for field in zip(*data)]
    return nd.array(np.asarray(data))


class DataLoader:
    """Batches of a Dataset (reference DataLoader)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, thread_pool=False):
        if num_workers or thread_pool:
            raise MXNetError("DataLoader workers (num_workers > 0, "
                             "thread_pool) are not in the PyTorch port yet "
                             "(ROADMAP A.6); use num_workers=0")
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise MXNetError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn

    def __iter__(self):
        for indices in self._batch_sampler:
            yield self._batchify_fn([self._dataset[i] for i in indices])

    def __len__(self):
        return len(self._batch_sampler)
