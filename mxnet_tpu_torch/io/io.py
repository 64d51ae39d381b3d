"""Data iterators.

Counterpart of ``mxnet_tpu/io/io.py``, reduced to what the training
slice uses: ``DataDesc``, ``DataBatch`` (with the bucketing fields),
the ``DataIter`` protocol and
``NDArrayIter`` (shuffle, ``last_batch_handle`` ``'pad'`` or
``'discard'``), and ``MNISTIter`` over MNIST's idx files.  Batches are
host (CPU) NDArrays; the executor copies them onto its device.  The shuffle draws from the port's host numpy
stream (``random.host_rng``), so ``mx.random.seed(s)`` gives the order
the JAX package gives after ``numpy.random.seed(s)``.
"""
from __future__ import annotations

import numpy as _np

from .. import random as _random
from ..base import MXNetError
from ..context import cpu
from ..ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "MNISTIter"]


class DataDesc:
    """Name, shape, dtype and layout of one input (reference io.py
    DataDesc); iterates as the ``(name, shape)`` pair."""

    def __init__(self, name, shape, dtype=_np.float32, layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layout = layout

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    def __iter__(self):
        yield self.name
        yield self.shape

    @staticmethod
    def get_list(shapes):
        return [d if isinstance(d, DataDesc) else DataDesc(d[0], d[1])
                for d in shapes]


class DataBatch:
    """One batch: its data and label arrays, the padding count, and for
    bucketed iterators (``mx.rnn.BucketSentenceIter``) the bucket key
    and the batch's own ``provide_data``/``provide_label``, which
    ``BucketingModule`` binds the bucket with (``mxnet_tpu/io/io.py:76-81``)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator protocol (reference io.py:182)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """``[(name, numpy array)]`` from an array, a list or a dict."""
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not data and not allow_empty:
            raise MXNetError("data cannot be empty")
        data = {default_name: data[0]} if len(data) == 1 else \
            {"_%d_%s" % (i, default_name): d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise MXNetError("Input must be NDArray, numpy.ndarray, list or "
                         "dict")
    return [(k, v.asnumpy() if isinstance(v, NDArray)
             else _np.asarray(v, dtype=_np.float32)) for k, v in data.items()]


class NDArrayIter(DataIter):
    """In-memory iterator (reference io.py:546): batches of ``data`` and
    ``label`` in order or shuffled, the last partial batch padded by
    wrapping around (``'pad'``) or dropped (``'discard'``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard"):
            raise MXNetError("NDArrayIter last_batch_handle=%r is not in the "
                             "PyTorch port yet" % (last_batch_handle,))
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.idx = _np.arange(self.num_data)
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        if shuffle:
            _random.host_rng().shuffle(self.idx)

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            _random.host_rng().shuffle(self.idx)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _slice(self, arrays):
        start, end = self.cursor, self.cursor + self.batch_size
        sel = self.idx[_np.arange(start, end) % self.num_data]
        return [NDArray(src[sel], ctx=cpu()) for _, src in arrays]

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def getindex(self):
        return self.idx[self.cursor:min(self.cursor + self.batch_size,
                                        self.num_data)]


class MNISTIter(DataIter):
    """Batches of an MNIST idx image file and its label file (reference
    src/io/iter_mnist.cc; ``mxnet_tpu/io/io.py`` ``MNISTIter``): pixels
    scaled to [0, 1] in float32, each image ``(1, 28, 28)`` or, with
    ``flat``, ``(784,)`` (or ``input_shape``), labels as floats, through
    an ``NDArrayIter`` that drops the last partial batch and, with
    ``shuffle``, draws its order from the port's host stream, so
    ``mx.random.seed(s)`` gives the batches the JAX package gives after
    ``numpy.random.seed(s)``.  ``.gz`` files are read through gzip;
    ``seed``, ``silent`` and other reference arguments change nothing,
    as in the JAX package."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=None,
                 input_shape=None, **kwargs):
        super().__init__(batch_size)
        imgs = self._read_idx(image).astype(_np.float32) / 255.0
        labels = self._read_idx(label)
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, imgs.shape[1],
                                imgs.shape[2])
        if input_shape is not None:
            imgs = imgs.reshape((imgs.shape[0],) + tuple(input_shape))
        self._inner = NDArrayIter(imgs, labels.astype(_np.float32),
                                  batch_size, shuffle=shuffle,
                                  last_batch_handle="discard")

    @staticmethod
    def _read_idx(path):
        """The array of an idx file: a big-endian magic whose low byte is
        the rank, the dimensions, then unsigned bytes."""
        import gzip
        import os
        import struct
        if not os.path.exists(path):
            raise MXNetError("MNIST file not found: %s" % path)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            ndim = struct.unpack(">I", f.read(4))[0] & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return _np.frombuffer(f.read(), dtype=_np.uint8).reshape(dims)

    def next(self):
        return self._inner.next()

    def reset(self):
        self._inner.reset()

    def iter_next(self):
        return self._inner.iter_next()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label
