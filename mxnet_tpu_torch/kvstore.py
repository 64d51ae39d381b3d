"""KVStore: key-value parameter synchronization on one process.

Counterpart of ``mxnet_tpu/kvstore.py`` (reference include/mxnet/kvstore.h,
src/kvstore/kvstore_local.h), for the single-process stores ``'local'``
and ``'device'`` (and their ``local_*`` aliases).  A push reduces each
key's device streams, optionally through 2-bit compression with
error feedback (``parallel/compression.py``), then applies the
optimizer to the stored weight (``set_optimizer``) or stores the
reduced value; a pull copies the stored value out.

Dense f32 pushes, and bf16 or f16 ones under an optimizer, take the
bucketed path (``kvstore_fused.py``) unless ``MXNET_KVSTORE_FUSED=0``;
custom updaters and optimizers without a fused signature take the eager
per-key path, with the same results.  16-bit values reduce in their own
type; with 2-bit compression each stream is widened to f32 first, so
residuals and the reduced gradient are f32 (the master-gradient view)
and a stored 16-bit weight is updated through its f32 master by the
``Updater``, as in the JAX package.
The distributed, ``'tpu'`` and ``'nccl'`` stores come with the
multi-GPU slice; row-sparse push and pull with the sparse slice.
"""
from __future__ import annotations

import logging
import os

import torch

from . import optimizer as opt
from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["KVStore", "create"]

_LOCAL_TYPES = ("local", "local_update_cpu", "local_allreduce_cpu",
                "local_allreduce_device", "device")


def create(name="local"):
    """A KVStore by type name (reference kvstore.cc:40): ``'local'``,
    ``'device'`` and the ``local_*`` aliases.  ``'dist*'``, ``'tpu'`` and
    ``'nccl'`` raise: they come with the multi-GPU slice."""
    if not isinstance(name, str):
        raise TypeError("name must be str")
    if name in _LOCAL_TYPES:
        return KVStore(name)
    if name.startswith("dist") or name in ("nccl", "tpu", "tpu_device"):
        raise MXNetError("kvstore %r comes with the multi-GPU slice of the "
                         "PyTorch port (ROADMAP A.8)" % name)
    raise MXNetError("unknown kvstore type '%s'" % name)


class KVStore:
    """Single-process kvstore (reference kvstore_local.h:53).  Stored
    values live on the device of the value given to ``init``."""

    def __init__(self, name="local"):
        self._type = name
        self._store = {}
        self._updater = None
        self._compression = None
        self._compression_residuals = {}
        self._bucketed = os.environ.get("MXNET_KVSTORE_FUSED", "1") != "0"
        self._async_push = False
        self._engine = None
        self._warned = set()        # reasons a key left the bucketed path

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        """Store a copy of each key's first value (keys already present
        keep theirs)."""
        keys, values = _key_value(key, value)
        for k, vlist in zip(keys, values):
            if k not in self._store:
                self._store[k] = vlist[0].copy()

    def push(self, key, value, priority=0):
        """Reduce each key's device streams (reference
        KVStoreLocal::PushImpl, kvstore_local.h:168), through 2-bit
        compression when set, then update or store.  ``priority`` (an
        int, or one per key) orders the bucketed dispatch, highest
        first.  With async push the buckets wait for a sync point
        (``pull``, ``barrier``)."""
        keys, values = _key_value(key, value)
        if isinstance(priority, (list, tuple)):
            if len(priority) != len(keys):
                raise MXNetError("push: %d priorities for %d keys"
                                 % (len(priority), len(keys)))
            prios = list(priority)
        else:
            prios = [priority] * len(keys)
        eng = self._get_engine()
        mode = eng._updater_mode() if eng is not None else False
        for k, vlist, prio in zip(keys, values, prios):
            reason = eng.ineligible_reason(k, vlist, mode) \
                if eng is not None else None
            if eng is not None and reason is None:
                eng.enqueue(k, vlist, prio)
            else:
                if eng is not None and reason not in self._warned:
                    self._warned.add(reason)
                    logging.warning("kvstore: key %r takes the eager "
                                    "per-key path (%s)", k, reason)
                self._push_one(k, vlist)
        if eng is not None and not self._async_push:
            eng.flush()

    def _push_one(self, k, vlist):
        """Eager per-key push: compress each stream, reduce, update or
        store (the reference shape, and the parity oracle of the
        bucketed path)."""
        if self._compression is not None:
            vlist = [self._compress(k, i, v) for i, v in enumerate(vlist)]
        reduced = self._local_reduce(vlist)
        if self._updater is not None:
            if k not in self._store:
                raise MXNetError("key %s not initialized" % k)
            self._updater(_updater_key(k), reduced, self._store[k])
        else:
            self._store[k] = reduced.copy()

    def _get_engine(self):
        if not self._bucketed:
            return None
        if self._engine is None:
            from .kvstore_fused import FusedBucketEngine
            self._engine = FusedBucketEngine(self)
        return self._engine

    def _flush_pending(self):
        if self._engine is not None:
            self._engine.flush()

    def _sync_engine(self):
        """Flush pending buckets under the current mode, then spill the
        flat residuals back to the per-key dict.  Every entry point that
        changes push routing calls this first."""
        self._flush_pending()
        if self._engine is not None:
            self._engine.spill_residuals()

    def set_bucketing(self, enabled):
        """Turn the bucketed path on or off (pending pushes flushed and
        flat residuals spilled first)."""
        self._sync_engine()
        self._bucketed = bool(enabled)

    def set_async_push(self, enabled):
        """Defer bucket dispatch to the next sync point (``pull``,
        ``barrier``)."""
        if not enabled:
            self._flush_pending()
        self._async_push = bool(enabled)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's stored value INTO the given arrays, in place
        (a bound executor's parameters keep their tensors, which require
        grad; the optimizer updates the store's own tensor in place, so
        the two never alias)."""
        keys, outs = _key_value(key, out)
        self._flush_pending()
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % k)
            src = self._store[k]._data
            with torch.no_grad():
                for o in olist:
                    if tuple(o.shape) != tuple(src.shape):
                        raise MXNetError("pull: key %s has shape %s, out %s"
                                         % (k, tuple(src.shape), o.shape))
                    o._data.copy_(src)

    def set_updater(self, updater):
        self._sync_engine()
        self._updater = updater

    def set_optimizer(self, optimizer):
        self.set_updater(opt.get_updater(optimizer))

    def set_gradient_compression(self, compression_params):
        """2-bit gradient compression (reference kvstore.py:392)."""
        self._sync_engine()
        ctype = compression_params.get("type", "2bit")
        if ctype not in ("2bit",):
            raise MXNetError("unsupported compression type %s" % ctype)
        from .parallel.compression import TwoBitCompressor
        self._compression = TwoBitCompressor(
            threshold=float(compression_params.get("threshold", 0.5)))

    @staticmethod
    def _local_reduce(vlist):
        """Sum a per-device value list in order (the Comm::Reduce
        analog)."""
        if len(vlist) == 1:
            return vlist[0]
        acc = vlist[0]._data
        dev = acc.device
        for v in vlist[1:]:
            acc = acc + v._data.to(dev)
        return NDArray(acc)

    def _get_residual(self, res_key, like):
        """The f32 error-feedback residual of one (key, stream), zeros
        shaped and placed like the tensor ``like`` on first use."""
        residual = self._compression_residuals.get(res_key)
        if residual is None:
            residual = NDArray(torch.zeros(like.shape, dtype=torch.float32,
                                           device=like.device))
            self._compression_residuals[res_key] = residual
        return residual

    def _compress(self, key, dev_idx, grad):
        residual = self._get_residual((key, dev_idx), grad._data)
        out, new_residual = self._compression.compress_decompress(
            grad._data.float(), residual._data)
        residual._set_data(new_residual)
        return NDArray(out)

    def barrier(self):
        self._flush_pending()

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Write the updater's states (with the optimizer when
        ``dump_optimizer``) to ``fname``."""
        if self._updater is None:
            raise MXNetError("no updater/optimizer set")
        self._flush_pending()
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        """Load a :meth:`save_optimizer_states` file (either
        package's) into the updater."""
        if self._updater is None:
            raise MXNetError("no updater/optimizer set")
        self._flush_pending()
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


def _updater_key(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def _key_value(key, value):
    """(list of keys, list of value lists) from one key or a list."""
    if isinstance(key, (str, int)):
        key, value = [key], [value]
    else:
        key = list(key)
        if value is None:
            value = [None] * len(key)
    out_vals = []
    for v in value:
        if v is None:
            out_vals.append(None)
        elif isinstance(v, NDArray):
            out_vals.append([v])
        else:
            out_vals.append(list(v))
    return key, out_vals
