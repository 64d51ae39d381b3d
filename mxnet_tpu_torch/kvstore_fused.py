"""The bucketed kvstore push path.

Counterpart of ``mxnet_tpu/kvstore_fused.py``.  A batched ``push`` packs
the dense f32 gradients into buckets of at most
``MXNET_KVSTORE_BIGARRAY_BOUND`` bytes (default 4 MiB, the analog of
MXNet's big-array bound; a larger value gets a bucket of its own), and
each bucket runs as one short sequence of eager calls:

    with 2-bit compression: per device stream, ``torch.cat`` of the
      gradients' flat f32 views, then ONE ``two_bit_quantize_fused``
      launch against the bucket's persistent flat error-feedback
      residual; the quantized streams summed in device order; the sum
      sliced back per key;
    without: each key's device streams summed in order;
    then the optimizer applied per key through the store's ``Updater``
      (the in-place ops of ``ops/optimizer_ops.py``), or, with no
      updater, the reduced value stored.

The JAX package runs the same op sequence as one compiled program per
bucket (SGD apply: ``fused_sgd_apply``, the op sequence of
``ops/optimizer_ops.py``), so the two packages agree bit for bit on the
compressor and to the last ulp on the update.  PyTorch runs eagerly:
there is no program cache and nothing to retrace.  Capturing the
buckets in a CUDA graph comes with the fused fit step.

Pushes carry ``priority=``; buckets form and dispatch in descending
priority, then arrival.  Once a bucket's worth of bytes is pending, the
full buckets go out at once (the streaming flush) and the partial tail
waits for the end of the push or the next sync point.

Custom updaters and optimizers that are not ``bucketable`` take the
eager per-key path (``KVStore._push_one``) with the same semantics.
"""
from __future__ import annotations

import os

import torch

from .kernels import two_bit_quantize_fused
from .ndarray.ndarray import NDArray

__all__ = ["FusedBucketEngine", "bucket_byte_cap", "two_bit_quantize"]

_DEFAULT_BUCKET_BYTES = 4 << 20


def two_bit_quantize(residual, grad, threshold):
    """Error-feedback 2-bit quantize of one device stream: ``(q,
    new_residual)``.  The one function every compressing path calls (the
    bucket engine and ``TwoBitCompressor.compress_decompress``): the
    CUDA kernel for tensors on the card, its plain version for tensors
    on the CPU."""
    return two_bit_quantize_fused(residual, grad, threshold)


def bucket_byte_cap():
    """Flat-bucket size cap in bytes (env ``MXNET_KVSTORE_BIGARRAY_BOUND``,
    default 4 MiB).  A single value larger than the cap gets its own
    bucket, like the reference's big-array bypass."""
    return int(os.environ.get("MXNET_KVSTORE_BIGARRAY_BOUND",
                              _DEFAULT_BUCKET_BYTES))


class _Pending:
    """One key's pushed device streams.  ``data`` holds the gradient
    tensors as pushed; with async push (flushed after ``push`` returns)
    they are cloned, so a later in-place write to the pushed array does
    not change what the flush applies (MXNet's push-at-call semantics)."""

    __slots__ = ("key", "data", "priority", "seq", "size", "shape",
                 "itemsize")

    def __init__(self, key, vlist, priority, seq, snapshot):
        self.key = key
        self.data = [v._data.detach().clone() if snapshot
                     else v._data.detach() for v in vlist]
        self.priority = priority
        self.seq = seq
        self.shape = tuple(self.data[0].shape)
        self.size = self.data[0].numel()
        self.itemsize = self.data[0].element_size()

    @property
    def n_dev(self):
        return len(self.data)

    @property
    def nbytes(self):
        return self.size * self.itemsize


class FusedBucketEngine:
    """Per-store pending queue, bucket planner and flat residuals."""

    def __init__(self, kv):
        self._kv = kv
        self._pending = []
        self._pending_keys = set()
        self._pending_bytes = 0
        self._seq = 0
        # flat error-feedback residuals: keys_tuple -> {"layout",
        # "res": [per-stream flat f32 tensor]}; seeded from and spilled
        # to the store's per-(key, stream) dict, so switching paths
        # never loses an accumulated residual
        self._flat_res = {}
        self.last_flush_buckets = []   # [[keys]] in dispatch order
        self.stats = {"flushes": 0, "buckets": 0, "keys": 0,
                      "bytes_pushed": 0}

    # -- eligibility ----------------------------------------------------
    def _updater_mode(self):
        """None with no updater (the reduced value is stored), True for
        an ``Updater`` whose optimizer is ``bucketable``, or False when
        updates must stay on the eager path."""
        from .optimizer import Updater
        updater = self._kv._updater
        if updater is None:
            return None
        return isinstance(updater, Updater) and updater.optimizer.bucketable

    def ineligible_reason(self, key, vlist, mode):
        """None when the push may take the bucketed path, else a short
        reason slug (``mode``: :meth:`_updater_mode`, computed once per
        push call)."""
        if mode is False:
            from .optimizer import Updater
            updater = self._kv._updater
            if not isinstance(updater, Updater):
                return "custom_updater"
            return ("unfused_optimizer:%s"
                    % type(updater.optimizer).__name__)
        for v in vlist:
            if not isinstance(v, NDArray):
                return "non_ndarray_value"
            if v._data.dtype != torch.float32:
                # bf16 and f16 gradients come with the bf16 slice
                return "non_f32_dtype"
            if v.shape != vlist[0].shape:
                return "mismatched_device_shapes"
        if mode is not None:
            stored = self._kv._store.get(key)
            if stored is None:
                return "key_not_initialized"
            if stored._data.dtype != vlist[0]._data.dtype \
                    or stored.shape != vlist[0].shape:
                return "stored_value_mismatch"
        return None

    # -- queue ----------------------------------------------------------
    @property
    def has_pending(self):
        return bool(self._pending)

    def enqueue(self, key, vlist, priority):
        if key in self._pending_keys:
            # two pushes of one key without a sync point: keep push
            # order by flushing the first
            self.flush()
        it = _Pending(key, vlist, priority, self._seq,
                      snapshot=self._kv._async_push)
        self._pending.append(it)
        self._pending_keys.add(key)
        self._pending_bytes += it.nbytes
        self._seq += 1
        # streaming flush: once a bucket's worth is pending, dispatch the
        # full buckets now (the partial tail stays pending)
        if self._pending_bytes >= bucket_byte_cap():
            self.flush(keep_partial=True)

    # -- planning -------------------------------------------------------
    def _pack(self, items):
        """Greedy size-capped packing in (priority desc, arrival) order;
        a new bucket starts when the cap would overflow or the stream
        count changes; an oversized value gets its own bucket.  (Every
        bucketed value is f32, so, unlike the JAX package's, no bucket
        splits on a dtype change.)"""
        cap = bucket_byte_cap()
        buckets, cur, cur_bytes = [], [], 0
        for it in items:
            if cur and (cur_bytes + it.nbytes > cap
                        or it.n_dev != cur[0].n_dev):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(it)
            cur_bytes += it.nbytes
            if cur_bytes >= cap:
                buckets.append(cur)
                cur, cur_bytes = [], 0
        if cur:
            buckets.append(cur)
        return buckets

    # -- flush ----------------------------------------------------------
    def flush(self, keep_partial=False):
        """Dispatch the pending pushes as buckets (priority desc, then
        arrival).  With ``keep_partial`` (the streaming path), a trailing
        bucket still below the byte cap stays pending."""
        if not self._pending:
            return
        items = sorted(self._pending, key=lambda it: (-it.priority, it.seq))
        self._pending = []
        self._pending_keys.clear()
        self._pending_bytes = 0
        buckets = self._pack(items)
        if keep_partial and buckets:
            tail = buckets[-1]
            if sum(it.nbytes for it in tail) < bucket_byte_cap():
                buckets = buckets[:-1]
                for it in tail:
                    self._pending.append(it)
                    self._pending_keys.add(it.key)
                    self._pending_bytes += it.nbytes
            if not buckets:
                return
        self.last_flush_buckets = [[it.key for it in b] for b in buckets]
        mode = self._updater_mode()
        for bucket in buckets:
            self._dispatch(bucket, mode)
        items = [it for b in buckets for it in b]
        self.stats["flushes"] += 1
        self.stats["buckets"] += len(buckets)
        self.stats["keys"] += len(items)
        self.stats["bytes_pushed"] += sum(it.nbytes * it.n_dev
                                          for it in items)

    def _dispatch(self, bucket, mode):
        """One bucket: compress and reduce the device streams, then apply
        or store per key (``kvstore_fused.py:599`` of the JAX package)."""
        from .kvstore import _updater_key
        kv = self._kv
        comp = kv._compression
        n_dev = bucket[0].n_dev
        dev0 = bucket[0].data[0].device
        # CommDevice gather: every stream joins the first one's device
        grads = [[it.data[d].to(dev0) for it in bucket]
                 for d in range(n_dev)]
        if comp is None:
            reduced = []
            for i in range(len(bucket)):
                acc = grads[0][i]
                for d in range(1, n_dev):
                    acc = acc + grads[d][i]
                reduced.append(acc)
        else:
            layout, off = [], 0
            for it in bucket:
                layout.append((off, it.size, it.shape))
                off += it.size
            layout = tuple(layout)
            keys_tuple = tuple(it.key for it in bucket)
            residuals = self._flat_residuals(keys_tuple, layout, n_dev,
                                             bucket)
            dev_q, new_res = [], []
            for d in range(n_dev):
                parts = [g.reshape(-1).float() for g in grads[d]]
                flat_g = parts[0] if len(parts) == 1 else torch.cat(parts)
                q, r = two_bit_quantize(residuals[d], flat_g,
                                        comp.threshold)
                dev_q.append(q)
                new_res.append(r)
            self._flat_res[keys_tuple]["res"] = new_res
            flat = dev_q[0]
            for q in dev_q[1:]:
                flat = flat + q
            reduced = [flat[o:o + size].view(shape)
                       for o, size, shape in layout]
        if mode is None:
            for it, out in zip(bucket, reduced):
                # a lone uncompressed stream is the pushed tensor itself
                kv._store[it.key] = NDArray(
                    out.clone() if out is it.data[0] else out)
        else:
            for it, g in zip(bucket, reduced):
                kv._updater(_updater_key(it.key), NDArray(g),
                            kv._store[it.key])

    # -- flat error-feedback residuals ---------------------------------
    def _flat_residuals(self, keys_tuple, layout, n_dev, bucket):
        """The bucket's flat residuals, one per device stream.  First use
        seeds each from the per-(key, stream) residual dict (zeros where
        absent) and takes ownership of those entries; a change of layout
        or stream count, or another bucket holding some of these keys,
        spills everything back first so no residual is lost."""
        rec = self._flat_res.get(keys_tuple)
        if rec is not None and (rec["layout"] != layout
                                or len(rec["res"]) != n_dev):
            self.spill_residuals()
            rec = None
        if rec is None and self._flat_res:
            ours = set(keys_tuple)
            if any(ours.intersection(kt) for kt in self._flat_res):
                self.spill_residuals()
        if rec is None:
            kv = self._kv
            dev0 = bucket[0].data[0].device
            res = []
            for d in range(n_dev):
                parts = [kv._get_residual((it.key, d), it.data[d])
                         ._data.to(dev0).reshape(-1).float()
                         for it in bucket]
                res.append(parts[0] if len(parts) == 1
                           else torch.cat(parts))
                for it in bucket:
                    kv._compression_residuals.pop((it.key, d), None)
            rec = self._flat_res[keys_tuple] = {"layout": layout,
                                                "res": res}
        return rec["res"]

    def spill_residuals(self):
        """Write the flat residuals back to the per-(key, stream) dict,
        before anything that may reroute keys to the eager path (an
        updater, compression or bucketing change)."""
        kv = self._kv
        for keys_tuple, rec in self._flat_res.items():
            for d, flat in enumerate(rec["res"]):
                for key, (off, size, shape) in zip(keys_tuple,
                                                   rec["layout"]):
                    kv._compression_residuals[(key, d)] = NDArray(
                        flat[off:off + size].view(shape))
        self._flat_res.clear()
