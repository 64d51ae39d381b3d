"""The bucketed kvstore push path.

Counterpart of ``mxnet_tpu/kvstore_fused.py``.  A batched ``push`` packs
the dense gradients (f32, or bf16 or f16 when an optimizer applies
them) into buckets of at most ``MXNET_KVSTORE_BIGARRAY_BOUND`` bytes
(default 4 MiB, the analog of MXNet's big-array bound; each key counted
at its own item size, a larger value in a bucket of its own, a new
bucket at a change of type), and each bucket runs as one short sequence of eager
calls:

    with 2-bit compression: per device stream, ``torch.cat`` of the
      gradients' flat f32 views (the master-gradient view: a 16-bit
      gradient is widened once, here), then ONE ``two_bit_quantize_fused``
      launch against the bucket's persistent flat f32 error-feedback
      residual; the quantized streams summed in device order; the sum
      sliced back per key;
    without: each key's device streams summed in order, in their type;
    then the optimizer's fused update (``Optimizer._fused_bucket_sig``,
      ``fused_update.bulk_apply``, with each key's static
      multi-precision flag: a 16-bit weight under ``multi_precision`` is
      updated through its f32 master, and the kind's per-key runtime
      scalars, ``Optimizer._fused_extra``, staged as one device tensor)
      written into the stored weights and the ``Updater``'s states, or,
      with no updater, the reduced value stored.

The JAX package runs the same op sequence as one compiled program per
bucket, so the two packages agree bit for bit on the compressor and to
the last ulp on the update.  PyTorch runs eagerly: there is no program
cache and nothing to retrace.  ``Module``'s
single-launch fit step (``module/fused_fit.py``) packs its gradients
into the same buckets (:func:`push_plan`) and quantizes each inside its CUDA
graph against flat residuals it keeps; the residuals move between the
two paths through the store's per-(key, stream) dict
(:meth:`FusedBucketEngine.spill_residuals` and the fit step's reseed).

Pushes carry ``priority=``; buckets form and dispatch in descending
priority, then arrival.  Once a bucket's worth of bytes is pending, the
full buckets go out at once (the streaming flush) and the partial tail
waits for the end of the push or the next sync point.

Custom updaters, optimizers without a fused signature and, with no
updater, any value other than f32 take the eager per-key path (``KVStore._push_one``) with the same
semantics.
"""
from __future__ import annotations

import os

import torch

from . import fused_update as _fused
from .kernels import two_bit_quantize_fused
from .ndarray.ndarray import NDArray

__all__ = ["FusedBucketEngine", "bucket_byte_cap", "pack", "plan_flush",
           "push_plan", "two_bit_quantize"]

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


def pack(items, cap):
    """Greedy size-capped packing of ``items`` (objects with ``nbytes``,
    ``n_dev`` and ``dtype``) in the order given: a new bucket starts
    when the cap would overflow or the stream count or the type changes
    (``mxnet_tpu/kvstore_fused.py:449``); an oversized value gets its
    own bucket."""
    buckets, cur, cur_bytes = [], [], 0
    for it in items:
        if cur and (cur_bytes + it.nbytes > cap
                    or it.n_dev != cur[0].n_dev
                    or it.dtype != cur[0].dtype):
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


def plan_flush(items, cap, keep_partial):
    """``(buckets, kept)``: the buckets one flush of ``items`` (objects
    with ``nbytes``, ``n_dev``, ``priority`` and ``seq``) dispatches,
    packed in (priority desc, arrival) order, and the items that stay
    pending: with ``keep_partial`` (the streaming path), a trailing
    bucket still below the cap."""
    buckets = pack(sorted(items, key=lambda it: (-it.priority, it.seq)), cap)
    if keep_partial and buckets \
            and sum(it.nbytes for it in buckets[-1]) < cap:
        return buckets[:-1], buckets[-1]
    return buckets, []


def push_plan(items, cap):
    """The buckets one batched push of ``items`` (in push order) forms
    on the streaming path: a flush that keeps its partial tail each time
    a cap's worth is pending, then a full flush at the push's end.
    ``Module``'s fused fit step packs its gradients this way, so its
    buckets are the eager push's."""
    buckets, pending, nbytes = [], [], 0
    for it in items:
        pending.append(it)
        nbytes += it.nbytes
        if nbytes >= cap:
            done, pending = plan_flush(pending, cap, True)
            buckets += done
            nbytes = sum(p.nbytes for p in pending)
    return buckets + plan_flush(pending, cap, False)[0]


class _Pending:
    """One key's pushed device streams.  ``data`` holds the gradient
    tensors as pushed; with async push (flushed after ``push`` returns)
    they are cloned, so a later in-place write to the pushed array does
    not change what the flush applies (MXNet's push-at-call semantics)."""

    __slots__ = ("key", "data", "priority", "seq", "size", "shape",
                 "itemsize", "dtype")

    def __init__(self, key, vlist, priority, seq, snapshot):
        self.key = key
        self.data = [v._data.detach().clone() if snapshot
                     else v._data.detach() for v in vlist]
        self.priority = priority
        self.seq = seq
        self.shape = tuple(self.data[0].shape)
        self.size = self.data[0].numel()
        self.itemsize = self.data[0].element_size()
        self.dtype = self.data[0].dtype

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
        """None with no updater (the reduced value is stored), the fused
        bucket signature of an ``Updater``'s optimizer, or False when
        updates must stay on the eager path."""
        from .optimizer import Updater
        updater = self._kv._updater
        if updater is None:
            return None
        if not isinstance(updater, Updater):
            return False
        sig = updater.optimizer._fused_bucket_sig()
        return sig if sig is not None and _fused.supported(sig) else False

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
            dtype = v._data.dtype
            if dtype != torch.float32 and (
                    mode is None or not _fused.is_low_precision(dtype)):
                # a low-precision value is bucketed only under an
                # optimizer (its f32 master-gradient view); a stored
                # value keeps its type on the eager path
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

    # -- flush ----------------------------------------------------------
    def flush(self, keep_partial=False):
        """Dispatch the pending pushes as buckets (priority desc, then
        arrival).  With ``keep_partial`` (the streaming path), a trailing
        bucket still below the byte cap stays pending."""
        if not self._pending:
            return
        buckets, tail = plan_flush(self._pending, bucket_byte_cap(),
                                   keep_partial)
        self._pending = []
        self._pending_keys.clear()
        self._pending_bytes = 0
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
            self._apply(bucket, reduced, mode)

    def _apply(self, bucket, reduced, sig):
        """The optimizer's fused update of one bucket
        (``fused_update.bulk_apply``), each key with its static
        multi-precision flag, written into the stored weights and the
        ``Updater``'s states in place; lr, wd and the update counts as
        the eager per-key updates would set them."""
        from .kvstore import _updater_key
        kv = self._kv
        updater = kv._updater
        opt = updater.optimizer
        ukeys = [_updater_key(it.key) for it in bucket]
        weights = [kv._store[it.key] for it in bucket]
        leaves, tpls = [], []
        for uk, w in zip(ukeys, weights):
            leaf, tpl = _fused.flatten_state(updater.state(uk, w))
            leaves.append(leaf)
            tpls.append(tpl)
        mp = tuple(opt.multi_precision
                   and _fused.is_low_precision(w._data.dtype)
                   for w in weights)
        lr, wd, extra = opt._fused_runtime(ukeys)
        dev = weights[0]._data.device
        with torch.no_grad():
            new_ws, new_ss = _fused.bulk_apply(sig)(
                [w._data for w in weights], reduced,
                [_fused.unflatten(t, [x._data for x in leaf])
                 for t, leaf in zip(tpls, leaves)],
                {"lr": lr.tolist(), "wd": wd.tolist(),
                 # the per-key scalars as one device tensor: its rows
                 # are 0-d views the kind reads on the device
                 "extra": torch.from_numpy(extra).to(dev) if extra.size
                 else None,
                 "rescale": opt.rescale_grad, "mp": mp,
                 "use_wd": tuple(bool(v) for v in wd != 0.0)})
            for w, leaf, nw, ns in zip(weights, leaves, new_ws, new_ss):
                w._data.copy_(nw)
                for x, new in zip(leaf, _fused.flatten_state(ns)[0]):
                    x._data.copy_(new)

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
