"""Single-launch fit step: one captured CUDA graph per batch shape.

Counterpart of ``mxnet_tpu/module/fused_fit.py``.  The eager ``Module``
step is a forward and backward walk, then per-bucket kvstore work and
per-key optimizer ops, each a few eager launches, with a blocking
metric read every batch.  ``FusedFitStep`` runs the whole step as one
body:

    forward + backward (the executor's graph walk, torch autograd)
      -> the gradients' f32 view (a 16-bit gradient widened once)
      -> 2-bit quantize per bucket against flat error-feedback
         residuals it keeps (optional; the ``two_bit_quantize_fused``
         kernel)
      -> the fused optimizer update (``Optimizer._fused_fit_sig``,
         ``fused_update.py``; a 16-bit weight under ``multi_precision``
         through its f32 master), written into the live weights and
         states
      -> the metric's device accumulation (``EvalMetric.device_fn``)

With bf16 or f16 parameters the module keeps a ``DynamicLossScaler``
(``module._loss_scaler``, from ``MXNET_LOSS_SCALE``; it survives a
re-bind and ``init_optimizer``), as the JAX package's fused step does
(``mxnet_tpu/module/fused_fit.py:446-469``): the step checks on the
device that every gradient's f32 view is finite (its minimum and
maximum, one reduction each) and, where the JAX program branches with
``lax.cond``, selects with ``torch.where`` into the live weights,
masters, optimizer states and residuals (the new values on a finite
step, the old ones, bit for bit, on a non-finite one), then updates the
scaler's triple in place.  Inside a CUDA graph that is one more read of
each committed tensor and of a bool mask, no host sync and no second
capture (``tools/torch_select_ab.py`` times the alternatives).  The
loss is not scaled (the JAX package's rule); auxiliary states and the
metric take every step.

On the card each batch shape's body is captured once as one CUDA graph
(after ``cuda_graph.WARMUP`` eager steps on a side stream, as PyTorch
requires; ``cuda_graph.py`` holds the capture, shared with the
executor's donated forward), and every later step copies the batch
into the graph's static feeds and replays it: one graph launch and the
batch copy, no host sync.  On the CPU the same body runs eagerly every
step (the device decides, as for the kernels).  ``TRACE_COUNT`` counts
the programs built, one per distinct key (batch shapes, optimizer
signature, metric signature, compression threshold, per-key
weight-decay pattern, state nesting): a ragged final batch builds once
more, a steady state never.

lr, wd, ``rescale_grad`` and the kind's per-key extra scalars (Nadam's
schedule products, LAMB's bias corrections) live in one static device
buffer that the host rewrites before each step through pinned staging
(``Optimizer._fused_runtime`` advances the update counts and the host
schedules as the eager updates would), so an ``lr_scheduler`` or a
changing correction never captures again.  Inputs reach the card
through two pinned slots per input, so the host waits only for the copy
two steps back, never for the step in flight.

A graph with Dropout draws from a step seed: a 0-d int64 tensor the
step refills from the device's generator before each run
(``random.next_seed``, one launch outside the graph), which the body's
walk hands to each Dropout site (``random.StepRandom``), as the JAX
package passes ``exe._next_seed()`` into its program
(``mxnet_tpu/module/fused_fit.py:760``): every replay draws new masks,
and ``mx.random.seed`` repeats them.

A batch of another shape (``Module.reshape``) gets a program of its
own, captured once; the programs of one step share one graph memory
pool (they replay one at a time, in one stream order), the scalar
buffer, the step seed, the metric's accumulator and the loss scaler,
so a second shape adds its graph's own temporaries only where they
outgrow the first's, and a returning shape replays its graph.

The weights, optimizer states and auxiliary states the graph reads and
writes are the module's own tensors (the executor's arguments, the
kvstore's stored weights, the ``Updater``'s states), updated in place,
so ``get_params``, ``Updater.get_states``/``set_states`` and the eager
path see exactly what the fused step left.  The error-feedback
residuals move between the two paths through the kvstore's
per-(key, stream) dict: the fused step seeds its flat residuals from
it (after the bucketed engine spills its own) and spills them back
(``_release``) before any eager update.

Eligible: no store or the single-process ``KVStore`` (``'local'``,
``'device'``), with or without 2-bit compression; no monitor; f32 or
bf16 or f16 parameters with ``grad_req='write'``; an optimizer with a fused
signature and the module's own ``Updater``.  Everything else keeps the
eager pair, as do modules bound with ``inputs_need_grad`` (reference
``fused_fit.py:416-417``); a mesh or several processes wait for A.8
(such a ``Module`` or store raises at construction), the in-launch
numerics sentinels for A.9 (``MXNET_SENTINEL_NUMERICS`` other than 0
raises here).  ``MXNET_FIT_FUSED=0`` keeps every step eager.

Under ``MXNET_BACKWARD_DO_MIRROR=1`` (read at each step and part of
the program's key, as in the JAX package) the body runs the forward
without recording, then once more, recorded, from the same step seed
(``executor.recompute_graph``: the masks replay, BatchNorm's moving
statistics come from the first walk only), and takes the gradients
from the second: one graph per batch shape still, with a second
forward's launches in it.

Modules bound over one module's arrays (``bind(shared_module=...)``,
``BucketingModule``'s buckets) run their steps in that module's
``FusedFitStep``: ``step(batch, metric, module)`` walks ``module``'s
executor, and its graph is one more program of the shared step (keyed
by the executor), in the same graph pool, with the same scalar buffer,
step seed, metric accumulator and 2-bit residuals, so a step updates
the one set of weights and optimizer states the same way whatever the
bucket, and a bucket met again replays its graph.  A module whose
trainable parameters are not the owner's own arrays (a name whose
shape differs binds zeros of its own) takes the eager pair.

The generators themselves are not registered with the graph: a step
that draws from one (an op of ``ops/random_ops.py``) raises at its
first capture instead of replaying one draw forever.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as _np
import torch

from .. import config as _config
from .. import fused_update as _fused
from .. import random as _random
from ..base import MXNetError
from ..cuda_graph import WARMUP, GraphPool, Program, Staging
from ..executor import recompute_graph, run_graph, sampler_state
from ..kvstore import KVStore, _updater_key
from ..kvstore_fused import bucket_byte_cap, push_plan, two_bit_quantize
from ..ndarray.ndarray import NDArray
from ..optimizer import Updater

__all__ = ["FusedFitStep", "TRACE_COUNT"]

# programs built (captured on the card, eager bodies on the CPU); one
# per distinct key
TRACE_COUNT = 0


def _metric_closure(metric, label_names, output_names):
    """``(metric_fn, sig)`` folding ``metric``'s device reduction into
    the step with ``update_dict``'s selection of outputs and labels;
    ``(None, None)`` when the metric accumulates on the host."""
    fn = metric.device_fn() if metric is not None else None
    if fn is None:
        return None, None
    out_sel = tuple(metric.output_names) if metric.output_names else None
    lab_sel = tuple(metric.label_names) if metric.label_names else None
    label_names, output_names = tuple(label_names), tuple(output_names)

    def metric_fn(inputs, outs):
        pred_d = dict(zip(output_names, outs))
        preds = ([pred_d[n] for n in out_sel if n in pred_d]
                 if out_sel is not None else list(outs))
        names = lab_sel if lab_sel is not None else label_names
        return fn([inputs[n] for n in names if n in inputs], preds)

    sig = (type(metric).__name__, metric.device_sig(), out_sel, lab_sel,
           label_names, output_names)
    return metric_fn, sig


class _Program:
    """One key's step body with its static feeds; on the card, warmed
    up over ``cuda_graph.WARMUP`` eager steps, then captured once and
    replayed (``cuda_graph.Program``)."""

    def __init__(self, body, feeds, device, pool):
        global TRACE_COUNT
        TRACE_COUNT += 1
        self.feeds = feeds
        self.staging = {n: Staging(t) for n, t in feeds.items()}
        self.device = device
        self.program = Program(body, device, "fused fit step",
                               "MXNET_FIT_FUSED=0 keeps such a model eager",
                               pool=pool)
        self.warm = 0

    @property
    def graph(self):
        return self.program.graph

    def run(self):
        prog = self.program
        if self.device.type != "cuda":
            return prog.body()
        if prog.graph is not None:
            return prog.replay()
        if self.warm < WARMUP:
            self.warm += 1
            return prog.warm_up()
        return prog.capture()


class FusedFitStep:
    """Per-Module driver of the single-launch fit step."""

    _METRIC_UNSET = object()

    def __init__(self, module, updater, kv, threshold, low_precision):
        self._mod = module
        self._updater = updater
        self._kv = kv                   # None or the single-process store
        self._threshold = threshold     # 2-bit threshold, or None
        self._low_precision = low_precision   # 16-bit parameters: a scaler
        exe = module._exec_group._exec
        self._device = exe.arg_dict[module._exec_group.param_names[0]] \
            ._data.device
        self._order = None              # trainable names, argument order
        self._ukeys = None              # the Updater's keys for them
        self._buckets = None            # [[(name, offset, size, shape)]]
        self._res_flat = None           # one flat f32 residual per bucket
        self._res_live = False          # residuals seeded from the store
        # lr (n), wd (n), rescale (1), then the kind's extras (n x k)
        self._scalars = None
        self._scalar_stage = None
        self._seed = None               # the step seed (graphs that draw)
        self._pool = GraphPool()        # one graph pool for every shape
        self._acc = None                # the metric's device (sum, num)
        self._acc_owner = None          # the metric whose _dev_* they are
        self._metric_ref = FusedFitStep._METRIC_UNSET
        self._metric_fn = self._msig = None
        self._metric_outputs = None
        self._programs = {}
        self._param_nds = None          # the owner's trainable NDArrays
        self._shares = {}               # executor -> its params are those
        self._bound = None              # the tensors the programs capture
        self.launches = 0               # steps run fused
        self.captures = 0

    # -- construction ---------------------------------------------------
    @staticmethod
    def build(module):
        """A FusedFitStep when ``module``'s configuration is eligible,
        else None (the fit loop keeps the eager pair)."""
        def no(reason):
            module.logger.debug("fused fit step disabled: %s", reason)
            return None

        if os.environ.get("MXNET_SENTINEL_NUMERICS", "0") != "0":
            raise MXNetError("fused fit step: the in-launch numerics "
                             "sentinels (MXNET_SENTINEL_NUMERICS) are not in "
                             "the PyTorch port yet (ROADMAP A.9)")
        if not module._fused_fit_enabled:
            return no("MXNET_FIT_FUSED=0")
        if module.inputs_need_grad:
            return no("inputs_need_grad")
        optimizer = module._optimizer
        sig = optimizer._fused_fit_sig()
        if sig is None or not _fused.supported(sig):
            return no("optimizer %s has no fused signature"
                      % type(optimizer).__name__)
        kv = module._kvstore
        if kv is not None and type(kv) is not KVStore:
            return no("kvstore %s" % type(kv).__name__)
        updater = kv._updater if kv is not None else module._updater
        if not isinstance(updater, Updater) \
                or updater.optimizer is not optimizer:
            return no("custom updater")
        threshold = None
        if kv is not None and kv._compression is not None:
            threshold = float(kv._compression.threshold)
        group = module._exec_group
        exe = group._exec
        trainable = [n for n in group.param_names
                     if exe._grad_req.get(n, "null") != "null"]
        if not trainable:
            return no("no trainable parameters")
        low_precision = False
        for name in trainable:
            if exe._grad_req[name] != "write":
                return no("grad_req %r on %s" % (exe._grad_req[name], name))
            dtype = exe.arg_dict[name]._data.dtype
            if dtype != torch.float32 and not _fused.is_low_precision(dtype):
                return no("%s parameter %s" % (dtype, name))
            low_precision = low_precision or dtype != torch.float32
        if low_precision and module._loss_scaler is None:
            # on the module, so it survives a re-bind and init_optimizer;
            # None when MXNET_LOSS_SCALE is off
            module._loss_scaler = _fused.DynamicLossScaler.from_config()
        return FusedFitStep(module, updater, kv, threshold, low_precision)

    # -- residuals (shared with the bucketed engine) --------------------
    def _plan(self, exe):
        """The trainable names and updater keys, and the 2-bit buckets:
        those the eager push forms (backward order, priority -index,
        the kvstore's byte cap, its streaming flush)."""
        group = self._mod._exec_group
        pos = {n: i for i, n in enumerate(group.param_names)}
        self._order = [n for n in group.param_names
                       if exe._grad_req.get(n, "null") != "null"]
        self._param_nds = {n: exe.arg_dict[n] for n in self._order}
        # the keys the eager path uses, so states load across the paths
        self._ukeys = [_updater_key(n) if self._kv is not None else pos[n]
                       for n in self._order]
        if self._threshold is None:
            return
        # each key at its own item size and type, as the eager push
        # packs it
        items = []
        for i, n in enumerate(reversed(self._order)):
            t = exe.arg_dict[n]._data
            items.append(SimpleNamespace(
                name=n, n_dev=1, priority=-pos[n], seq=i, dtype=t.dtype,
                nbytes=t.numel() * t.element_size()))
        self._buckets, self._res_flat = [], []
        for bucket in push_plan(items, bucket_byte_cap()):
            layout, off = [], 0
            for it in bucket:
                shape = tuple(exe.arg_dict[it.name].shape)
                size = exe.arg_dict[it.name]._data.numel()
                layout.append((it.name, off, size, shape))
                off += size
            self._buckets.append(layout)
            self._res_flat.append(torch.zeros(off, dtype=torch.float32,
                                              device=self._device))

    def _seed_residuals(self, exe):
        """Take the store's residuals into the flat buffers (the
        bucketed engine's first spilled back to the per-key dict)."""
        if self._res_live:
            return
        kv = self._kv
        kv._sync_engine()
        with torch.no_grad():
            for layout, flat in zip(self._buckets, self._res_flat):
                for name, off, size, shape in layout:
                    r = kv._get_residual((name, 0), exe.arg_dict[name]._data)
                    flat[off:off + size].copy_(r._data.reshape(-1))
                    kv._compression_residuals.pop((name, 0), None)
        self._res_live = True

    def _release(self):
        """Spill the flat residuals back to the store's per-(key,
        stream) dict, so the eager path (and the bucketed engine's
        reseed) resumes with the exact accumulated error feedback."""
        if self._res_live:
            for layout, flat in zip(self._buckets, self._res_flat):
                for name, off, size, shape in layout:
                    self._kv._compression_residuals[(name, 0)] = NDArray(
                        flat[off:off + size].view(shape).clone())
            self._res_live = False

    # -- the step body --------------------------------------------------
    def _shares_params(self, exe):
        """Whether ``exe`` (a module bound over the owner's arrays) trains
        exactly the owner's parameters, each the owner's NDArray with
        ``grad_req='write'``."""
        ok = self._shares.get(exe)
        if ok is None:
            trainable = {n for n, r in exe._grad_req.items() if r != "null"}
            ok = self._shares[exe] = trainable == set(self._order) and all(
                exe.arg_dict.get(n) is nd and exe._grad_req[n] == "write"
                for n, nd in self._param_nds.items())
        return ok

    def _make_body(self, exe, feeds, targets, states, tpls, mp, use_wd,
                   upd, scaler, mirror):
        order, threshold = self._order, self._threshold
        n = len(order)
        scalars, (acc_sum, acc_num) = self._scalars, self._acc
        k = upd.n_extra
        extra = scalars[2 * n + 1:].view(n, k) if k else None
        seed = self._seed if exe._plan.draws else None
        metric_fn = self._metric_fn
        leaves = [exe.arg_dict[name]._data for name in order]
        scaler_state, mask = None, None
        if scaler is not None:
            scaler_state = scaler.device_state(self._device)
            # the step's finiteness spread over a contiguous buffer, so
            # each select reads contiguous operands (a broadcast 0-d
            # condition keeps torch.where off its vectorized loads)
            sizes = [t.numel() for ts in targets + states for t in ts]
            sizes += [r.numel() for r in self._res_flat or ()]
            mask = torch.empty(max(sizes), dtype=torch.bool,
                               device=self._device)

        def body():
            values = {k: nd._data for k, nd in exe.aux_dict.items()}
            values.update((k, nd._data) for k, nd in exe.arg_dict.items())
            values.update(feeds)
            rng = _random.StepRandom(seed) if seed is not None else None
            if mirror:
                # MXNET_BACKWARD_DO_MIRROR: the forward unrecorded, then
                # again, recorded, from the same seed (the masks replay)
                sampler = sampler_state(exe._plan, self._device)
                with torch.no_grad():
                    heads, new_aux = run_graph(exe._plan, values, True, rng)
                rec = recompute_graph(exe._plan, values, seed, sampler)
            else:
                with torch.enable_grad():
                    heads, new_aux = run_graph(exe._plan, values, True, rng)
                rec = heads
            with torch.enable_grad():
                outs = [h for h in rec if h.requires_grad]
                grads = torch.autograd.grad(
                    outs, leaves, [torch.ones_like(h) for h in outs],
                    allow_unused=True) if outs else [None] * n
            with torch.no_grad():
                for name, t in new_aux.items():
                    if name in exe.aux_dict:
                        exe.aux_dict[name]._data.copy_(t)
                # the f32 master-gradient view: compression, the update
                # and the finiteness check read it
                g32 = {name: (torch.zeros(w.shape, dtype=torch.float32,
                                          device=w.device)
                              if g is None else g.float())
                       for name, w, g in zip(order, leaves, grads)}
                finite = None
                if scaler is not None:
                    # a NaN or an infinity reaches a minimum or a
                    # maximum: isfinite(g).all() from one reduction
                    # that writes no mask
                    ext = [v for g in g32.values() if g.numel()
                           for v in torch.aminmax(g)]
                    finite = torch.isfinite(torch.stack(ext)).all() \
                        if ext else torch.ones((), dtype=torch.bool,
                                               device=self._device)
                    mask.copy_(finite.expand(mask.shape))

                def commit(dst, new):
                    if finite is None:
                        dst.copy_(new)
                    else:
                        # a non-finite step keeps every old value
                        torch.where(mask[:dst.numel()].view(dst.shape),
                                    new, dst, out=dst)

                if threshold is not None:
                    for layout, res in zip(self._buckets, self._res_flat):
                        parts = [g32[name].reshape(-1)
                                 for name, _, _, _ in layout]
                        flat = parts[0] if len(parts) == 1 \
                            else torch.cat(parts)
                        q, new_res = two_bit_quantize(res, flat, threshold)
                        commit(res, new_res)
                        for name, off, size, shape in layout:
                            g32[name] = q[off:off + size].view(shape)
                rescale = scalars[2 * n]
                for i, name in enumerate(order):
                    w = targets[i][0]
                    st = _fused.unflatten(tpls[i], states[i])
                    new_w, new_st = _fused.apply_one(
                        upd, w, g32[name], st, mp[i], scalars[i],
                        scalars[n + i], rescale,
                        extra[i] if k else (), use_wd[i])
                    for t in targets[i]:
                        commit(t, new_w)
                    for leaf, new in zip(states[i],
                                         _fused.flatten_state(new_st)[0]):
                        commit(leaf, new)
                if scaler is not None:
                    scaler.step_fn(finite, scaler_state)
                detached = [h.detach() for h in heads]
                if metric_fn is not None:
                    bsum, bnum = metric_fn(feeds, detached)
                    acc_sum.add_(bsum)
                    acc_num.add_(bnum)
            return detached
        return body

    # -- the step -------------------------------------------------------
    def step(self, data_batch, eval_metric=None, module=None):
        """One fused training step of ``module`` (the owner, or a module
        bound over its arrays).  Returns False, with the residuals
        spilled first, when this batch cannot take the fused path (the
        eager pair then runs it)."""
        owner = self._mod
        mod = owner if module is None else module
        if getattr(mod, "_monitor_installed", False):
            self._release()
            return False
        live = owner._kvstore._updater if owner._kvstore is not None \
            else owner._updater
        mode = owner._optimizer._fused_fit_sig()
        if live is not self._updater or mode is None \
                or not _fused.supported(mode) \
                or mod._optimizer is not owner._optimizer:
            self._release()
            return False
        group = mod._exec_group
        exe = group._exec
        data = list(getattr(data_batch, "data", None) or [])
        labels = list(getattr(data_batch, "label", None) or [])
        if len(data) != len(group.data_names) \
                or len(labels) < len(group.label_names):
            self._release()
            return False
        inputs = {}
        for name, v in list(zip(group.data_names, data)) \
                + list(zip(group.label_names, labels)):
            t = v._data if isinstance(v, NDArray) else torch.as_tensor(
                _np.asarray(v))
            inputs[name] = t.to(exe.arg_dict[name]._data.dtype)
        n_extra = _fused.build(mode).n_extra
        if self._order is None or self._scalars.numel() \
                != (2 + n_extra) * len(self._order) + 1:
            if self._order is None:
                self._plan(owner._exec_group._exec)
                self._acc = tuple(torch.zeros((), dtype=torch.float32,
                                              device=self._device)
                                  for _ in range(2))
                self._seed = torch.zeros((), dtype=torch.int64,
                                         device=self._device)
            # a kind with another count of extras (an optimizer swapped
            # in) gets a buffer of its size; its programs are rebuilt
            self._programs.clear()
            self._pool = GraphPool()
            self._scalars = torch.zeros(
                (2 + n_extra) * len(self._order) + 1, dtype=torch.float32,
                device=self._device)
            self._scalar_stage = Staging(self._scalars)
        if mod is not owner and not self._shares_params(exe):
            self._release()
            return False
        if self._kv is not None:
            self._kv._flush_pending()
        order, ukeys = self._order, self._ukeys
        updater, optimizer = self._updater, owner._optimizer
        # the tensors the programs read and write: a change (a rebind,
        # new state arrays, another scaler) makes every captured program
        # stale
        targets, states, tpls, mp = [], [], [], []
        for name, uk in zip(order, ukeys):
            arg = exe.arg_dict[name]
            weight = self._kv._store[name] if self._kv is not None else arg
            targets.append([weight._data] + ([arg._data] if weight is not arg
                                              else []))
            st = updater.state(uk, weight)
            leaves, tpl = _fused.flatten_state(st)
            states.append([leaf._data for leaf in leaves])
            tpls.append(tpl)
            # an explicit static flag: Adam's (mean, var) has the nesting
            # of an (inner, weight32) pair
            mp.append(optimizer.multi_precision
                      and _fused.is_low_precision(weight._data.dtype))
        mp = tuple(mp)
        scaler = owner._loss_scaler if self._low_precision else None
        aux = [nd._data for nd in exe.aux_dict.values()]
        live = list(scaler.device_state(self._device)) \
            if scaler is not None else []
        bound = tuple(id(t) for ts in targets + states + [aux, live]
                      for t in ts)
        if bound != self._bound:
            # the graphs die with their programs: a new pool, since a
            # capture into a pool whose graphs are all gone fails
            self._programs.clear()
            self._pool = GraphPool()
            self._bound = bound
        lr, wd, extra = optimizer._fused_runtime(ukeys)
        use_wd = tuple(bool(v) for v in wd != 0.0)
        if self._threshold is not None:
            self._seed_residuals(exe)
        outputs = tuple(mod._symbol.list_outputs())
        if eval_metric is not self._metric_ref \
                or outputs != self._metric_outputs:
            self._metric_fn, self._msig = _metric_closure(
                eval_metric, group.label_names, outputs)
            self._metric_ref, self._metric_outputs = eval_metric, outputs
        shapes = tuple((n, tuple(t.shape)) for n, t in inputs.items())
        # read each step and part of the key, as the JAX package's fused
        # step reads it (mxnet_tpu/module/fused_fit.py:706)
        mirror = _config.backward_do_mirror()
        key = (id(exe), shapes, mode, self._threshold, tuple(tpls), mp,
               use_wd, self._msig,
               scaler.trace_sig() if scaler is not None else None, mirror)
        prog = self._programs.get(key)
        if prog is None:
            feeds = {}
            for name, t in inputs.items():
                arg = exe.arg_dict[name]._data
                feeds[name] = arg if tuple(t.shape) == tuple(arg.shape) \
                    else torch.empty(t.shape, dtype=arg.dtype,
                                     device=arg.device)
            prog = self._programs[key] = _Program(
                self._make_body(exe, feeds, targets, states, tpls, mp, use_wd,
                                _fused.build(mode), scaler, mirror), feeds,
                self._device, self._pool)
        host = _np.concatenate([lr, wd, _np.float32(
            [optimizer.rescale_grad]), extra.reshape(-1)]).astype(_np.float32)
        self._scalar_stage.put(torch.from_numpy(host))
        if exe._plan.draws:
            _random.next_seed(self._device, out=self._seed)
        for name, t in inputs.items():
            prog.staging[name].put(t)
        acc_sum, acc_num = self._acc
        if self._metric_fn is not None:
            owner = self._acc_owner
            if owner is not None and owner is not eval_metric \
                    and owner._dev_sum is acc_sum:
                # the accumulator moves to another metric: the last one
                # keeps its values
                owner._dev_sum, owner._dev_num = acc_sum.clone(), \
                    acc_num.clone()
            if eval_metric._dev_sum is None:
                acc_sum.zero_()
                acc_num.zero_()
            elif eval_metric._dev_sum is not acc_sum:
                acc_sum.copy_(eval_metric._dev_sum)
                acc_num.copy_(eval_metric._dev_num)
            self._acc_owner = eval_metric
        was_captured = prog.graph is not None
        outs = prog.run()
        self.captures += prog.graph is not None and not was_captured
        exe.outputs = [NDArray(o) for o in outs]
        exe._heads = exe._recompute = None
        if self._metric_fn is not None:
            eval_metric._dev_sum, eval_metric._dev_num = acc_sum, acc_num
            eval_metric._device_consumed = True
        self.launches += 1
        return True

    def captured_launches(self, by_dtype=False, module=None):
        """Kernel launches recorded in each captured graph, by kernel
        (``by_dtype``: by ``"name:dtype"``), one dict per capture (of
        ``module``'s executor only, when given)."""
        exe = None if module is None else id(module._exec_group._exec)
        return [p.program.captured_by_dtype if by_dtype
                else p.program.captured
                for key, p in self._programs.items()
                if p.graph is not None and exe in (None, key[0])]
