"""BucketingModule: one Module a bucket key over one set of weights.

Counterpart of ``mxnet_tpu/module/bucketing_module.py`` (reference
python/mxnet/module/bucketing_module.py), with its surface:
``sym_gen(bucket_key) -> (symbol, data_names, label_names)``, the
default bucket bound first, every other bucket's ``Module`` bound on
first use with ``bind(shared_module=<default bucket>)`` (it holds the
default bucket's parameters, gradients and auxiliary states, the same
NDArrays), ``switch_bucket``, ``prepare``, ``init_optimizer`` lending
the default bucket's optimizer, kvstore and updater to every other
bucket (``Module.borrow_optimizer``), ``get_params``/``set_params``
through the active bucket, and ``install_monitor`` (the monitor comes
with ROADMAP A.9 and raises, as ``fit(monitor=...)`` does).

Where the JAX package compiles one program a bucket and keeps it, the
port captures one CUDA graph a bucket: ``fit_step`` switches to the
batch's bucket and hands the step to that bucket's ``Module.fit_step``,
which replays the bucket's graph when the configuration is eligible
(``module/fused_fit.py``; every bucket's graph lives in the default
bucket's ``FusedFitStep``, one graph pool, one scalar buffer, one step
seed, one metric accumulator and one set of 2-bit residuals, and the
per-step scalars are staged once a step whatever the bucket) and
otherwise takes the eager pair, as ``BaseModule.fit_step`` does in the
JAX package.  ``MXNET_FIT_FUSED=0`` keeps every bucket eager.
"""
from __future__ import annotations

import logging
import os

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """Drive ``sym_gen(bucket_key)``; the parameters, their gradients,
    the optimizer states and the fused step live with the default
    bucket's module."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise ValueError("default_bucket_key is required")
        if work_load_list is not None or group2ctxs is not None:
            raise MXNetError("BucketingModule(work_load_list/group2ctxs) "
                             "places buckets over several devices: the "
                             "multi-GPU slice of the PyTorch port (ROADMAP "
                             "A.8)")
        if state_names:
            raise MXNetError("BucketingModule(state_names=...) is not in "
                             "the PyTorch port yet (ROADMAP A.6)")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._mod_kwargs = dict(logger=logger, context=context,
                                fixed_param_names=fixed_param_names or [],
                                compression_params=compression_params)
        self._reset_bind()
        self._grad_req = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._active = None
        self._active_key = None

    # -- introspection --------------------------------------------------
    @property
    def data_names(self):
        if self.binded:
            return self._active.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._active.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        self._check(self.binded, "data_shapes needs bind()")
        return self._active.data_shapes

    @property
    def label_shapes(self):
        self._check(self.binded, "label_shapes needs bind()")
        return self._active.label_shapes

    @property
    def output_shapes(self):
        self._check(self.binded, "output_shapes needs bind()")
        return self._active.output_shapes

    @property
    def symbol(self):
        self._check(self.binded, "symbol needs bind()")
        return self._active.symbol

    @property
    def buckets(self):
        """``{bucket key: Module}`` of the buckets bound so far."""
        return dict(self._buckets)

    @staticmethod
    def _check(cond, msg):
        if not cond:
            raise MXNetError("BucketingModule: " + msg)

    # -- parameters -----------------------------------------------------
    def get_params(self):
        self._check(self.params_initialized, "get_params() needs "
                    "init_params()")
        return self._active.get_params()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._check(self.binded, "init_params() needs bind()")
        self._active.init_params(initializer=initializer,
                                 arg_params=arg_params, aux_params=aux_params,
                                 allow_missing=allow_missing,
                                 force_init=force_init,
                                 allow_extra=allow_extra)
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self._check(self.binded, "set_params() needs bind()")
        self._active.set_params(arg_params, aux_params,
                                allow_missing=allow_missing,
                                force_init=force_init,
                                allow_extra=allow_extra)
        self.params_initialized = True

    # -- binding and buckets --------------------------------------------
    def _materialize(self, bucket_key, data_shapes, label_shapes, shared):
        """Make and bind the Module of ``bucket_key`` (over ``shared``'s
        arrays unless it is the default bucket)."""
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        mod = Module(symbol, data_names, label_names, **self._mod_kwargs)
        mod.bind(data_shapes, label_shapes, self.for_training,
                 self.inputs_need_grad, force_rebind=False,
                 shared_module=shared, grad_req=self._grad_req)
        self._buckets[bucket_key] = mod
        return mod

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._reset_bind()
            self.params_initialized = False
            self.optimizer_initialized = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise ValueError("BucketingModule does not support "
                             "shared_module")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self.binded = True
        self._active = self._materialize(self._default_bucket_key,
                                         data_shapes, label_shapes, None)
        self._active_key = self._default_bucket_key

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module the active one, binding it over
        the default bucket's arrays (and lending it the optimizer) at its
        first use."""
        self._check(self.binded, "call bind before switching bucket")
        mod = self._buckets.get(bucket_key)
        if mod is None:
            mod = self._materialize(
                bucket_key, data_shapes, label_shapes,
                self._buckets[self._default_bucket_key])
        self._active = mod
        self._active_key = bucket_key

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Bind the bucket of a coming batch without leaving the active
        one."""
        self._check(self.binded and self.params_initialized,
                    "prepare() needs bind() and init_params()")
        current = self._active_key
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self.switch_bucket(current, None, None)

    # -- optimizer ------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._check(self.binded and self.params_initialized,
                    "init_optimizer() needs bind() and init_params()")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        default = self._buckets[self._default_bucket_key]
        default.init_optimizer(kvstore, optimizer, optimizer_params,
                               force_init=force_init)
        for mod in self._buckets.values():
            if mod is not default:
                mod.borrow_optimizer(default)
        self.optimizer_initialized = True

    # -- execution (the active bucket) ----------------------------------
    def _switch_for(self, data_batch):
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)

    def forward(self, data_batch, is_train=None):
        self._check(self.binded and self.params_initialized,
                    "forward() needs bind() and init_params()")
        self._switch_for(data_batch)
        self._active.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._check(self.binded and self.params_initialized,
                    "backward() needs bind() and init_params()")
        self._active.backward(out_grads=out_grads)

    def update(self):
        self._check(self.binded and self.params_initialized
                    and self.optimizer_initialized,
                    "update() needs bind(), init_params() and "
                    "init_optimizer()")
        self._active.update()

    def fit_step(self, data_batch, eval_metric=None):
        """One training step on the batch's bucket: its captured graph
        when the configuration is eligible (True), else the eager pair
        (False)."""
        self._switch_for(data_batch)
        return self._active.fit_step(data_batch, eval_metric)

    def _fit_sync(self):
        if self.binded:
            self._buckets[self._default_bucket_key]._fit_sync()

    def get_outputs(self, merge_multi_context=True):
        self._check(self.binded and self.params_initialized,
                    "get_outputs() needs bind() and init_params()")
        return self._active.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._check(self.binded and self.params_initialized
                    and self.inputs_need_grad,
                    "get_input_grads() needs bind(inputs_need_grad=True) "
                    "and init_params()")
        return self._active.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._check(self.binded and self.params_initialized,
                    "update_metric() needs bind() and init_params()")
        self._active.update_metric(eval_metric, labels, pre_sliced)

    def _make_checkpointer(self, checkpoint_every, checkpoint_prefix):
        every = checkpoint_every if checkpoint_every is not None \
            else int(os.environ.get("MXNET_CHECKPOINT_EVERY", "0") or 0)
        if every:
            raise MXNetError("fit(checkpoint_every=...) of a BucketingModule "
                             "is not in the PyTorch port yet (ROADMAP A.6); "
                             "mx.rnn.do_rnn_checkpoint saves at epoch ends")
        return super()._make_checkpointer(checkpoint_every, checkpoint_prefix)

    def install_monitor(self, mon):
        self._check(self.binded, "install_monitor() needs bind()")
        raise MXNetError("BucketingModule.install_monitor: monitors are "
                         "not in the PyTorch port yet (ROADMAP A.9)")
