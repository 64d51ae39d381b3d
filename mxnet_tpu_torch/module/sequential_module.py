"""SequentialModule: a chain of modules, each feeding the next.

Counterpart of ``mxnet_tpu/module/sequential_module.py`` (reference
python/mxnet/module/sequential_module.py): ``add(module,
take_labels=..., auto_wiring=...)`` with the same META_* keys.  Forward
threads each stage's outputs into the next stage's inputs; backward
threads input gradients in reverse, so every stage after the first binds
with ``inputs_need_grad=True`` when training (and runs the eager pair:
a fused fit step does not take such a module).  Each stage keeps its
own executor and optimizer; a plain ``Module`` over the composed symbol
is one graph instead.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any

from ..base import MXNetError
from ..initializer import Uniform
from ..io.io import DataBatch
from .base_module import BaseModule

__all__ = ["SequentialModule"]


@dataclass
class _Stage:
    """One module of the chain and its wiring options."""
    module: Any
    takes_labels: bool = False
    auto_wire: bool = False


class SequentialModule(BaseModule):
    """Chain modules: data flows first to last, gradients last to
    first."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._stages = []
        self._label_shapes = None
        self.inputs_need_grad = False

    # -- construction ---------------------------------------------------
    def add(self, module, **kwargs):
        """Append ``module``; ``take_labels`` routes the labels to it,
        ``auto_wiring`` renames the previous stage's outputs to its data
        names.  Returns self."""
        allowed = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}
        unknown = set(kwargs) - allowed
        if unknown:
            raise ValueError("Unknown meta keys %s; allowed: %s"
                             % (sorted(unknown), sorted(allowed)))
        self._stages.append(_Stage(
            module=module,
            takes_labels=bool(kwargs.get(self.META_TAKE_LABELS, False)),
            auto_wire=bool(kwargs.get(self.META_AUTO_WIRING, False))))
        # a changed chain must be bound again
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    def _mods(self):
        return [s.module for s in self._stages]

    # -- introspection --------------------------------------------------
    @property
    def data_names(self):
        return self._stages[0].module.data_names if self._stages else []

    @property
    def output_names(self):
        return self._stages[-1].module.output_names if self._stages else []

    @property
    def data_shapes(self):
        return self._stages[0].module.data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._stages[-1].module.output_shapes

    # -- parameters -----------------------------------------------------
    def get_params(self):
        args, auxs = {}, {}
        for m in self._mods():
            a, x = m.get_params()
            args.update(a)
            auxs.update(x)
        return args, auxs

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before initializing the parameters")
        for m in self._mods():
            # a name of another stage is extra to this one: every stage
            # allows extras, and names no stage owns are refused below
            m.init_params(initializer=initializer, arg_params=arg_params,
                          aux_params=aux_params, allow_missing=allow_missing,
                          force_init=force_init, allow_extra=True)
        if not allow_extra:
            self._reject_unclaimed(arg_params, aux_params)
        self.params_initialized = True

    def _reject_unclaimed(self, arg_params, aux_params):
        claimed = set()
        for m in self._mods():
            claimed.update(m._param_names)
            claimed.update(m._aux_names)
        orphans = sorted(n for src in (arg_params, aux_params)
                         for n in (src or {}) if n not in claimed)
        if orphans:
            raise MXNetError("init_params got parameter(s) %s unknown to "
                             "every sub-module (pass allow_extra=True to "
                             "ignore)" % orphans)

    # -- binding --------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("SequentialModule does not support "
                             "shared_module")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes
        feed = data_shapes
        label_used = False
        for idx, stage in enumerate(self._stages):
            if stage.auto_wire:
                feed = self._rewire(stage.module.data_names, feed)
            stage.module.bind(
                data_shapes=feed,
                label_shapes=label_shapes if stage.takes_labels else None,
                for_training=for_training,
                # a later stage's input gradients carry the backward on
                inputs_need_grad=inputs_need_grad
                or (for_training and idx > 0),
                force_rebind=force_rebind, grad_req=grad_req)
            label_used = label_used or stage.takes_labels
            feed = stage.module.output_shapes
        if not label_used:
            self._label_shapes = None
        self.binded = True

    @staticmethod
    def _rewire(names, shapes):
        """The previous stage's output descriptions renamed to this
        stage's data names."""
        if len(names) != len(shapes):
            raise ValueError("auto_wiring: stage declares %d inputs but "
                             "the previous one produces %d outputs"
                             % (len(names), len(shapes)))
        return [(name, tuple(desc)[1]) for name, desc in zip(names, shapes)]

    # -- optimizer ------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if not (self.binded and self.params_initialized):
            raise MXNetError("init_optimizer() requires bind() and "
                             "init_params()")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for m in self._mods():
            m.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                             optimizer_params=optimizer_params,
                             force_init=force_init)
        self.optimizer_initialized = True

    # -- execution ------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("forward() requires bind() and init_params()")
        # a copy whose data is replaced as activations flow through
        flowing = DataBatch(data=data_batch.data, label=data_batch.label,
                            pad=data_batch.pad, index=data_batch.index)
        last = len(self._stages) - 1
        for idx, stage in enumerate(self._stages):
            stage.module.forward(flowing, is_train=is_train)
            if idx == last:
                break
            flowing.data = stage.module.get_outputs()

    def backward(self, out_grads=None):
        for idx in range(len(self._stages) - 1, -1, -1):
            self._stages[idx].module.backward(out_grads=out_grads)
            if idx:
                out_grads = self._stages[idx].module.get_input_grads()

    def update(self):
        if not self.optimizer_initialized:
            raise MXNetError("update() requires init_optimizer()")
        for m in self._mods():
            m.update()

    def get_outputs(self, merge_multi_context=True):
        return self._stages[-1].module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("get_input_grads() requires bind("
                             "inputs_need_grad=True)")
        return self._stages[0].module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        for stage in self._stages:
            if stage.takes_labels:
                stage.module.update_metric(eval_metric, labels)
