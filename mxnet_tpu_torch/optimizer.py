"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py``, reduced to what the training
slices use: the ``Optimizer`` base (``lr``, ``wd``, ``rescale_grad``,
``clip_gradient``, per-parameter ``lr_mult``/``wd_mult`` from
``param_idx2name`` and the symbol's ``__lr_mult__``/``__wd_mult__``
attributes, wd 0 for parameters not named ``*_weight``/``*_gamma``, an
``lr_scheduler`` hook), ``SGD`` (momentum), ``Signum``, ``Adam``,
``AdaGrad``, ``RMSProp`` (plain and centered), ``Updater``,
``get_updater``, ``create`` and ``register``.  Each update is the
in-place operator of ``ops/optimizer_ops.py``.  ``bucketable`` tells
the kvstore's bucketed path which optimizers it may apply (SGD, Adam,
AdaGrad and RMSProp: the optimizers of the port that have a fused
signature in the JAX package); the JAX package's single-program update has no counterpart
yet: the fit step is the eager pair (ROADMAP).
"""
from __future__ import annotations

import math

from .base import MXNetError
from .ndarray.ndarray import zeros
from .ops.optimizer_ops import (adagrad_update, adam_update,
                                rmsprop_update, rmspropalex_update,
                                sgd_mom_update, sgd_update, signsgd_update,
                                signum_update)

__all__ = ["Optimizer", "SGD", "Signum", "Adam", "AdaGrad", "RMSProp",
           "Updater", "get_updater", "create", "register"]

_OPT_REGISTRY = {}


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key not in _OPT_REGISTRY:
        raise MXNetError("optimizer '%s' is not in the PyTorch port yet"
                         % name)
    return _OPT_REGISTRY[key](**kwargs)


class Optimizer:
    """Base optimizer (reference optimizer.py:33): per-parameter lr/wd
    multipliers and update counts."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        if multi_precision:
            raise MXNetError("multi_precision comes with the bf16 training "
                             "slice of the PyTorch port")
        if param_dict:
            raise MXNetError("param_dict (Gluon parameters) comes with the "
                             "Gluon slice of the PyTorch port")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    # whether the kvstore's bucketed path may apply this optimizer per
    # key (kvstore_fused.py); False keeps a store's pushes on the eager
    # per-key path (the JAX package's optimizers without _fused_sig)
    bucketable = False

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def set_lr_mult(self, args_lr_mult):
        """``__lr_mult__`` attributes of the symbol, then overrides."""
        self.lr_mult = {}
        if self.sym_info:
            attrs, arg_names = self.sym_info
            for name in arg_names:
                if "__lr_mult__" in attrs.get(name, {}):
                    self.lr_mult[name] = float(attrs[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """wd 0 for parameters whose name does not end in ``_weight`` or
        ``_gamma`` (biases, betas), then ``__wd_mult__`` attributes, then
        overrides."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym_info:
            attrs, arg_names = self.sym_info
            for name in arg_names:
                if "__wd_mult__" in attrs.get(name, {}):
                    self.wd_mult[name] = float(attrs[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        return lr * self.lr_mult.get(self.idx2name.get(index, index), 1.0)

    def _get_wd(self, index):
        return self.wd * self.wd_mult.get(self.idx2name.get(index, index),
                                          1.0)

    def _common_kwargs(self):
        kw = {"rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw


@register
class SGD(Optimizer):
    """SGD with momentum (reference optimizer.py:445)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    bucketable = True

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is not None:
            sgd_mom_update(weight._data, grad._data, state._data, lr=lr,
                           wd=wd, momentum=self.momentum,
                           **self._common_kwargs())
        else:
            sgd_update(weight._data, grad._data, lr=lr, wd=wd,
                       **self._common_kwargs())


@register
class Adam(Optimizer):
    """Adam (reference optimizer.py Adam): the bias correction is folded
    into the step size on the host."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    bucketable = True

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        adam_update(weight._data, grad._data, mean._data, var._data, lr=lr,
                    wd=wd, beta1=self.beta1, beta2=self.beta2,
                    epsilon=self.epsilon, **self._common_kwargs())


@register
class Signum(Optimizer):
    """Signum, momentum SGD stepping by the sign of the momentum
    (reference optimizer.py Signum); with ``momentum=0``, signSGD."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is not None:
            signum_update(weight._data, grad._data, state._data, lr=lr,
                          wd=wd, momentum=self.momentum, wd_lh=self.wd_lh,
                          **self._common_kwargs())
        else:
            signsgd_update(weight._data, grad._data, lr=lr, wd=wd,
                           **self._common_kwargs())


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference optimizer.py AdaGrad); ``eps`` is kept as
    ``float_stable_eps``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    bucketable = True

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        adagrad_update(weight._data, grad._data, state._data, lr=lr, wd=wd,
                       epsilon=self.float_stable_eps, **self._common_kwargs())


@register
class RMSProp(Optimizer):
    """RMSProp (reference optimizer.py RMSProp): Tieleman and Hinton's,
    or Graves' centered form with ``centered=True``; ``clip_weights``
    bounds the plain form's weights."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    bucketable = True

    def create_state(self, index, weight):
        if self.centered:
            return tuple(zeros(weight.shape, weight.context)
                         for _ in range(3))
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = self._common_kwargs()
        if self.clip_weights:
            kw["clip_weights"] = self.clip_weights
        if self.centered:
            n, g, delta = state
            rmspropalex_update(weight._data, grad._data, n._data, g._data,
                               delta._data, lr=lr, wd=wd, gamma1=self.gamma1,
                               gamma2=self.gamma2, epsilon=self.epsilon, **kw)
        else:
            rmsprop_update(weight._data, grad._data, state._data, lr=lr,
                           wd=wd, gamma1=self.gamma1, epsilon=self.epsilon,
                           **kw)


class Updater:
    """Applies an optimizer with per-key state (reference
    optimizer.py:1464)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
