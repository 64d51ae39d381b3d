"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py``: the ``Optimizer`` base
(``lr``, ``wd``, ``rescale_grad``, ``clip_gradient``, per-parameter
``lr_mult``/``wd_mult`` from a Gluon Trainer's ``param_dict`` or from
``param_idx2name`` and the symbol's ``__lr_mult__``/``__wd_mult__``
attributes, wd 0 for parameters not named ``*_weight``/``*_gamma``, an
``lr_scheduler`` hook), the reference's seventeen optimizers (its
conformance fixture ``Test`` aside): ``SGD`` (momentum), ``Signum``,
``SignSGD``, ``NAG``, ``SGLD``, ``Adam``, ``AdaGrad``, ``GroupAdaGrad``,
``RMSProp`` (plain and centered), ``AdaDelta``, ``Ftrl``, ``Adamax``,
``Nadam``, ``FTML``, ``DCASGD``, ``LBSGD`` and ``LAMB``, and ``Updater``,
``get_updater``, ``create`` and ``register``.  The first optimizers'
updates are the in-place operators of ``ops/optimizer_ops.py``; the
others update in place with the reference's arithmetic, written out
here (LBSGD and LAMB read their norms to the host, as the reference's
eager updates do).

The fused-update protocol (the JAX package's ``_fused_sig``,
``_fused_bucket_sig``, ``_fused_fit_sig``, ``_fused_extra``): an
optimizer that describes its update as a ``(kind, *hyperparameters)``
tuple naming a kind of ``fused_update.py`` may be applied by the
kvstore's bucketed path and by ``Module``'s single-launch fit step
(``module/fused_fit.py``), which applies the kind's pure update with
lr, wd, ``rescale_grad`` and the kind's extra per-key scalars as runtime
values (``_fused_runtime``).  SGD (with momentum), Adam, AdaGrad,
RMSProp (plain and centered), LBSGD, Adamax, Nadam and LAMB describe
theirs; the others stay on the eager per-key path, each for the reason
``FUSED_EAGER_WAIVERS`` gives (the reference's list).

``multi_precision=True`` keeps an f32 master copy of every bf16 or
f16 weight: ``create_state_multi_precision`` returns ``(inner state,
weight32)`` and ``update_multi_precision`` updates the master in f32
and writes it back rounded to the weight's type, as the JAX package's
do (SGD through ``mp_sgd_update``/``mp_sgd_mom_update``, the ops that
``parallel.TrainStep`` applies too; LBSGD's LARS coefficient from the
master).  The ``Updater`` that ``Module``, the kvstore and Gluon's
``Trainer`` apply creates and updates every state through these two, so
a 16-bit weight trains through its master on every path.  Without
``multi_precision`` a 16-bit weight updates in its own type, as in the
JAX package.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from . import random as _random
from .base import (LOW_PRECISION, MXNetError,
                   numpy_to_tensor)
from .ndarray.ndarray import NDArray, zeros
from .ops.optimizer_ops import (adagrad_update, adam_update,
                                mp_sgd_mom_update, mp_sgd_update,
                                rmsprop_update, rmspropalex_update,
                                sgd_mom_update, sgd_update, signsgd_update,
                                signum_update)

__all__ = ["Optimizer", "SGD", "Signum", "SignSGD", "NAG", "SGLD", "Adam",
           "AdaGrad", "GroupAdaGrad", "RMSProp", "AdaDelta", "Ftrl",
           "Adamax", "Nadam", "FTML", "DCASGD", "LBSGD", "LAMB", "Updater",
           "get_updater", "create", "register", "FUSED_EAGER_WAIVERS"]

_OPT_REGISTRY = {}

# the optimizers that stay on the eager per-key path, each with the
# reference's reason (mxnet_tpu/optimizer.py:35)
FUSED_EAGER_WAIVERS = {
    "Signum": "sign-of-momentum update couples wd_lh into the weight "
              "step; niche optimizer, fuse on demand",
    "SignSGD": "inherits Signum's eager path",
    "NAG": "nesterov look-ahead mutates the momentum mid-formula; "
           "fuse together with Signum if demand appears",
    "SGLD": "draws fresh Langevin noise every update: not a pure "
            "function of (weight, grad, state)",
    "GroupAdaGrad": "embedding-table optimizer; its row-sparse path "
                    "waits for sparse NDArrays (ROADMAP A.6)",
    "AdaDelta": "accumulator pair updated through aliased in-place "
                "views; rarely used at scale",
    "Ftrl": "piecewise-zero proximal update (sparse-regime optimizer)",
    "FTML": "t-dependent denominator already runs as one update per "
            "key",
    "DCASGD": "delay compensation snapshots the full previous weight: "
              "async-SGD only, never on the sync hot path",
}


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key == "test":
        raise MXNetError("optimizer 'test' is the reference's conformance "
                         "fixture, not in the PyTorch port (ROADMAP A.10, "
                         "test_utils)")
    if key not in _OPT_REGISTRY:
        raise MXNetError("unknown optimizer '%s'" % name)
    return _OPT_REGISTRY[key](**kwargs)


class Optimizer:
    """Base optimizer (reference optimizer.py:33): per-parameter lr/wd
    multipliers and update counts."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.param_dict = dict(param_dict or {})
        self.rescale_grad = rescale_grad
        self.multi_precision = bool(multi_precision)
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

    # -- pickling: the JAX package's attributes (pickle_compat.py) -------
    def __getstate__(self):
        """The attributes as the JAX package's optimizer of the same name
        has them: ``param_dict`` (Gluon Parameters, set anew by whoever
        loads the optimizer) is left out, ``lazy_update`` (a sparse
        switch, ROADMAP A.6) takes the JAX default."""
        state = dict(self.__dict__)
        state["param_dict"] = {}
        if isinstance(self, (SGD, Adam)):
            state.setdefault("lazy_update", True)
        return state

    def __setstate__(self, state):
        """Either package's attributes; any the pickle lacks take this
        class's defaults."""
        self.__dict__.update(type(self)().__dict__)
        self.__dict__.update(state)
        self.__dict__.pop("lazy_update", None)
        self.param_dict = {}

    def keeps_master(self, weight):
        """Whether ``weight`` (an NDArray or tensor) is updated through
        an f32 master copy: a bf16 or f16 weight under
        ``multi_precision``."""
        return self.multi_precision and weight.dtype in LOW_PRECISION

    def create_state_multi_precision(self, index, weight):
        """``(create_state(weight32), weight32)`` with ``weight32`` an f32
        copy of a low-precision ``weight`` under ``multi_precision``;
        otherwise ``create_state(weight)``."""
        if self.keeps_master(weight):
            weight32 = weight.astype("float32")
            return self.create_state(index, weight32), weight32
        return self.create_state(index, weight)

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update` on the f32 master with the gradient in f32,
        then the master rounded into ``weight`` in place; a plain
        :meth:`update` when no master is kept."""
        if self.keeps_master(weight):
            inner, weight32 = state
            self.update(index, weight32, grad.astype("float32"), inner)
            weight._data.detach().copy_(weight32._data)
        else:
            self.update(index, weight, grad, state)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    # -- the fused-update protocol (fused_update.py) ----------------------
    def _fused_sig(self):
        """Hashable ``(kind, *hyperparameters)`` tuple fully determining
        the pure per-key update (a kind of ``fused_update.py``), or None
        to stay on the eager per-key path.  The tuple keys the fit
        step's captured programs, so a changed hyperparameter in it
        captures once more; lr, wd and ``rescale_grad`` are runtime
        values and never in it."""
        return None

    def _fused_bucket_sig(self):
        """Signature that lets the kvstore's bucketed path apply this
        optimizer (``kvstore_fused.py``); the shared one by default."""
        return self._fused_sig()

    def _fused_fit_sig(self):
        """Signature that lets ``Module``'s single-launch fit step apply
        this optimizer (``module/fused_fit.py``); the bucket one by
        default."""
        return self._fused_bucket_sig()

    def _fused_lr(self, index):
        """The runtime lr of key ``index`` in a fused step; kinds that
        fold a time-dependent correction into the step size (Adam)
        override it.  ``_update_count`` has run for the key."""
        return self._get_lr(index)

    def _fused_extra(self, ukeys):
        """The (n_keys, n_extra) f32 matrix of per-key runtime scalars
        beyond lr and wd that the kind reads (Nadam's schedule products,
        LAMB's bias corrections); host state the eager updates advance
        is advanced here, in ``ukeys`` order."""
        return _np.zeros((len(ukeys), 0), dtype=_np.float32)

    def _fused_runtime(self, ukeys):
        """Advance the update counts of ``ukeys`` in order, as the eager
        per-key updates would, and return the f32 ``(lr, wd, extra)``
        of one fused step: two vectors and the :meth:`_fused_extra`
        matrix."""
        for uk in ukeys:
            self._update_count(uk)
        lr = _np.asarray([self._fused_lr(uk) for uk in ukeys], _np.float32)
        wd = _np.asarray([self._get_wd(uk) for uk in ukeys], _np.float32)
        return lr, wd, self._fused_extra(ukeys)

    @staticmethod
    def _clip_sig(clip):
        return None if clip is None else float(clip)

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

    def set_learning_rate(self, lr):
        """Set the learning rate (not with an ``lr_scheduler``)."""
        if self.lr_scheduler is not None:
            raise MXNetError("cannot set the learning rate directly when "
                             "an lr_scheduler is set")
        self.lr = lr

    def _mult(self, index, mults, attr):
        """A Gluon Parameter's own ``lr_mult``/``wd_mult`` (``param_dict``,
        keyed as the updater's index), else the per-name table."""
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            return getattr(self.param_dict[name], attr)
        return mults.get(name, 1.0)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        return lr * self._mult(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult(index, self.wd_mult, "wd_mult")

    def _grad(self, grad):
        """``grad * rescale_grad``, clipped when ``clip_gradient`` is set
        (the Python-written optimizers' preamble)."""
        return _clip(grad._data * self.rescale_grad, self.clip_gradient)

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

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context)

    def _fused_sig(self):
        return ("sgd", float(self.momentum),
                self._clip_sig(self.clip_gradient))

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

    def update_multi_precision(self, index, weight, grad, state):
        """Through the master with ``mp_sgd_update``/``mp_sgd_mom_update``
        (reference optimizer.py:337), the ops ``parallel.TrainStep``
        applies, so every path rounds a master into its weight alike."""
        if not self.keeps_master(weight):
            self.update(index, weight, grad, state)
            return
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom, weight32 = state
        if mom is not None:
            mp_sgd_mom_update(weight._data, grad._data, mom._data,
                              weight32._data, lr=lr, wd=wd,
                              momentum=self.momentum, **self._common_kwargs())
        else:
            mp_sgd_update(weight._data, grad._data, weight32._data, lr=lr,
                          wd=wd, **self._common_kwargs())


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

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def _fused_sig(self):
        return ("adam", float(self.beta1), float(self.beta2),
                float(self.epsilon), self._clip_sig(self.clip_gradient))

    def _fused_lr(self, index):
        t = self._index_update_count[index]
        return self._get_lr(index) * (
            math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t))

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
class SignSGD(Signum):
    """Signum with no momentum: steps by the gradient's sign (reference
    optimizer.py SignSGD)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("momentum", 0.0)
        super().__init__(**kwargs)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference optimizer.py NAG)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context, dtype=weight.dtype)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        g = self._grad(grad)
        if state is not None:
            mom = state._data
            mom.mul_(self.momentum)
            g = g + wd * w
            mom.add_(g)
            g = g + self.momentum * mom
            w.add_(-lr * g)
        else:
            w.add_(-lr * (g + wd * w))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference optimizer.py
    SGLD): half a gradient step plus N(0, lr) noise drawn from the
    weight's device generator."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        g = self._grad(grad)
        noise = _sgld_noise(w, lr)
        w.add_(-lr / 2 * (g + wd * w) + noise)


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference optimizer.py AdaGrad); ``eps`` is kept as
    ``float_stable_eps``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def _fused_sig(self):
        return ("adagrad", float(self.float_stable_eps),
                self._clip_sig(self.clip_gradient))

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

    def create_state(self, index, weight):
        if self.centered:
            return tuple(zeros(weight.shape, weight.context)
                         for _ in range(3))
        return zeros(weight.shape, weight.context)

    def _fused_sig(self):
        clip = self._clip_sig(self.clip_gradient)
        # clip_weights rides only when truthy, as the eager kwargs do
        cw = float(self.clip_weights) if self.clip_weights else None
        if self.centered:
            return ("rmspropalex", float(self.gamma1), float(self.gamma2),
                    float(self.epsilon), clip, cw)
        return ("rmsprop", float(self.gamma1), float(self.epsilon), clip, cw)

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


@register
class GroupAdaGrad(Optimizer):
    """Row-wise AdaGrad (reference contrib GroupAdaGrad): one adaptive
    cell per row of a 2-D weight, ``history += mean(g^2, axis=1)``;
    weight decay is not supported and raises."""

    def __init__(self, learning_rate=0.01, eps=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        if self.wd != 0.0:
            raise MXNetError("GroupAdaGrad does not support weight decay "
                             "(reference contrib.GroupAdaGrad)")
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros((weight.shape[0], 1), weight.context)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        if len(weight.shape) != 2:
            raise MXNetError("group_adagrad_update expects 2-D weights "
                             "(got %s)" % (weight.shape,))
        w, h = weight._data, state._data
        g = grad._data.float() * self.rescale_grad
        if self.clip_gradient is not None and self.clip_gradient >= 0:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        h.add_(g.square().mean(dim=1, keepdim=True))
        w.copy_(w.float() - lr * g / torch.sqrt(h + self.float_stable_eps))


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference optimizer.py AdaDelta): no learning rate; the
    step is ``sqrt(acc_delta + eps) / sqrt(acc_g + eps) * g``."""

    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        w = weight._data
        g = self._grad(grad) + wd * w
        acc_g, acc_delta = state[0]._data, state[1]._data
        rho = self.rho
        acc_g.copy_(rho * acc_g + (1 - rho) * g * g)
        delta = (torch.sqrt(acc_delta + self.epsilon)
                 / torch.sqrt(acc_g + self.epsilon)) * g
        acc_delta.copy_(rho * acc_delta + (1 - rho) * delta * delta)
        w.sub_(delta)


@register
class Ftrl(Optimizer):
    """Follow the regularized leader (reference optimizer.py Ftrl and
    the ``ftrl_update`` op): ``z`` and ``n`` accumulators, a weight of
    exactly zero where ``|z| <= lamda1``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        z, n = state[0]._data, state[1]._data
        g = grad._data.float() * self.rescale_grad
        if self.clip_gradient is not None and self.clip_gradient >= 0:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        new_n = n + g.square()
        sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
        new_z = z + g - sigma * w
        new_w = torch.where(
            new_z.abs() <= self.lamda1, torch.zeros_like(new_z),
            -(new_z - torch.sign(new_z) * self.lamda1)
            / ((self.beta + torch.sqrt(new_n)) / lr + wd))
        n.copy_(new_n)
        z.copy_(new_z)
        w.copy_(new_w)


@register
class Adamax(Optimizer):
    """Adamax, Adam over the infinity norm (reference optimizer.py
    Adamax); ``1 - beta1^t`` divides the step size on the host."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def _fused_sig(self):
        return ("adamax", float(self.beta1), float(self.beta2),
                self._clip_sig(self.clip_gradient))

    def _fused_lr(self, index):
        t = self._index_update_count[index]
        return self._get_lr(index) / (1.0 - self.beta1 ** t)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr /= (1.0 - self.beta1 ** t)
        w = weight._data
        g = _clip(grad._data.float() * self.rescale_grad + wd * w,
                  self.clip_gradient)
        m, u = state[0]._data, state[1]._data
        m.copy_(self.beta1 * m + (1.0 - self.beta1) * g)
        u.copy_(torch.maximum(self.beta2 * u, g.abs()))
        w.sub_(lr * m / u)


@register
class Nadam(Optimizer):
    """Nesterov Adam (reference optimizer.py Nadam): the momentum
    schedule's running product ``m_schedule`` is host state that every
    key's update advances, in update order."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def _fused_sig(self):
        return ("nadam", float(self.beta1), float(self.beta2),
                float(self.epsilon), float(self.schedule_decay),
                self._clip_sig(self.clip_gradient))

    def _schedule(self, t):
        """Advance ``m_schedule`` for one key's step ``t``; returns
        ``(momentum_t, momentum_t_1, m_schedule_next)``."""
        momentum_t = self.beta1 * (
            1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (
            1.0 - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        return momentum_t, momentum_t_1, self.m_schedule * momentum_t_1

    def _fused_extra(self, ukeys):
        out = _np.zeros((len(ukeys), 5), dtype=_np.float32)
        for i, uk in enumerate(ukeys):
            t = self._index_update_count[uk]
            momentum_t, momentum_t_1, m_next = self._schedule(t)
            out[i] = (momentum_t, momentum_t_1, self.m_schedule, m_next,
                      1.0 - self.beta2 ** t)
        return out

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        w = weight._data
        g = _clip(grad._data.float() * self.rescale_grad + wd * w,
                  self.clip_gradient)
        momentum_t, momentum_t_1, m_schedule_next = self._schedule(t)
        m, v = state[0]._data, state[1]._data
        m.copy_(self.beta1 * m + (1.0 - self.beta1) * g)
        v.copy_(self.beta2 * v + (1.0 - self.beta2) * g * g)
        grad_prime = g / (1.0 - self.m_schedule)
        m_prime = m / (1.0 - m_schedule_next)
        v_prime = v / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - momentum_t) * grad_prime + momentum_t_1 * m_prime
        w.sub_(lr * m_bar / (torch.sqrt(v_prime) + self.epsilon))


@register
class FTML(Optimizer):
    """Follow the moving leader (reference optimizer.py FTML and the
    ``ftml_update`` op; the op adds ``wd * w`` to the gradient before
    clipping)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return tuple(zeros(weight.shape, weight.context) for _ in range(3))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        d, v, z = (st._data for st in state)
        g = grad._data.float() * self.rescale_grad + wd * w.float()
        if self.clip_gradient is not None and self.clip_gradient >= 0:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        b1, b2 = self.beta1, self.beta2
        # the op's t-powers are f32 tensor arithmetic, as the reference's
        f32 = dict(dtype=torch.float32, device=w.device)
        t = torch.tensor(float(self._index_update_count[index]), **f32)
        pow1 = torch.pow(torch.tensor(b1, **f32), t)
        pow2 = torch.pow(torch.tensor(b2, **f32), t)
        new_v = b2 * v + (1.0 - b2) * g.square()
        d_new = (1.0 - pow1) / lr * (torch.sqrt(new_v / (1.0 - pow2))
                                     + self.epsilon)
        sigma = d_new - b1 * d
        new_z = b1 * z + (1.0 - b1) * g - sigma * w.float()
        v.copy_(new_v)
        d.copy_(d_new)
        z.copy_(new_z)
        w.copy_(-new_z / d_new)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference optimizer.py
    DCASGD): the state keeps the previous weight."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = zeros(weight.shape, weight.context) \
            if self.momentum != 0.0 else None
        return (mom, weight.copy())

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        g = self._grad(grad)
        mom, previous = state
        prev = previous._data
        comp = g + wd * w + self.lamda * g * g * (w - prev)
        if mom is not None:
            mom._data.copy_(self.momentum * mom._data - lr * comp)
            step = mom._data
        else:
            step = -lr * comp
        prev.copy_(w)
        w.add_(step)


@register
class LBSGD(SGD):
    """Large-batch SGD: SGD with momentum whose step takes LARS's
    layer-wise coefficient ``||w|| / (||g|| + wd ||w|| + 1e-9) * 0.001``
    (reference optimizer.py LBSGD; the norms read to the host here, on
    the device in the fused kind).  Under ``multi_precision`` the norms
    are the f32 master's and the f32 gradient's."""

    def __init__(self, momentum=0.9, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(momentum=momentum, multi_precision=multi_precision,
                         **kwargs)
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch

    def _fused_sig(self):
        return ("lbsgd", float(self.momentum),
                self._clip_sig(self.clip_gradient))

    @staticmethod
    def _get_lars(weight, g, wd):
        w_norm = float(_norm(weight).item())
        g_norm = float(_norm(g).item())
        if w_norm > 0 and g_norm > 0:
            return w_norm / (g_norm + wd * w_norm + 1e-9) * 0.001
        return 1.0

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        lr = lr * self._get_lars(weight._data, grad._data, wd)
        if state is not None:
            sgd_mom_update(weight._data, grad._data, state._data, lr=lr,
                           wd=wd, momentum=self.momentum,
                           **self._common_kwargs())
        else:
            sgd_update(weight._data, grad._data, lr=lr, wd=wd,
                       **self._common_kwargs())

    def update_multi_precision(self, index, weight, grad, state):
        if not self.keeps_master(weight):
            self.update(index, weight, grad, state)
            return
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom, weight32 = state
        lr = lr * self._get_lars(weight32._data, grad._data.float(), wd)
        if mom is not None:
            mp_sgd_mom_update(weight._data, grad._data, mom._data,
                              weight32._data, lr=lr, wd=wd,
                              momentum=self.momentum, **self._common_kwargs())
        else:
            mp_sgd_update(weight._data, grad._data, weight32._data, lr=lr,
                          wd=wd, **self._common_kwargs())


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments (You et al., arXiv:1904.00962;
    reference optimizer.py LAMB): Adam's moments with the step scaled by
    the trust ratio ``||w|| / ||r||``, its norms read to the host here
    and reduced on the device in the fused kind; ``1 - beta^t`` reach
    the fused kind as runtime scalars."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def _fused_sig(self):
        return ("lamb", float(self.beta1), float(self.beta2),
                float(self.epsilon), bool(self.bias_correction),
                self._clip_sig(self.clip_gradient))

    def _fused_extra(self, ukeys):
        out = _np.zeros((len(ukeys), 2), dtype=_np.float32)
        for i, uk in enumerate(ukeys):
            t = self._index_update_count[uk]
            out[i] = (1.0 - self.beta1 ** t, 1.0 - self.beta2 ** t)
        return out

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        w = weight._data
        g = _clip(grad._data.float() * self.rescale_grad, self.clip_gradient)
        m, v = state[0]._data, state[1]._data
        m.copy_(self.beta1 * m + (1.0 - self.beta1) * g)
        v.copy_(self.beta2 * v + (1.0 - self.beta2) * g * g)
        if self.bias_correction:
            m_hat = m / (1.0 - self.beta1 ** t)
            v_hat = v / (1.0 - self.beta2 ** t)
        else:
            m_hat, v_hat = m, v
        r = m_hat / (torch.sqrt(v_hat) + self.epsilon) + wd * w
        w_norm = float(_norm(w).item())
        r_norm = float(_norm(r).item())
        ratio = w_norm / r_norm if (w_norm > 0 and r_norm > 0) else 1.0
        w.sub_(lr * ratio * r)


def _clip(g, clip):
    """``g`` clipped to +-``clip`` when a bound is set (the reference's
    ``nd.clip`` in the optimizers written out in Python)."""
    return g if clip is None else g.clamp(-clip, clip)


def _norm(t):
    """The 2-norm of ``t`` in f32, as a 0-d tensor."""
    return t.float().square().sum().sqrt()


def _sgld_noise(weight, lr):
    """SGLD's N(0, lr) noise of ``weight``'s shape and type, drawn from
    its device's generator."""
    noise = torch.empty(weight.shape, dtype=torch.float32,
                        device=weight.device)
    noise.normal_(0.0, math.sqrt(lr), generator=_random.generator(
        weight.device))
    return noise.to(weight.dtype)


class Updater:
    """Applies an optimizer with per-key state (reference
    optimizer.py:1464)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.state(index, weight))

    def state(self, index, weight):
        """Key ``index``'s state, created for ``weight`` on first use
        (``create_state_multi_precision``: ``(inner, weight32)`` for a
        bf16 weight under ``multi_precision``); a state that
        :meth:`set_states` loaded on the host moves to ``weight``'s
        device here, once."""
        st = self.states.get(index)
        if index not in self.states:
            st = self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        elif any(leaf._data.device != weight._data.device
                 for leaf in _leaves(st)):
            st = self.states[index] = _map_state(
                lambda leaf: NDArray(leaf._data.to(weight._data.device)), st)
        return st

    def get_states(self, dump_optimizer=False):
        """The per-key states as bytes: a pickle of NDArrays nested as the
        states are (with the optimizer when ``dump_optimizer``), in the
        JAX package's format (``pickle_compat.py``; reference
        optimizer.py ``Updater.get_states``).  The fused fit step keeps
        its state in these same arrays, so the states of either path load
        into the other."""
        from . import pickle_compat
        return pickle_compat.dumps((self.states, self.optimizer)
                                   if dump_optimizer else self.states)

    def set_states(self, states):
        """Load :meth:`get_states`' bytes (either package's), or the
        unpickled dict.  A key that already has a state of the same
        nesting and shapes gets the values copied into its arrays (a
        captured fit step keeps reading them); any other key's state
        becomes host arrays, moved to its weight's device at first
        use."""
        from . import pickle_compat
        loaded = pickle_compat.loads(states) \
            if isinstance(states, (bytes, bytearray)) else states
        if isinstance(loaded, tuple) and len(loaded) == 2:
            loaded, self.optimizer = loaded
        for k, v in loaded.items():
            old = self.states.get(k)
            new_leaves = _leaves(v)
            old_leaves = _leaves(old)
            if old is not None and len(old_leaves) == len(new_leaves) \
                    and all(o.shape == tuple(n.shape)
                            for o, n in zip(old_leaves, new_leaves)):
                with torch.no_grad():
                    for o, n in zip(old_leaves, new_leaves):
                        o._data.copy_(_host_tensor(n))
            else:
                self.states[k] = _map_state(
                    lambda a: NDArray(_host_tensor(a)), v)


def _host_tensor(a):
    """The tensor of a loaded state leaf (an NDArray, or numpy)."""
    return a._data if isinstance(a, NDArray) else numpy_to_tensor(a)


def _leaves(state):
    """The array leaves of a state (None, an array, or nested tuples),
    in order."""
    if state is None:
        return []
    if isinstance(state, tuple):
        return [leaf for s in state for leaf in _leaves(s)]
    return [state]


def _map_state(fn, state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_map_state(fn, s) for s in state)
    return fn(state)


def get_updater(optimizer):
    return Updater(optimizer)
