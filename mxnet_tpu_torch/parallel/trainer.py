"""One training step: forward, backward and the optimizer update.

Counterpart of ``mxnet_tpu/parallel/trainer.py`` ``TrainStep`` on one
device.  The JAX package compiles the whole step (forward, backward,
the gradient reduction a mesh inserts, the update) into one donated
program; PyTorch runs it eagerly: the symbol is bound once
(``simple_bind``, a gradient for every parameter), and each ``step``
feeds the batch, runs the train forward (the auxiliary states written
back), back-propagates with ones as every output's cotangent (a loss
head ignores its seed), and updates every parameter by name, in place,
under ``no_grad``, through the optimizer's update operators.  A
parameter that autograd leaves without a gradient gets a zero one and
is updated all the same, as the JAX package's vjp gives zeros (weight
decay still moves it).  The learning rate comes from the scheduler at
``num_update = max(num_update, step)``; Adam's bias correction is
folded into it with one global step count, since every parameter
updates every step.

Meshes (data and tensor parallelism) come with the multi-GPU slice and
``dtype='bfloat16'`` with the bf16 slice; both raise.
"""
from __future__ import annotations

import json

import torch

from .. import initializer as _init
from .. import optimizer as _opt
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..ops import optimizer_ops as _oo

__all__ = ["TrainStep"]


def _wd_for(optimizer, name):
    """Weight decay of parameter ``name``: the optimizer's ``wd_mult``
    entry when there is one, else 0 unless the name ends in
    ``_weight``/``_gamma`` (reference optimizer.py:330).  Keyed by NAME,
    so an optimizer shared with a Module of other indices is not
    touched."""
    if name in optimizer.wd_mult:
        return optimizer.wd * optimizer.wd_mult[name]
    if not (name.endswith("_weight") or name.endswith("_gamma")):
        return 0.0
    return optimizer.wd


def _update(optimizer, name, weight, grad, state, lr):
    """Apply ``optimizer`` to one parameter in place with the update
    operators of ``ops/optimizer_ops.py`` (the JAX package's
    ``_functional_update``)."""
    wd = _wd_for(optimizer, name)
    lr = lr * optimizer.lr_mult.get(name, 1.0)
    kw = dict(rescale_grad=optimizer.rescale_grad,
              clip_gradient=(optimizer.clip_gradient
                             if optimizer.clip_gradient is not None else -1.0))
    if isinstance(optimizer, _opt.SGD):
        if optimizer.momentum:
            _oo.sgd_mom_update(weight, grad, *state, lr=lr,
                               momentum=optimizer.momentum, wd=wd, **kw)
        else:
            _oo.sgd_update(weight, grad, lr=lr, wd=wd, **kw)
    elif isinstance(optimizer, _opt.Signum):
        _oo.signum_update(weight, grad, *state, lr=lr,
                          momentum=optimizer.momentum, wd=wd,
                          wd_lh=optimizer.wd_lh, **kw)
    elif isinstance(optimizer, _opt.Adam):
        _oo.adam_update(weight, grad, *state, lr=lr, beta1=optimizer.beta1,
                        beta2=optimizer.beta2, epsilon=optimizer.epsilon,
                        wd=wd, **kw)
    elif isinstance(optimizer, _opt.RMSProp):
        if optimizer.clip_weights:
            kw["clip_weights"] = optimizer.clip_weights
        if optimizer.centered:
            _oo.rmspropalex_update(weight, grad, *state, lr=lr,
                                   gamma1=optimizer.gamma1,
                                   gamma2=optimizer.gamma2,
                                   epsilon=optimizer.epsilon, wd=wd, **kw)
        else:
            _oo.rmsprop_update(weight, grad, *state, lr=lr,
                               gamma1=optimizer.gamma1,
                               epsilon=optimizer.epsilon, wd=wd, **kw)
    elif isinstance(optimizer, _opt.AdaGrad):
        _oo.adagrad_update(weight, grad, *state, lr=lr,
                           epsilon=optimizer.float_stable_eps, wd=wd, **kw)
    else:
        raise MXNetError("TrainStep supports sgd/signum/adam/rmsprop/adagrad; "
                         "%r must run through Module.update()"
                         % type(optimizer).__name__)


def _init_state(optimizer, weight):
    """The f32 state tensors of one parameter (the JAX package's
    ``_init_state``: Signum keeps its momentum even at momentum 0)."""
    if isinstance(optimizer, _opt.SGD):
        count = 1 if optimizer.momentum else 0
    elif isinstance(optimizer, _opt.Adam):
        count = 2
    elif isinstance(optimizer, _opt.RMSProp):
        count = 3 if optimizer.centered else 1
    else:                                       # Signum, AdaGrad
        count = 1
    return tuple(torch.zeros_like(weight, dtype=torch.float32)
                 for _ in range(count))


_WEIGHT_RULES = (_init.Xavier, _init.Normal, _init.Uniform, _init.Zero,
                 _init.One, _init.Constant)


def _device_init_rule(initializer, attrs):
    """Whether ``initializer`` fills a parameter by a closed-form
    rule that draws on the parameter's own device (the port of the JAX
    package's ``_device_init_rule``, which returned that rule; the
    port's standard initializers already draw from the device's
    generator, so the rule is the initializer itself): a variable's
    ``__init__`` attribute naming a standard initializer, or a standard
    initializer whose dispatch and rules are not overridden.  Anything
    else (custom subclasses, unknown names) fills on the host."""
    if attrs and attrs.get("__init__"):
        try:
            klass, kw = json.loads(attrs["__init__"])
            inst = _init.create(klass, **kw)
        except (ValueError, TypeError, MXNetError):
            return False
        return type(inst) in _WEIGHT_RULES
    cls = type(initializer)
    if cls.__call__ is not _init.Initializer.__call__:
        return False
    for meth in ("_init_zero", "_init_one"):
        if getattr(cls, meth) is not getattr(_init.Initializer, meth):
            return False
    return cls in _WEIGHT_RULES


class TrainStep:
    """symbol + optimizer -> a training step on one device.

    Usage::

        ts = TrainStep(sym, optimizer, data_shapes={'data': (128, 224, 224, 3)},
                       label_shapes={'softmax_label': (128,)})
        ts.init_params(mx.init.Xavier())
        for batch in loader:
            outs = ts.step({'data': x, 'softmax_label': y})

    ``ctx`` is the device (``gpu(0)`` when not given; pass ``mx.cpu()``
    to run on the host)."""

    def __init__(self, symbol, optimizer, data_shapes, label_shapes=None,
                 mesh=None, dtype="float32", ctx=None):
        if mesh is not None:
            raise MXNetError("TrainStep(mesh=...) comes with the multi-GPU "
                             "slice of the PyTorch port")
        if dtype != "float32":
            raise MXNetError("TrainStep(dtype=%r) comes with the bf16 slice "
                             "of the PyTorch port" % (dtype,))
        self._symbol = symbol
        self._optimizer = optimizer
        input_shapes = dict(data_shapes)
        input_shapes.update(label_shapes or {})
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in input_shapes]
        self._aux_names = symbol.list_auxiliary_states()
        self._exe = symbol.simple_bind(
            ctx, grad_req={n: "write" for n in self._param_names},
            **input_shapes)
        self.states = None           # name -> tuple of f32 tensors
        self._nstep = 0

    @property
    def params(self):
        """name -> the bound parameter, detached (a view of the tensor
        each step updates in place)."""
        return {n: self._exe.arg_dict[n]._data.detach()
                for n in self._param_names}

    @property
    def auxs(self):
        """name -> the bound auxiliary-state tensor."""
        return {n: self._exe.aux_dict[n]._data for n in self._aux_names}

    @property
    def grads(self):
        """name -> the last step's gradient tensor."""
        return {n: self._exe.grad_dict[n]._data for n in self._param_names}

    def init_params(self, initializer, arg_params=None, aux_params=None,
                    device_init=True):
        """Fill every parameter and auxiliary state: from ``arg_params``
        / ``aux_params`` (numpy arrays, tensors or NDArrays) where they
        name it, else by ``initializer`` with the variable's attributes.
        With ``device_init`` (the default) a standard initializer draws
        on the device from its generator (``_device_init_rule``);
        anything else fills a host array that is copied over."""
        attrs = self._symbol.attr_dict()
        for names, bound, given in (
                (self._param_names, self._exe.arg_dict, arg_params or {}),
                (self._aux_names, self._exe.aux_dict, aux_params or {})):
            for name in names:
                dst = bound[name]
                if name in given:
                    dst[:] = given[name]
                    continue
                desc = _init.InitDesc(name, attrs.get(name))
                if device_init and _device_init_rule(initializer,
                                                     attrs.get(name)):
                    initializer(desc, dst)
                else:
                    host = NDArray(torch.zeros(dst.shape))
                    initializer(desc, host)
                    dst[:] = host
        self.states = {n: _init_state(self._optimizer, t)
                       for n, t in self.params.items()}

    def step(self, batch):
        """One step on ``batch`` (input name -> array: numpy, tensor or
        NDArray, on any device); returns the forward outputs as
        tensors on the step's device."""
        if self.states is None:
            raise MXNetError("call init_params() first")
        self._nstep += 1
        opt = self._optimizer
        opt.num_update = max(opt.num_update, self._nstep)
        lr = (opt.lr_scheduler(opt.num_update)
              if opt.lr_scheduler is not None else opt.lr)
        if isinstance(opt, _opt.Adam):
            t = self._nstep
            lr *= (1.0 - opt.beta2 ** t) ** 0.5 / (1.0 - opt.beta1 ** t)
        outs = self._exe.forward(is_train=True, **batch)
        self._exe.backward()
        params, grads = self.params, self.grads
        for name in self._param_names:
            _update(opt, name, params[name], grads[name], self.states[name],
                    lr)
        return [o._data for o in outs]

    def get_params(self):
        """``(args, auxs)``: name -> host NDArray copies (for
        checkpointing)."""
        return tuple({n: NDArray(t.detach().cpu().clone())
                      for n, t in d.items()}
                     for d in (self.params, self.auxs))
