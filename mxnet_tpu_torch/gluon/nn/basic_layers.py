"""Core Gluon layers: the sequentials, Dense, activations, norms,
embedding, Flatten and the lambdas.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py`` (reference
python/mxnet/gluon/nn/basic_layers.py), with the same constructor
signatures and parameter names (``weight``/``bias``, ``gamma``/``beta``,
``running_mean``/``running_var``).  Every hybrid layer is one registered
op, so it runs the same eagerly and in a hybridized graph.
``nn.LayerNorm`` reaches the LayerNorm kernels (forward and backward)
through the ``LayerNorm`` op; ``Dropout`` through the ``Dropout`` op,
which draws only under ``autograd.train_mode()``/``record()`` (the
imperative call draws a fresh seed each time, a hybridized block a step
seed each forward).
"""
from __future__ import annotations

import numpy as _np

from ...base import MXNetError
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Dropout", "BatchNorm", "InstanceNorm", "LayerNorm", "Embedding",
           "Flatten", "Lambda", "HybridLambda", "LeakyReLU"]


class _ChainMixin:
    """add/len/index/iterate over the children of both sequentials."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())

    def __getitem__(self, key):
        picked = list(self._children.values())[key]
        if not isinstance(key, slice):
            return picked
        view = type(self)(prefix=self._prefix)
        with view.name_scope():
            view.add(*picked)
        return view


class Sequential(_ChainMixin, Block):
    """Blocks run one after another, eagerly."""

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x


class HybridSequential(_ChainMixin, HybridBlock):
    """HybridBlocks run one after another; hybridizes into one graph."""

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """Fully-connected layer (the FullyConnected op); ``flatten=True``
    collapses the axes after the first."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(units,), dtype=dtype, init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = None if activation is None else \
                Activation(activation, prefix=activation + "_")

    def _infer_param_shapes(self, x):
        width = int(_np.prod(x.shape[1:])) if self._flatten else x.shape[-1]
        self.weight._shape_from_data((self._units, width))

    def hybrid_forward(self, F, x, weight, bias=None):
        y = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                             num_hidden=self._units, flatten=self._flatten)
        return y if self.act is None else self.act(y)

    def __repr__(self):
        w = self.weight.shape
        return "Dense(%s -> %s, %s)" % (w[1] or None, w[0],
                                        self.act or "linear")


class Activation(HybridBlock):
    """A named nonlinearity (relu, sigmoid, tanh, softrelu, softsign)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation         # read by _alias()
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return "Activation(%s)" % self._act_type


class LeakyReLU(HybridBlock):
    """max(x, alpha * x)."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class Dropout(HybridBlock):
    """Inverted dropout of rate ``rate`` while training (reference
    basic_layers.py Dropout); ``axes`` share one mask value along them."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = tuple(axes)

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return "Dropout(p = %s, axes=%s)" % (self._rate, self._axes)


def _register_affine(layer, scale, center, in_channels, gamma_init,
                     beta_init):
    """gamma and beta of the norm layers; a disabled one is a frozen
    ('null' gradient) parameter, as in the reference."""
    layer.gamma = layer.params.get(
        "gamma", grad_req="write" if scale else "null",
        shape=(in_channels,), init=gamma_init, allow_deferred_init=True,
        differentiable=scale)
    layer.beta = layer.params.get(
        "beta", grad_req="write" if center else "null",
        shape=(in_channels,), init=beta_init, allow_deferred_init=True,
        differentiable=center)


class _Norm(HybridBlock):
    """Shared shape rule: every parameter is one vector over ``axis``."""

    def _infer_param_shapes(self, x):
        ch = x.shape[self._axis]
        for p in self._reg_params.values():
            p._shape_from_data((ch,))


class BatchNorm(_Norm):
    """Batch normalization; the running statistics are parameters
    without gradients that a train-mode forward moves (``fix_gamma`` is
    ``not scale``, as in the reference)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        with self.name_scope():
            _register_affine(self, scale, center, in_channels,
                             gamma_initializer, beta_initializer)
            for stat, init in (("running_mean", running_mean_initializer),
                               ("running_var", running_variance_initializer)):
                setattr(self, stat, self.params.get(
                    stat, grad_req="null", shape=(in_channels,), init=init,
                    allow_deferred_init=True, differentiable=False))

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           **self._kwargs)


class InstanceNorm(_Norm):
    """Normalize each sample and channel over the spatial axes."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            _register_affine(self, scale, center, in_channels,
                             gamma_initializer, beta_initializer)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class LayerNorm(_Norm):
    """Normalize over one axis (the last) per sample, through the
    LayerNorm kernels."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            _register_affine(self, scale, center, in_channels,
                             gamma_initializer, beta_initializer)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class Embedding(HybridBlock):
    """Row lookup in a trainable (input_dim, output_dim) table."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)


class Flatten(HybridBlock):
    """Collapse every axis after the first."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


class Lambda(Block):
    """A function (or the name of an ``mx.nd`` function) as a Block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd
            if not hasattr(nd, function):
                raise MXNetError("Function name %s is not found in ndarray."
                                 % function)
            self._func_name, self._func = function, getattr(nd, function)
        else:
            self._func_name, self._func = function.__name__, function

    def forward(self, *args):
        return self._func(*args)

    def __repr__(self):
        return "Lambda(%s)" % self._func_name


class HybridLambda(HybridBlock):
    """An ``f(F, x, ...)`` function (or the name of an op in both
    ``mx.nd`` and ``mx.sym``) as a HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd
            from ... import symbol as sym
            if not (hasattr(nd, function) and hasattr(sym, function)):
                raise MXNetError("Function name %s is not found in "
                                 "ndarray/symbol." % function)
            self._func_name = function
            self._func = lambda F, *args: getattr(F, function)(*args)
        else:
            self._func_name, self._func = function.__name__, function

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return "HybridLambda(%s)" % self._func_name
