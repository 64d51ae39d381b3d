"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: ``InitDesc``, the
dispatch of ``Initializer.__call__`` by the variable's ``__init__``
attribute and then by name suffix, ``dumps``, and ``Uniform``,
``Normal``, ``Zero``, ``One``, ``Constant``, ``Xavier`` (with the JAX
package's fan computation), ``MSRAPrelu``, ``Orthogonal``, ``Bilinear``,
``Load`` and ``Mixed``.  Random values are drawn on the array's own
device from that device's generator (``random.generator``), so
``mx.random.seed`` makes them reproducible; they are not the JAX
package's numbers (``Orthogonal`` draws there too and takes its SVD on
the host in float64).  ``LSTMBias`` (the cell zoo's ``i2h_bias``) and
``FusedRNN`` (the fused RNN op's packed vector) are the JAX package's
(``mxnet_tpu/initializer.py:283-330``); ``FusedRNN`` draws its weights
from numpy's global stream as the JAX package's does, so a seed of that
stream gives both packages the same vector.  ``FusedRNN`` keeps its
arguments in ``dumps()`` (the reference's form), so a FusedRNNCell's
``__init__`` attribute resolves at ``init_params``; the JAX package's
writes ``["fusedrnn", {}]``, which no initializer there resolves
(ROADMAP C).  A variable named ``*_parameters`` (a fused RNN op's
vector with no ``__init__``) takes ``_init_rnn_packed``: the weight
rule, except Xavier's, which has no fans to read there and draws
uniform on +-0.07 as the JAX package's does.
"""
from __future__ import annotations

import json
import math
import re

import numpy as _np
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Zero", "One", "Constant",
           "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear", "Load", "Mixed",
           "LSTMBias", "FusedRNN", "InitDesc", "register", "create"]

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An initializer by registered name (or the instance itself)."""
    if isinstance(name, Initializer):
        return name
    key = str(name).lower()
    if key not in _INIT_REGISTRY:
        raise MXNetError("unknown initializer '%s'" % name)
    return _INIT_REGISTRY[key](**kwargs)


class InitDesc(str):
    """Parameter name plus its symbol attributes (reference
    initializer.py InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _draw(arr, fill):
    """``fill(tensor, generator)`` into a fresh f32 tensor on ``arr``'s
    device, then copy it into ``arr``."""
    t = arr._data
    buf = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    fill(buf, _random.generator(t.device))
    arr[:] = buf


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``[name, kwargs]`` as JSON, the form a Variable's ``init=``
        is stored in (``__init__`` attribute)."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        init_attr = desc.attrs.get("__init__", "")
        if init_attr:
            klass, kwargs = json.loads(init_attr)
            create(klass, **kwargs)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("_weight"):
            self._init_weight(desc, arr)
        elif name.endswith("_bias") or name.endswith("_beta"):
            self._init_zero(desc, arr)
        elif name.endswith("_gamma"):
            self._init_one(desc, arr)
        elif name.endswith(("_moving_mean", "_running_mean", "_moving_avg",
                            "_min", "_max")):
            self._init_zero(desc, arr)
        elif name.endswith(("_moving_var", "_running_var")):
            self._init_one(desc, arr)
        elif name.endswith("_parameters"):
            self._init_rnn_packed(desc, arr)
        else:
            self._init_weight(desc, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_rnn_packed(self, name, arr):
        """A fused RNN op's packed 1-D vector: the weight rule."""
        self._init_weight(name, arr)

    def _init_zero(self, name, arr):
        arr[:] = 0.0

    def _init_one(self, name, arr):
        arr[:] = 1.0

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._kwargs)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        _draw(arr, lambda t, g: t.uniform_(-self.scale, self.scale,
                                           generator=g))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        _draw(arr, lambda t, g: t.normal_(0.0, self.sigma, generator=g))


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 1.0


_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        arr[:] = self.value


@register
class Xavier(Initializer):
    """Xavier/Glorot: scale sqrt(magnitude / factor) with factor the
    fan-in, fan-out or their mean; dims past the second multiply both
    fans (the JAX package's fan computation)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_rnn_packed(self, name, arr):
        # no fan structure in the packed vector: small uniform, as the
        # JAX package's Xavier draws there
        _draw(arr, lambda t, g: t.uniform_(-0.07, 0.07, generator=g))

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError("Xavier requires >=2D weight, got %s for %s"
                             % (shape, name))
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale
        fan_out = shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        else:
            factor = fan_out
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _draw(arr, lambda t, g: t.uniform_(-scale, scale, generator=g))
        else:
            _draw(arr, lambda t, g: t.normal_(0.0, scale, generator=g))


@register
class MSRAPrelu(Xavier):
    """He/MSRA initialization for PReLU nets: Xavier with gaussian draws
    and magnitude ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        Initializer.__init__(self, factor_type=factor_type, slope=slope)
        self.rnd_type = "gaussian"
        self.factor_type = factor_type
        self.magnitude = 2.0 / (1 + slope ** 2)


@register
class Orthogonal(Initializer):
    """A (scaled) orthogonal matrix over the weight flattened to (out,
    in): the SVD factor of a uniform or normal draw whose shape is the
    weight's, times ``scale``."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        t = arr._data
        tmp = torch.empty((nout, nin), dtype=torch.float32, device=t.device)
        gen = _random.generator(t.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=gen)
        else:
            tmp.normal_(0.0, 1.0, generator=gen)
        u, _, v = _np.linalg.svd(tmp.cpu().double().numpy(),
                                 full_matrices=False)
        q = u if u.shape == (nout, nin) else v
        arr[:] = (self.scale * q).reshape(arr.shape).astype(_np.float32)


@register
class Bilinear(Initializer):
    """The bilinear up-sampling kernel of a 4-D (deconvolution)
    weight."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        size = math.prod(shape)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        idx = _np.arange(size)
        x = idx % shape[3]
        y = (idx // shape[3]) % shape[2]
        weight = ((1 - _np.abs(x / f - c)) * (1 - _np.abs(y / f - c)))
        arr[:] = weight.astype(_np.float32).reshape(shape)


@register
class Load(Initializer):
    """Values from ``param`` (name, ``arg:name`` or ``aux:name`` ->
    array), else ``default_init``; raises when neither has one."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = param
        self.default_init = default_init
        self._kwargs = {}

    def __call__(self, name, arr):
        name = str(name)
        for key in (name, "arg:" + name, "aux:" + name):
            if key in self.param:
                src = self.param[key]
                if tuple(src.shape) != tuple(arr.shape):
                    raise MXNetError("shape mismatch loading %s" % name)
                arr[:] = src
                return
        if self.default_init is None:
            raise MXNetError("no init value for %s" % name)
        self.default_init(InitDesc(name), arr)


@register
class Mixed(Initializer):
    """The initializer of the first pattern (a regular expression
    matched at the name's start) that matches the name."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))
        self._kwargs = {}

    def __call__(self, name, arr):
        for pat, init in self.map:
            if pat.match(str(name)):
                init(name, arr)
                return
        raise MXNetError("no initializer matches %s" % name)


@register
class LSTMBias(Initializer):
    """Zeros with the forget gate's quarter (cuDNN order i, f, g, o) set
    to ``forget_bias`` (Jozefowicz et al. 2015)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def __call__(self, desc, arr):
        # its rule whatever the name (the JAX package's LSTMBias takes
        # the weight, bias and default rules)
        self._init_weight(desc, arr)

    def _init_weight(self, name, arr):
        h = arr.shape[0] // 4
        a = _np.zeros(arr.shape, dtype=_np.float32)
        a[h:2 * h] = self.forget_bias
        arr[:] = a


@register
class FusedRNN(Initializer):
    """The fused RNN op's packed vector: the weights uniform on +-0.07
    from numpy's global stream, the biases zero, each LSTM bias block's
    forget quarter ``forget_bias`` (``mxnet_tpu/initializer.py:302-330``,
    which also leaves ``init`` unused)."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, Initializer):
            init = init.dumps()
        super().__init__(init=init, num_hidden=num_hidden,
                         num_layers=num_layers, mode=mode,
                         bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._num_hidden = int(num_hidden)
        self._num_layers = int(num_layers)
        self._mode = mode
        self._bidirectional = bool(bidirectional)
        self._forget_bias = forget_bias

    def _init_weight(self, name, arr):
        from .ops.rnn import _NGATES
        H = self._num_hidden
        per = _NGATES[self._mode] * H
        blocks = self._num_layers * (2 if self._bidirectional else 1) * 2
        total = math.prod(arr.shape)
        wpart = _np.random.uniform(-0.07, 0.07, total - blocks * per)
        bpart = _np.zeros(blocks * per, dtype=_np.float32)
        if self._mode == "lstm":
            for blk in range(blocks):
                bpart[blk * per + H:blk * per + 2 * H] = self._forget_bias
        arr[:] = _np.concatenate([wpart, bpart]).astype(
            _np.float32).reshape(arr.shape)

    _init_rnn_packed = _init_weight
