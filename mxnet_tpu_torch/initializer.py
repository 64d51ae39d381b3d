"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``, reduced to what the
training slice uses: ``InitDesc``, the dispatch of
``Initializer.__call__`` by the variable's ``__init__`` attribute and
then by name suffix, ``dumps``, and ``Uniform``, ``Normal``, ``Zero``,
``One``, ``Constant`` and ``Xavier`` (with the JAX package's fan
computation).  Random values are drawn on the array's own device from
that device's generator (``random.generator``), so ``mx.random.seed``
makes them reproducible; they are not the JAX package's numbers.
"""
from __future__ import annotations

import json
import math

import torch

from . import random as _random
from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Zero", "One", "Constant",
           "Xavier", "InitDesc", "register", "create"]

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
        raise MXNetError("initializer '%s' is not in the PyTorch port yet"
                         % name)
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
        else:
            self._init_weight(desc, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

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
