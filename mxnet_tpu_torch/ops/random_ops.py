"""Random sampling operators.

Counterpart of ``mxnet_tpu/ops/random_ops.py`` for ``_random_uniform``,
``_random_normal`` and ``_random_randint`` (``mx.nd.random.uniform``,
``normal`` and ``randint``).  Each draws on its ``ctx`` (default: the
current context) from that device's ``torch.Generator``
(``random.generator``), so ``mx.random.seed`` makes the draws
reproducible; they are not the JAX package's numbers (``jax.random``
keys and torch generators differ), so tests compare distributions.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import torch_dtype
from ..context import current_context
from .registry import register


def _target(ctx, dtype):
    dev = (ctx if ctx is not None else current_context()).torch_device
    return dev, torch_dtype(dtype or "float32"), _random.generator(dev)


@register("_random_uniform", aliases=("random_uniform", "uniform"))
def random_uniform(*, low=0.0, high=1.0, shape=(), dtype="float32",
                   ctx=None):
    """Uniform on [low, high)."""
    dev, dt, gen = _target(ctx, dtype)
    out = torch.empty(tuple(shape), dtype=dt, device=dev)
    return out.uniform_(float(low), float(high), generator=gen)


@register("_random_normal", aliases=("random_normal", "normal"))
def random_normal(*, loc=0.0, scale=1.0, shape=(), dtype="float32",
                  ctx=None):
    """Normal with mean ``loc`` and standard deviation ``scale``."""
    dev, dt, gen = _target(ctx, dtype)
    out = torch.empty(tuple(shape), dtype=dt, device=dev)
    return out.normal_(float(loc), float(scale), generator=gen)


@register("_random_randint", aliases=("random_randint",))
def random_randint(*, low=0, high=1, shape=(), dtype="int32", ctx=None):
    """Integers uniform on [low, high)."""
    dev, dt, gen = _target(ctx, dtype)
    return torch.randint(int(low), int(high), tuple(shape), generator=gen,
                         dtype=dt, device=dev)
