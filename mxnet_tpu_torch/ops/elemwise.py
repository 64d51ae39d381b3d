"""Elementwise and reduction operators of the serving slice.

Counterpart of ``mxnet_tpu/ops/elemwise.py``: the binary ops behind
``Symbol.__add__``/``__sub__`` and ``argmax``.
"""
from __future__ import annotations

import torch

from .registry import register


@register("broadcast_add", aliases=("broadcast_plus",))
def broadcast_add(lhs, rhs):
    return lhs + rhs


@register("broadcast_sub", aliases=("broadcast_minus",))
def broadcast_sub(lhs, rhs):
    return lhs - rhs


@register("_plus_scalar")
def plus_scalar(data, *, scalar):
    return data + scalar


@register("_minus_scalar")
def minus_scalar(data, *, scalar):
    return data - scalar


@register("argmax")
def argmax(data, *, axis=None, keepdims=False):
    """Index of the first maximum, as float32 like the reference."""
    if axis is None:
        out = torch.argmax(data)
    else:
        out = torch.argmax(data, dim=int(axis), keepdim=bool(keepdims))
    return out.to(torch.float32)
