"""Tensor shape/index operators of the serving slice.

Counterpart of ``mxnet_tpu/ops/tensor.py``: ``Reshape`` with MXNet's
magic values, ``Cast``, ``take``, ``slice_axis`` and ``Concat``.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def infer_magic(ishape, shape):
    """MXNet reshape magic values 0 (keep), -1 (infer), -2 (copy rest),
    -3 (merge two), -4 (split) — ref src/operator/tensor/matrix_op-inl.h."""
    out = []
    i = 0
    j = 0
    shape = list(shape)
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(ishape[i]); i += 1
        elif s == -1:
            out.append(-1); i += 1
        elif s == -2:
            out.extend(ishape[i:]); i = len(ishape)
        elif s == -3:
            out.append(ishape[i] * ishape[i + 1]); i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = ishape[i] // b
            if b == -1:
                b = ishape[i] // a
            out.extend([a, b]); i += 1; j += 2
        else:
            out.append(s); i += 1
        j += 1
    if -1 in out:
        known = 1
        for s in out:
            if s != -1:
                known *= s
        total = 1
        for s in ishape:
            total *= s
        out[out.index(-1)] = total // known if known else 0
    return tuple(out)


@register("Reshape", aliases=("reshape",))
def reshape(data, *, shape=()):
    """MXNet reshape (magic values in :func:`infer_magic`)."""
    return data.reshape(infer_magic(tuple(data.shape),
                                    tuple(int(s) for s in shape)))


@register("Cast", aliases=("cast",))
def cast(data, *, dtype):
    return data.to(torch_dtype(dtype))


@register("take")
def take(a, indices, *, axis=0, mode="clip"):
    """Gather along ``axis``; indices clipped (or wrapped) into range
    (ref src/operator/tensor/indexing_op.cc)."""
    axis = int(axis) % a.dim()
    n = a.shape[axis]
    idx = indices.long()
    idx = idx.clamp(0, n - 1) if mode == "clip" else idx % n
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + indices.shape + a.shape[axis + 1:])


@register("slice_axis")
def slice_axis(data, *, axis, begin, end):
    """``data[..., begin:end, ...]`` along ``axis`` (``end=None``: to
    the end)."""
    axis = int(axis) % data.dim()
    end = data.shape[axis] if end is None else int(end)
    return data.narrow(axis, int(begin), end - int(begin))


@register("Concat", aliases=("concat",))
def concat(*args, num_args=None, dim=1):
    """Join the inputs along ``dim``."""
    return torch.cat(args, dim=int(dim))
