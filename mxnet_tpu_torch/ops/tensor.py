"""Tensor shape and index operators.

Counterpart of ``mxnet_tpu/ops/tensor.py``: ``Reshape`` with MXNet's
magic values, ``Cast``, ``take``, ``slice_axis``, ``Concat``, and for
the imperative front end ``transpose``, ``expand_dims``, ``squeeze``,
``swapaxes``, ``stack``, ``split``, ``slice``, ``slice_like``, ``pick``,
``batch_take``, ``one_hot``, ``tile``, ``repeat``, ``Pad``,
``reverse``, the ``broadcast_*`` shape ops and ``reshape_like``.
Indices are clipped into range, as the reference's ``mode='clip'``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
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


@register("transpose")
def transpose(data, *, axes=()):
    """Permute the axes (reverse them when ``axes`` is empty)."""
    axes = tuple(int(a) for a in axes) if axes else \
        tuple(range(data.dim() - 1, -1, -1))
    return data.permute(axes)


@register("expand_dims")
def expand_dims(data, *, axis):
    return data.unsqueeze(int(axis))


@register("squeeze")
def squeeze(data, *, axis=None):
    if axis is None:
        return data.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return data.squeeze(tuple(int(a) for a in axes))


@register("SwapAxis", aliases=("swapaxes",))
def swapaxes(data, *, dim1=0, dim2=0):
    return data.transpose(int(dim1), int(dim2))


@register("stack")
def stack(*args, num_args=None, axis=0):
    return torch.stack(args, dim=int(axis))


def _split_outputs(attrs):
    return int(attrs.get("num_outputs", 1))


@register("SliceChannel", aliases=("split",), num_outputs=_split_outputs)
def slice_channel(data, *, num_outputs, axis=1, squeeze_axis=False):
    """Split along ``axis`` into equal parts (ref slice_channel.cc)."""
    parts = torch.chunk(data, int(num_outputs), dim=int(axis))
    if squeeze_axis:
        parts = [p.squeeze(int(axis)) for p in parts]
    return tuple(parts)


@register("slice", aliases=("crop",))
def slice_op(data, *, begin, end, step=()):
    step = tuple(step) if step else (None,) * len(begin)
    return data[tuple(slice(b, e, s) for b, e, s in zip(begin, end, step))]


@register("slice_like")
def slice_like(data, shape_like, *, axes=()):
    axes = tuple(axes) if axes else tuple(range(shape_like.dim()))
    idx = [slice(None)] * data.dim()
    for ax in axes:
        idx[ax] = slice(0, shape_like.shape[ax])
    return data[tuple(idx)]


@register("pick")
def pick(data, index, *, axis=-1, keepdims=False, mode="clip"):
    """``data`` picked along ``axis`` at ``index`` (ref
    broadcast_reduce_op_index.cc)."""
    ax = int(axis) % data.dim()
    n = data.shape[ax]
    idx = index.long()
    idx = idx.clamp(0, n - 1) if mode == "clip" else idx % n
    out = torch.gather(data, ax, idx.unsqueeze(ax))
    return out if keepdims else out.squeeze(ax)


@register("batch_take")
def batch_take(a, indices):
    idx = indices.long().clamp(0, a.shape[1] - 1)
    return torch.gather(a, 1, idx[:, None])[:, 0]


@register("one_hot")
def one_hot(indices, *, depth, on_value=1.0, off_value=0.0,
            dtype="float32"):
    """Rows of ``depth`` with ``on_value`` at each index; an index out of
    range gives a row of ``off_value``."""
    depth = int(depth)
    idx = indices.long()
    inside = (idx >= 0) & (idx < depth)
    oh = F.one_hot(idx.clamp(0, depth - 1), depth) * inside.unsqueeze(-1)
    oh = oh.to(torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register("tile")
def tile(data, *, reps):
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return data.tile(reps)


@register("repeat")
def repeat(data, *, repeats, axis=None):
    if axis is None:
        return data.reshape(-1).repeat_interleave(int(repeats))
    return data.repeat_interleave(int(repeats), dim=int(axis))


_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}


@register("Pad", aliases=("pad",))
def pad(data, *, mode="constant", pad_width=(), constant_value=0.0):
    """N-D padding (ref src/operator/pad.cc): ``pad_width`` is MXNet's
    flat (before, after) tuple over every axis.  ``edge`` and
    ``reflect`` pad only the axes after the first two, as the
    reference requires."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    if mode not in _PAD_MODES:
        raise MXNetError("Pad: unknown mode %r" % (mode,))
    if mode != "constant" and any(p for pair in pw[:2] for p in pair):
        raise MXNetError("Pad(mode=%r) pads only the axes after the first "
                         "two, got pad_width %s" % (mode, tuple(pad_width)))
    first = 0 if mode == "constant" else 2
    fpad = [p for pair in reversed(pw[first:]) for p in pair]
    if mode == "constant":
        return F.pad(data, fpad, value=float(constant_value))
    return F.pad(data, fpad, mode=_PAD_MODES[mode])


@register("reverse", aliases=("flip",))
def reverse(data, *, axis):
    axes = tuple(axis) if isinstance(axis, (tuple, list)) else (int(axis),)
    return torch.flip(data, dims=axes)


@register("broadcast_to")
def broadcast_to(data, *, shape):
    tgt = tuple(int(t) if int(t) != 0 else data.shape[i]
                for i, t in enumerate(shape))
    return data.expand(tgt)


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, *, axis=(), size=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, n in zip(axes, sizes):
        tgt[a] = n
    return data.expand(tuple(tgt))


@register("broadcast_like")
def broadcast_like(lhs, rhs):
    return lhs.expand(rhs.shape)


@register("reshape_like")
def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)
