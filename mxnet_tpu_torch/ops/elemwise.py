"""Elementwise, broadcast and reduction operators.

Counterpart of ``mxnet_tpu/ops/elemwise.py``: the broadcast binary ops
behind ``NDArray``'s and ``Symbol``'s arithmetic and comparison
operators, their ``*_scalar`` forms (``reverse=True`` puts the scalar on
the left, as the JAX package's do), the unary math ops, the reductions
with ``axis``/``keepdims``/``exclude``, ``log_softmax``/``softmax``,
``dot``/``batch_dot``, ``where``, ``clip``, ``add_n``, ``BlockGrad``
and ``make_loss``.  The arithmetic follows the JAX package's: a scalar
takes the data's type (an integer array stays integer), integer
division truncates, ``mod`` takes the divisor's sign, and comparisons
give 0/1 in the left operand's type.
"""
from __future__ import annotations

import torch

from .registry import register


# ----------------------------------------------------------------------
# broadcast binary
# ----------------------------------------------------------------------
def _is_float(v):
    return v.is_floating_point() if isinstance(v, torch.Tensor) \
        else isinstance(v, float)


def _ref_div(a, b):
    """Integer operands keep their type with C-style truncation (the
    reference's mshadow ``/``); floats divide normally."""
    if _is_float(a) or _is_float(b):
        return torch.true_divide(a, b)
    return torch.div(a, b, rounding_mode="trunc")


def _mod(a, b):
    return torch.remainder(a, b)


def _cmp(fn):
    def impl(a, b):
        return fn(a, b).to(a.dtype)
    return impl


def _defbinary(name, fn, aliases=()):
    def impl(lhs, rhs):
        return fn(lhs, rhs)
    impl.__name__ = name
    impl.__doc__ = "Broadcast binary op %s (ref src/operator/tensor/)" % name
    register(name, aliases=aliases)(impl)


_defbinary("broadcast_add", torch.add,
           aliases=("broadcast_plus", "elemwise_add", "_add", "_plus"))
_defbinary("broadcast_sub", torch.sub,
           aliases=("broadcast_minus", "elemwise_sub", "_sub", "_minus"))
_defbinary("broadcast_mul", torch.mul, aliases=("elemwise_mul", "_mul"))
_defbinary("broadcast_div", _ref_div, aliases=("elemwise_div", "_div"))
_defbinary("broadcast_mod", _mod, aliases=("_mod",))
_defbinary("broadcast_power", torch.pow, aliases=("_power", "pow"))
_defbinary("broadcast_maximum", torch.maximum, aliases=("maximum",))
_defbinary("broadcast_minimum", torch.minimum, aliases=("minimum",))
_defbinary("broadcast_hypot", torch.hypot, aliases=("_hypot",))
_defbinary("broadcast_equal", _cmp(torch.eq), aliases=("_equal",))
_defbinary("broadcast_not_equal", _cmp(torch.ne), aliases=("_not_equal",))
_defbinary("broadcast_greater", _cmp(torch.gt), aliases=("_greater",))
_defbinary("broadcast_greater_equal", _cmp(torch.ge),
           aliases=("_greater_equal",))
_defbinary("broadcast_lesser", _cmp(torch.lt), aliases=("_lesser",))
_defbinary("broadcast_lesser_equal", _cmp(torch.le),
           aliases=("_lesser_equal",))


# ----------------------------------------------------------------------
# scalar binary: the scalar takes the data's type
# ----------------------------------------------------------------------
def _scalar(data, scalar):
    if data.is_floating_point():
        return float(scalar)
    if data.dtype == torch.bool:
        return bool(scalar)
    return int(scalar)


def _defscalar(name, fn, tensor_scalar=False):
    def impl(data, *, scalar=1.0, reverse=False):
        s = _scalar(data, scalar)
        if reverse or tensor_scalar:
            s = torch.full((), s, dtype=data.dtype, device=data.device)
        return fn(s, data) if reverse else fn(data, s)
    impl.__name__ = name
    register(name)(impl)


_defscalar("_plus_scalar", torch.add)
_defscalar("_minus_scalar", torch.sub)
_defscalar("_mul_scalar", torch.mul)
_defscalar("_div_scalar", _ref_div)
_defscalar("_mod_scalar", _mod)
_defscalar("_power_scalar", torch.pow)
_defscalar("_maximum_scalar", torch.maximum, tensor_scalar=True)
_defscalar("_minimum_scalar", torch.minimum, tensor_scalar=True)


def _defscalar_cmp(name, fn):
    def impl(data, *, scalar=0.0, reverse=False):
        s = torch.full((), _scalar(data, scalar), dtype=data.dtype,
                       device=data.device)
        out = fn(s, data) if reverse else fn(data, s)
        return out.to(data.dtype)
    impl.__name__ = name
    register(name)(impl)


_defscalar_cmp("_equal_scalar", torch.eq)
_defscalar_cmp("_not_equal_scalar", torch.ne)
_defscalar_cmp("_greater_scalar", torch.gt)
_defscalar_cmp("_greater_equal_scalar", torch.ge)
_defscalar_cmp("_lesser_scalar", torch.lt)
_defscalar_cmp("_lesser_equal_scalar", torch.le)


# ----------------------------------------------------------------------
# unary math
# ----------------------------------------------------------------------
def _defunary(name, fn, aliases=()):
    def impl(data):
        return fn(data)
    impl.__name__ = name
    impl.__doc__ = "Elementwise %s (ref src/operator/tensor/" \
        "elemwise_unary_op)" % name
    register(name, aliases=aliases)(impl)


def _float_mask(fn):
    return lambda x: fn(x).to(torch.float32)


_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "negative": torch.neg,
    "reciprocal": torch.reciprocal, "square": torch.square,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
    "cbrt": lambda x: torch.sign(x) * torch.abs(x).pow(1.0 / 3.0),
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "floor": torch.floor, "ceil": torch.ceil, "trunc": torch.trunc,
    "rint": torch.round, "round": torch.round, "fix": torch.trunc,
    "sigmoid": torch.sigmoid, "softsign": torch.nn.functional.softsign,
    "relu": torch.relu, "erf": torch.erf, "erfinv": torch.erfinv,
    "gammaln": torch.lgamma, "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "logical_not": lambda x: torch.logical_not(x).to(x.dtype),
    "zeros_like": torch.zeros_like, "ones_like": torch.ones_like,
    "isnan": _float_mask(torch.isnan), "isinf": _float_mask(torch.isinf),
    "isfinite": _float_mask(torch.isfinite),
}
for _name, _fn in _UNARY.items():
    _defunary(_name, _fn)
_defunary("identity", lambda x: x, aliases=("_copy",))


@register("BlockGrad", aliases=("stop_gradient",))
def block_grad(data):
    """Stop the gradient (ref elemwise_unary_op_basic.cc)."""
    return data.detach()


class _MakeLossFn(torch.autograd.Function):
    """Identity forward; the backward seeds ``grad_scale`` whatever the
    head's gradient (ref src/operator/make_loss.cc)."""

    @staticmethod
    def forward(ctx, x, grad_scale, normalization, valid_thresh):
        ctx.save_for_backward(x)
        ctx.args = (grad_scale, normalization, valid_thresh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, _g):
        (x,) = ctx.saved_tensors
        grad_scale, normalization, valid_thresh = ctx.args
        # made on the device by a fill: a host-to-device copy would stop
        # a graph capture (the fused fit step's)
        scale = torch.full((), grad_scale, dtype=torch.float32,
                           device=x.device)
        if normalization == "batch":
            scale = scale / x.shape[0]
        elif normalization == "valid":
            valid = (x.abs() > valid_thresh).sum().float().clamp(min=1.0)
            scale = scale / valid
        return torch.ones_like(x) * scale.to(x.dtype), None, None, None


@register("make_loss", aliases=("MakeLoss",))
def make_loss(data, *, grad_scale=1.0, valid_thresh=0.0,
              normalization="null"):
    return _MakeLossFn.apply(data, float(grad_scale), normalization,
                             float(valid_thresh))


@register("add_n", aliases=("ElementWiseSum",))
def add_n(*args, num_args=None):
    """Sum of N arrays (ref src/operator/tensor/elemwise_sum.cc)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("clip")
def clip(data, *, a_min=0.0, a_max=1.0):
    return torch.clamp(data, a_min, a_max)


@register("where")
def where(condition, x, y):
    return torch.where(condition.bool(), x, y)


@register("smooth_l1")
def smooth_l1(data, *, scalar=1.0):
    s2 = scalar * scalar
    absx = data.abs()
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * data.square(),
                       absx - 0.5 / s2)


# ----------------------------------------------------------------------
# reductions (ref broadcast_reduce_op_value.cc)
# ----------------------------------------------------------------------
def reduce_axes(ndim, axis, exclude=False):
    """The reduced axes as a tuple (every axis when ``axis`` is None or
    ``()``); ``exclude`` reduces every axis but those."""
    if axis is None or axis == ():
        return tuple(range(ndim))
    sel = tuple(int(a) % ndim for a in (
        axis if isinstance(axis, (list, tuple)) else (axis,)))
    if exclude:
        return tuple(a for a in range(ndim) if a not in sel)
    return tuple(sorted(set(sel)))


def _keep_int(fn):
    """torch widens integer sums to int64; the reference keeps the
    input's type."""
    def impl(x, dim, keepdim):
        out = fn(x, dim=dim, keepdim=keepdim)
        return out if x.is_floating_point() else out.to(x.dtype)
    return impl


def _prod(x, dim, keepdim):
    out = x
    for d in sorted(dim, reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out if x.is_floating_point() else out.to(x.dtype)


def _mean(x, dim, keepdim):
    return torch.mean(x if x.is_floating_point() else x.float(), dim=dim,
                      keepdim=keepdim)


_REDUCE = {"sum": (_keep_int(torch.sum), ("sum_axis",)),
           "mean": (_mean, ()),
           "prod": (_prod, ()),
           "max": (torch.amax, ("max_axis",)),
           "min": (torch.amin, ("min_axis",)),
           "nansum": (_keep_int(torch.nansum), ())}


def _defreduce(name, fn, aliases):
    def impl(data, *, axis=None, keepdims=False, exclude=False):
        dims = reduce_axes(data.dim(), axis, exclude)
        if not dims:
            return data
        return fn(data, dim=dims, keepdim=bool(keepdims))
    impl.__name__ = name
    register(name, aliases=aliases)(impl)


for _name, (_fn, _aliases) in _REDUCE.items():
    _defreduce(_name, _fn, _aliases)


@register("norm")
def norm(data, *, ord=2, axis=None, keepdims=False):
    dims = reduce_axes(data.dim(), axis)
    if ord == 1:
        return data.abs().sum(dim=dims, keepdim=bool(keepdims))
    return data.square().sum(dim=dims, keepdim=bool(keepdims)).sqrt()


@register("argmax")
def argmax(data, *, axis=None, keepdims=False):
    """Index of the first maximum, as float32 like the reference."""
    if axis is None:
        out = torch.argmax(data)
    else:
        out = torch.argmax(data, dim=int(axis), keepdim=bool(keepdims))
    return out.to(torch.float32)


@register("argmin")
def argmin(data, *, axis=None, keepdims=False):
    if axis is None:
        out = torch.argmin(data)
    else:
        out = torch.argmin(data, dim=int(axis), keepdim=bool(keepdims))
    return out.to(torch.float32)


def _temper(data, temperature):
    return data if temperature in (None, 1.0) else data / temperature


@register("log_softmax")
def log_softmax(data, *, axis=-1, temperature=None):
    return torch.log_softmax(_temper(data, temperature), dim=int(axis))


@register("softmax")
def softmax(data, *, axis=-1, temperature=None):
    """Softmax along ``axis`` (ref src/operator/nn/softmax.cc)."""
    return torch.softmax(_temper(data, temperature), dim=int(axis))


@register("softmin")
def softmin(data, *, axis=-1, temperature=None):
    return torch.softmax(-_temper(data, temperature), dim=int(axis))


@register("dot")
def dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    """Reduce over the last axis of lhs and the first of rhs (ref
    src/operator/tensor/dot.cc)."""
    a = (lhs.t() if lhs.dim() == 2 else lhs.movedim(0, -1)) \
        if transpose_a else lhs
    b = (rhs.t() if rhs.dim() == 2 else rhs.movedim(-1, 0)) \
        if transpose_b else rhs
    return torch.tensordot(a, b, dims=1)


@register("batch_dot")
def batch_dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)
