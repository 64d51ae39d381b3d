"""NDArray package: imperative tensors and the generated op namespace.

Counterpart of ``mxnet_tpu/ndarray``: ``mx.nd.<op>`` for every operator
in the port's registry, the creation functions, ``mx.nd.random``
(uniform, normal, randint) and ``mx.nd.contrib`` (the ``_contrib_``
operators under their short names), and ``save``/``load``/
``load_frombuffer`` of NDArray files (``serialization.py``).
"""
import types as _types

from .. import ops as _ops  # noqa: F401  (registers every op)
from . import dispatch as _dispatch
from . import register as _register
from .ndarray import (NDArray, arange, array, concatenate, empty, full,
                      moveaxis, onehot_encode, ones, waitall, zeros)

_register.populate(globals())

# function forms of the operators (reference mx.nd module functions)
add = globals()["broadcast_add"]
subtract = globals()["broadcast_sub"]
multiply = globals()["broadcast_mul"]
divide = globals()["broadcast_div"]
power = globals()["broadcast_power"]
equal = globals()["broadcast_equal"]
not_equal = globals()["broadcast_not_equal"]
greater = globals()["broadcast_greater"]
lesser = globals()["broadcast_lesser"]


def _as_shape(s):
    return tuple(s) if isinstance(s, (tuple, list)) else (int(s),)


def _sample(op, ctx, out, **attrs):
    return _dispatch.invoke_by_name(op, [], dict(attrs, ctx=ctx), out=out)


def _uniform(low=0.0, high=1.0, shape=(), dtype="float32", ctx=None,
             out=None):
    """Uniform samples on [low, high), drawn on ``ctx`` (default: the
    current context) from that device's generator."""
    return _sample("_random_uniform", ctx, out, low=low, high=high,
                   shape=_as_shape(shape), dtype=dtype)


def _normal(loc=0.0, scale=1.0, shape=(), dtype="float32", ctx=None,
            out=None):
    """Normal samples (mean ``loc``, standard deviation ``scale``)."""
    return _sample("_random_normal", ctx, out, loc=loc, scale=scale,
                   shape=_as_shape(shape), dtype=dtype)


def _randint(low, high, shape=(), dtype="int32", ctx=None, out=None):
    """Integers uniform on [low, high)."""
    return _sample("_random_randint", ctx, out, low=low, high=high,
                   shape=_as_shape(shape), dtype=dtype)


random = _types.SimpleNamespace(uniform=_uniform, normal=_normal,
                                randint=_randint)
contrib = _types.SimpleNamespace(**{
    n[len("_contrib_"):]: globals()[n] for n in _ops.list_ops()
    if n.startswith("_contrib_")})


def save(fname, data):
    """Save an NDArray, a list or a str-keyed dict of NDArrays in the
    reference's binary format (``serialization.py``; a bfloat16 array
    makes the file the npz container the JAX package writes)."""
    from ..serialization import save_ndarray_file
    save_ndarray_file(fname, data)


def load(fname):
    """The list or dict of NDArrays saved in ``fname`` (either
    package's file), on the CPU."""
    from ..serialization import load_ndarray_file
    return load_ndarray_file(fname)


def load_frombuffer(buf):
    """:func:`load` from the bytes of such a file."""
    from ..serialization import load_ndarray_bytes
    return load_ndarray_bytes(buf)


def clip(data, a_min, a_max, out=None):
    """Positional bounds (reference ``nd.clip(data, a_min, a_max)``)."""
    return _dispatch.invoke_by_name("clip", [data],
                                    {"a_min": a_min, "a_max": a_max}, out=out)


__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "moveaxis", "onehot_encode", "waitall", "random",
           "contrib", "clip", "save", "load", "load_frombuffer"]
