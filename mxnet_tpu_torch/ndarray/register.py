"""Generate ``nd.<op>`` functions from the op registry.

Counterpart of ``mxnet_tpu/ndarray/register.py`` (reference
python/mxnet/ndarray/register.py): one function per registered name,
closing over its ``OpDef``.
"""
from __future__ import annotations

from ..ops import registry as _reg
from . import dispatch as _dispatch


def _make_op_func(opdef, name):
    def fn(*args, out=None, name=None, **kwargs):
        return _dispatch.invoke(opdef, args, kwargs, out=out)
    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = opdef.__doc__
    return fn


def populate(namespace):
    """Add ``nd.<op>`` for every registered op name to ``namespace``."""
    for name in _reg.list_ops():
        namespace[name] = _make_op_func(_reg.get_op(name), name)
