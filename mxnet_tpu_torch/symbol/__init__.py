"""Symbol package: the declarative graph API (``mx.sym.*``).

Counterpart of ``mxnet_tpu/symbol``: one generated function per
registered operator composes Symbols, auto-creating missing parameter
variables named ``{node}_{input}`` as the reference does.  Operators
named ``_contrib_X`` are also reachable as ``sym.contrib.X``.
"""
from __future__ import annotations

import types

from ..base import NAMES
from ..ops import registry as _reg
from .symbol import Group, Symbol, Variable, _entry_of, _make_node

__all__ = ["Symbol", "Variable", "Group", "contrib"]


def _invoke_op(opname, sym_inputs, attrs=None, name=None):
    return _make_node(_reg.get_op(opname), name, dict(attrs or {}),
                      [_entry_of(s) for s in sym_inputs])


def _make_sym_func(opdef, fname):
    def fn(*args, name=None, **kwargs):
        kw_inputs = {k: kwargs.pop(k) for k in list(kwargs)
                     if k in opdef.input_names}
        nm = NAMES.get(name, opdef.name.lower().replace("_", ""))
        unused = opdef.unused_inputs(kwargs) if opdef.unused_inputs \
            else None
        inputs = []
        for i, in_name in enumerate(opdef.input_names):
            if i < len(args):
                s = args[i]
            elif in_name in kw_inputs:
                s = kw_inputs[in_name]
            elif in_name in unused if unused is not None else (
                    in_name in opdef.optional_inputs and not (
                        in_name == "bias" and not kwargs.get("no_bias"))):
                continue          # optional inputs are trailing ones
            else:
                s = Variable("%s_%s" % (nm, in_name))
            inputs.append(_entry_of(s))
        return _make_node(opdef, nm, kwargs, inputs)

    fn.__name__ = fn.__qualname__ = fname
    fn.__doc__ = opdef.__doc__
    return fn


contrib = types.SimpleNamespace()
for _name in _reg.list_ops():
    _fn = _make_sym_func(_reg.get_op(_name), _name)
    globals()[_name] = _fn
    if _name.startswith("_contrib_"):
        setattr(contrib, _name[len("_contrib_"):], _fn)
