"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``.  Each operator is one
function on torch tensors; its signature declares the interface:
positional-or-keyword parameters are tensor inputs (``=None`` marks one
optional), keyword-only parameters are attributes, except ``is_train``:
an op that declares it is handed the executor's train flag (the JAX
package's ``current_op_context().is_train``).  ``mutate_inputs`` names
the inputs an op updates, each with the output that carries its new
value (BatchNorm's moving statistics, the reference's FMutateInputs):
the symbol lists those variables as auxiliary states and the executor
writes the outputs back into them after a train forward.
``unused_inputs(attrs)`` names the inputs an op does not take under
those attributes (``_FusedBNReluConv``'s residual without
``with_residual``): the symbol functions leave them out where they
would otherwise create a variable, and create every other missing
input, optional ones included.  Shape inference uses the explicit rules
in ``shape_rules.py`` (the JAX package traced the function with
``jax.eval_shape`` instead).
"""
from __future__ import annotations

import inspect

from ..base import MXNetError

__all__ = ["OpDef", "register", "get_op", "list_ops"]

_OP_REGISTRY: dict = {}


class OpDef:
    """One registered operator."""

    def __init__(self, name, fn, num_outputs=1, num_visible_outputs=None,
                 mutate_inputs=(), unused_inputs=None):
        self.name = name
        self.fn = fn
        self._num_outputs = num_outputs
        self._num_visible = num_visible_outputs
        self.mutate_inputs = tuple(mutate_inputs)
        self.unused_inputs = unused_inputs
        sig = inspect.signature(fn)
        self.input_names = [p.name for p in sig.parameters.values()
                            if p.kind is p.POSITIONAL_OR_KEYWORD]
        self.optional_inputs = {
            p.name for p in sig.parameters.values()
            if p.kind is p.POSITIONAL_OR_KEYWORD and p.default is None}
        self.attr_defaults = {p.name: p.default
                              for p in sig.parameters.values()
                              if p.kind is p.KEYWORD_ONLY}
        self.takes_is_train = "is_train" in self.attr_defaults
        self.attr_defaults.pop("is_train", None)
        self.__doc__ = fn.__doc__

    def out_count(self, attrs):
        n = self._num_outputs
        return n(attrs) if callable(n) else n

    def visible_out_count(self, attrs):
        n = self._num_visible
        if n is None:
            return self.out_count(attrs)
        return n(attrs) if callable(n) else n

    def normalize_attrs(self, attrs):
        """Fill defaults; raise on an unknown or missing attribute."""
        unknown = set(attrs) - set(self.attr_defaults)
        if unknown:
            raise MXNetError("%s: unknown attribute(s) %s"
                             % (self.name, sorted(unknown)))
        out = dict(self.attr_defaults)
        out.update(attrs)
        missing = [k for k, v in out.items() if v is inspect.Parameter.empty]
        if missing:
            raise MXNetError("%s: required attribute(s) %s not given"
                             % (self.name, missing))
        return out


def register(name, aliases=(), num_outputs=1, num_visible_outputs=None,
             mutate_inputs=(), unused_inputs=None):
    """Decorator: register ``fn`` under ``name`` (and ``aliases``)."""
    def deco(fn):
        op = OpDef(name, fn, num_outputs, num_visible_outputs, mutate_inputs,
                   unused_inputs)
        for n in (name,) + tuple(aliases):
            if n in _OP_REGISTRY:
                raise MXNetError("operator %s registered twice" % n)
            _OP_REGISTRY[n] = op
        return fn
    return deco


def get_op(name):
    try:
        return _OP_REGISTRY[name]
    except KeyError:
        raise MXNetError("operator %s is not in the PyTorch port yet"
                         % name) from None


def list_ops():
    return sorted(_OP_REGISTRY)
