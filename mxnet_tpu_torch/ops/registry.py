"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``.  Each operator is one
function on torch tensors; its signature declares the interface:
positional-or-keyword parameters are tensor inputs (``=None`` marks one
optional), keyword-only parameters are attributes, except ``is_train``:
an op that declares it is handed the executor's train flag (the JAX
package's ``current_op_context().is_train``), and ``rng``: an op that
declares it draws random numbers and is handed the walk's
``random.StepRandom`` (the JAX package's ``next_rng_key()``), or None
when called alone; ``draws(attrs)``, when given, says whether it draws
under those attributes (LeakyReLU only as ``rrelu``), so a graph
without such a node takes no step seed.  ``mutate_inputs`` names
the inputs an op updates, each with the output that carries its new
value (BatchNorm's moving statistics, the reference's FMutateInputs):
the symbol lists those variables as auxiliary states and the executor
writes the outputs back into them after a train forward.
``unused_inputs(attrs)`` names the inputs an op does not take under
those attributes (``_FusedBNReluConv``'s residual without
``with_residual``): the symbol functions leave them out where they
would otherwise create a variable, and create every other missing
input, optional ones included.  An op whose signature takes ``*args``
(``Concat``) takes any number of inputs, named ``arg0``, ``arg1``, ...
in shape inference, with ``num_args`` set to their count.  Shape inference uses the explicit rules
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
                 mutate_inputs=(), unused_inputs=None, draws=None):
        self.name = name
        self.fn = fn
        self._num_outputs = num_outputs
        self._num_visible = num_visible_outputs
        self.mutate_inputs = tuple(mutate_inputs)
        self.unused_inputs = unused_inputs
        self._draws = draws
        sig = inspect.signature(fn)
        self.input_names = [p.name for p in sig.parameters.values()
                            if p.kind is p.POSITIONAL_OR_KEYWORD]
        self.var_inputs = any(p.kind is p.VAR_POSITIONAL
                              for p in sig.parameters.values())
        self.optional_inputs = {
            p.name for p in sig.parameters.values()
            if p.kind is p.POSITIONAL_OR_KEYWORD and p.default is None}
        self.attr_defaults = {p.name: p.default
                              for p in sig.parameters.values()
                              if p.kind is p.KEYWORD_ONLY}
        self.takes_is_train = "is_train" in self.attr_defaults
        self.takes_rng = "rng" in self.attr_defaults
        self.attr_defaults.pop("is_train", None)
        self.attr_defaults.pop("rng", None)
        self.__doc__ = fn.__doc__

    def draws(self, attrs):
        """Whether a node with ``attrs`` draws random numbers (it is then
        handed the walk's ``random.StepRandom``)."""
        return self.takes_rng and (self._draws is None
                                   or bool(self._draws(attrs)))

    def names_for(self, n_inputs):
        """The names of a node's ``n_inputs`` inputs."""
        if self.var_inputs:
            return ["arg%d" % i for i in range(n_inputs)]
        return self.input_names

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
             mutate_inputs=(), unused_inputs=None, draws=None):
    """Decorator: register ``fn`` under ``name`` (and ``aliases``)."""
    def deco(fn):
        op = OpDef(name, fn, num_outputs, num_visible_outputs, mutate_inputs,
                   unused_inputs, draws)
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
        raise MXNetError("operator %s is not in the PyTorch port yet "
                         "(ROADMAP A.6, missing op names)" % name) from None


def list_ops():
    return sorted(_OP_REGISTRY)
