"""Symbol: the declarative graph.

Counterpart of ``mxnet_tpu/symbol/symbol.py``, reduced to what the
serving slice uses: ``Variable``, ``Group``, composition through the
generated op functions and ``+``/``-``, ``list_arguments``,
``infer_shape`` and ``simple_bind``.  JSON serialization, attribute
scopes and control flow come with later slices.
"""
from __future__ import annotations

from ..base import NAMES, MXNetError, numeric_types
from ..ops.shape_rules import OUT_SHAPES, PARAM_SHAPES

__all__ = ["Symbol", "Variable", "Group"]


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "shape")

    def __init__(self, op, name, attrs, inputs, shape=None):
        self.op = op            # OpDef, or None for a variable
        self.name = name
        self.attrs = attrs      # typed op attributes
        self.inputs = inputs    # [(node, out_idx)]
        self.shape = shape      # a variable's declared shape

    @property
    def is_var(self):
        return self.op is None


class Symbol:
    """A list of graph entries ``(node, output index)``."""

    def __init__(self, entries):
        self._entries = list(entries)

    def _topo(self):
        """Post-order DFS (the reference's argument order)."""
        seen, order = set(), []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for inp, _ in node.inputs:
                visit(inp)
            order.append(node)

        for node, _ in self._entries:
            visit(node)
        return order

    def list_arguments(self):
        out, seen = [], set()
        for node in self._topo():
            if node.is_var and node.name not in seen:
                seen.add(node.name)
                out.append(node.name)
        return out

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, index):
        return Symbol([self._entries[index]])

    # ------------------------------------------------------------------
    def infer_shape(self, **known):
        """Propagate shapes from the given input shapes (and variables'
        declared shapes), filling parameter shapes by the ops' rules.
        Returns ``(arg_shapes, out_shapes, aux_shapes)``; raises when an
        argument's shape stays unknown."""
        shapes = {k: tuple(v) for k, v in known.items()}
        env = {}
        for node in self._topo():
            if node.is_var:
                shp = shapes.get(node.name, node.shape)
                if shp is not None:
                    shapes[node.name] = tuple(shp)
                env[(id(node), 0)] = shapes.get(node.name)
                continue
            names = node.op.input_names
            ins = {nm: env[(id(inp), oi)]
                   for (inp, oi), nm in zip(node.inputs, names)}
            if any(s is None for s in ins.values()):
                rule = PARAM_SHAPES.get(node.op.name)
                filled = rule(ins, node.attrs) if rule else {}
                for (inp, oi), nm in zip(node.inputs, names):
                    if ins[nm] is None and nm in filled and inp.is_var:
                        ins[nm] = env[(id(inp), 0)] = shapes[inp.name] = \
                            tuple(filled[nm])
            if any(s is None for s in ins.values()):
                missing = [nm for nm, s in ins.items() if s is None]
                raise MXNetError("infer_shape: cannot determine %s of %s(%s)"
                                 % (missing, node.op.name, node.name))
            outs = OUT_SHAPES[node.op.name](ins, node.attrs)
            for i, s in enumerate(outs):
                env[(id(node), i)] = tuple(s)
        args = self.list_arguments()
        missing = [n for n in args if shapes.get(n) is None]
        if missing:
            raise MXNetError("infer_shape: cannot determine shapes of %s"
                             % missing)
        return ([shapes[n] for n in args],
                [env[(id(n), i)] for n, i in self._entries], [])

    def simple_bind(self, ctx=None, grad_req="null", **shapes):
        """Allocate every argument (float32, zeros) on ``ctx`` from the
        inferred shapes and return an inference Executor."""
        from ..executor import Executor
        return Executor(self, ctx, grad_req, shapes)

    # ------------------------------------------------------------------
    def _binop(self, other, op, scalar_op):
        from . import _invoke_op
        if isinstance(other, Symbol):
            return _invoke_op(op, [self, other])
        if isinstance(other, numeric_types):
            return _invoke_op(scalar_op, [self], {"scalar": float(other)})
        return NotImplemented

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")


def Variable(name, shape=None, **kwargs):
    """A graph input.  ``shape`` declares its shape (the cache
    variables carry theirs); other keyword attributes of the JAX
    package (init, sharding annotations) belong to later slices."""
    if not isinstance(name, str):
        raise TypeError("Variable name must be a string")
    if kwargs:
        raise MXNetError("Variable attribute(s) %s are not in the PyTorch "
                         "port yet" % sorted(kwargs))
    return Symbol([(_Node(None, name, {}, [],
                          tuple(shape) if shape is not None else None), 0)])


def Group(symbols):
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def _make_node(opdef, name, attrs, inputs):
    attrs = opdef.normalize_attrs(attrs)
    node = _Node(opdef, NAMES.get(name, opdef.name.replace("_", "")),
                 attrs, inputs)
    vis = opdef.visible_out_count(attrs)
    return Symbol([(node, i) for i in range(vis)])


def _entry_of(s):
    if not isinstance(s, Symbol) or len(s._entries) != 1:
        raise MXNetError("an op input must be a single-output Symbol; "
                         "index a multi-output Symbol first")
    return s._entries[0]
