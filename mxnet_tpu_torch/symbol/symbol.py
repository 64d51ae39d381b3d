"""Symbol: the declarative graph.

Counterpart of ``mxnet_tpu/symbol/symbol.py``, reduced to what the
serving and training slices use: ``Variable`` (with ``init=``,
``lr_mult`` and ``wd_mult`` stored as the JAX package stores them),
``Group``, composition through the generated op functions and
``+``/``-``, ``list_arguments``, ``list_outputs``,
``list_auxiliary_states`` (the variables an op mutates, such as
BatchNorm's moving statistics), ``attr_dict``, ``infer_shape`` and
``simple_bind``.  JSON serialization, attribute scopes, sharding
annotations and control flow come with later slices.
"""
from __future__ import annotations

from ..base import NAMES, MXNetError, numeric_types
from ..ops.shape_rules import OUT_SHAPES, PARAM_SHAPES

__all__ = ["Symbol", "Variable", "Group"]


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "shape", "str_attrs")

    def __init__(self, op, name, attrs, inputs, shape=None, str_attrs=None):
        self.op = op            # OpDef, or None for a variable
        self.name = name
        self.attrs = attrs      # typed op attributes
        self.inputs = inputs    # [(node, out_idx)]
        self.shape = shape      # a variable's declared shape
        self.str_attrs = str_attrs or {}    # a variable's user attributes

    def output_name(self, idx):
        """The reference's output naming: a variable's own name,
        ``{name}_output`` for one visible output, else
        ``{name}_output{idx}``."""
        if self.is_var:
            return self.name
        if self.op.visible_out_count(self.attrs) == 1:
            return self.name + "_output"
        return "%s_output%d" % (self.name, idx)

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

    def _aux_names_set(self):
        """Names of the variables fed to an op input it mutates
        (``OpDef.mutate_inputs``)."""
        aux = set()
        for node in self._topo():
            if node.is_var or not node.op.mutate_inputs:
                continue
            mut = {nm for nm, _ in node.op.mutate_inputs}
            for (inp, _), nm in zip(node.inputs, node.op.input_names):
                if nm in mut and inp.is_var:
                    aux.add(inp.name)
        return aux

    def _variables(self, aux):
        """Variable names in topological order: the auxiliary states
        when ``aux``, else the arguments."""
        names = self._aux_names_set()
        out, seen = [], set()
        for node in self._topo():
            if node.is_var and (node.name in names) == aux \
                    and node.name not in seen:
                seen.add(node.name)
                out.append(node.name)
        return out

    def list_arguments(self):
        return self._variables(aux=False)

    def list_outputs(self):
        return [node.output_name(idx) for node, idx in self._entries]

    def list_auxiliary_states(self):
        return self._variables(aux=True)

    def attr_dict(self):
        """``{variable name: {attribute: string}}`` for every variable
        carrying user attributes (``__init__``, ``__shape__``,
        ``__lr_mult__``, ``__wd_mult__``, ...), the entries the JAX
        package's ``attr_dict`` gives for variables.  Op parameters are
        not listed: the port keeps them typed."""
        out = {}
        for node in self._topo():
            if node.is_var and node.str_attrs:
                out.setdefault(node.name, {}).update(node.str_attrs)
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
        auxs = self.list_auxiliary_states()
        missing = [n for n in args + auxs if shapes.get(n) is None]
        if missing:
            raise MXNetError("infer_shape: cannot determine shapes of %s"
                             % missing)
        return ([shapes[n] for n in args],
                [env[(id(n), i)] for n, i in self._entries],
                [shapes[n] for n in auxs])

    def simple_bind(self, ctx=None, grad_req="null", **shapes):
        """Allocate every argument (float32, zeros) on ``ctx`` from the
        inferred shapes and return an Executor.  ``grad_req`` is
        ``'write'``, ``'add'`` or ``'null'``, one value for every
        argument or a dict per argument (missing names: ``'null'``)."""
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


# sharding annotations: tensor parallelism comes with the multi-GPU slice
_SHARDING_ATTRS = ("__sharding__",)


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             init=None, **kwargs):
    """A graph input.  ``shape`` declares its shape (the cache and
    position variables carry theirs); ``init`` (an Initializer or its
    ``dumps()`` string), ``lr_mult`` and ``wd_mult`` are stored as the
    string attributes ``__init__``, ``__lr_mult__`` and ``__wd_mult__``,
    as the JAX package stores them.  Other attributes must be dunder
    names; a sharding annotation raises (multi-GPU slice)."""
    if not isinstance(name, str):
        raise TypeError("Variable name must be a string")
    str_attrs = {k: str(v) for k, v in (attr or {}).items()}
    for key in ("lr_mult", "wd_mult"):       # mirrored as in the JAX package
        if key in str_attrs:
            str_attrs.setdefault("__%s__" % key, str_attrs[key])
    bad = [k for k in kwargs if not (k.startswith("__") and k.endswith("__"))]
    if bad:
        raise MXNetError("Variable attribute(s) %s are not supported; "
                         "additional attributes must be __dunder__ names"
                         % sorted(bad))
    str_attrs.update({k: str(v) for k, v in kwargs.items()})
    tp = [k for k in str_attrs if k in _SHARDING_ATTRS]
    if tp:
        raise MXNetError("Variable %s: sharding annotation(s) %s come with "
                         "the multi-GPU slice of the PyTorch port"
                         % (name, tp))
    if shape is not None:
        str_attrs["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        str_attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        str_attrs["__wd_mult__"] = str(wd_mult)
    if init is not None:
        str_attrs["__init__"] = init if isinstance(init, str) \
            else init.dumps()
    return Symbol([(_Node(None, name, {}, [],
                          tuple(shape) if shape is not None else None,
                          str_attrs), 0)])


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
