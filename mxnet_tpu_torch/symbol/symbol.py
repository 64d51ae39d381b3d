"""Symbol: the declarative graph.

Counterpart of ``mxnet_tpu/symbol/symbol.py``, reduced to what the
serving and training slices use: ``Variable`` (with ``init=``,
``lr_mult`` and ``wd_mult`` stored as the JAX package stores them),
``Group``, composition through the generated op functions, indexing
by position, output name or slice and ``get_internals``, the
arithmetic and comparison operators (scalar operands on either side),
``reshape`` and ``slice_axis``, ``list_arguments``, ``list_outputs``,
``list_auxiliary_states`` (the variables an op mutates, such as
BatchNorm's moving statistics), ``attr_dict``, ``infer_shape``,
``infer_type``, ``infer_shape_type`` and ``simple_bind``.  Types are
torch dtypes here (the JAX package gives numpy dtypes); given types may
be names, numpy or torch dtypes.

``tojson``/``save`` write the reference's symbol.json layout exactly as
the JAX package writes it (the same nodes, the op attributes the caller
passed, never the filled-in defaults, as strings, and the variables'
attributes), so the two packages' files of one model are the same
string; ``load``/``load_json`` read it, the legacy ``param`` and
``attr`` keys included.  Attribute scopes, sharding annotations and
control flow (whose nodes carry subgraphs) come with later slices.
"""
from __future__ import annotations

import inspect
import json

import torch

from ..base import (MXNetError, current_name_manager, numeric_types,
                    torch_dtype)
from ..ops.shape_rules import (INDEX_INPUTS, OUT_SHAPES, PARAM_SHAPES,
                                out_dtypes)

__all__ = ["Symbol", "Variable", "Group", "load", "load_json"]


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "shape", "str_attrs",
                 "given_attrs")

    def __init__(self, op, name, attrs, inputs, shape=None, str_attrs=None,
                 given_attrs=None):
        self.op = op            # OpDef, or None for a variable
        self.name = name
        self.attrs = attrs      # typed op attributes, defaults filled in
        self.inputs = inputs    # [(node, out_idx)]
        self.shape = shape      # a variable's declared shape
        self.str_attrs = str_attrs or {}    # user attributes
        # the op attributes the caller passed, in the order passed
        # (tojson writes only these)
        self.given_attrs = tuple(given_attrs or ())

    def explicit_attrs(self):
        """The op attributes the caller passed, ``{name: value}``, in the
        JAX package's order: those with a default in the op's signature
        order, then the required ones in the order passed."""
        if self.is_var:
            return {}
        given = set(self.given_attrs)
        required = [k for k in self.given_attrs
                    if self.op.attr_defaults.get(k) is inspect.Parameter.empty]
        out = {k: v for k, v in self.attrs.items()
               if k in given and k not in required}
        out.update((k, self.attrs[k]) for k in required)
        return out

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
        """One output by position or by name (``list_outputs``), or a
        slice of them; an unknown name raises ``MXNetError``."""
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("output '%s' not found; outputs=%s"
                                 % (index, names))
            index = names.index(index)
        if isinstance(index, slice):
            return Symbol(self._entries[index])
        return Symbol([self._entries[index]])

    def get_internals(self):
        """Every visible output of every node, variables included, in
        topological order (``relu4_3_output``, ``conv1_weight``, ...):
        index it by name to take an inner layer out of a graph."""
        return Symbol([(node, i) for node in self._topo()
                       for i in range(1 if node.is_var else
                                      node.op.visible_out_count(node.attrs))])

    @property
    def name(self):
        """The node's name for a one-output Symbol, else None."""
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def _set_attr(self, **kwargs):
        """Set user (string) attributes on the head node."""
        self._entries[0][0].str_attrs.update(
            {k: str(v) for k, v in kwargs.items()})

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
            names = node.op.names_for(len(node.inputs))
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

    def _infer_types(self, known):
        """Forward propagation of types (the JAX package's ``_infer``,
        with the ops' type rules in place of ``jax.eval_shape``).
        Variables whose type is not given are provisionally float32 and
        take the type of the first input of their first consumer whose
        type is known and floating (the reference's same-type rule, so
        bf16 data makes the weights it meets bf16); integer inputs never
        anchor, so an Embedding's weight keeps its own type.  An untyped
        variable met first in an op's index input (``INDEX_INPUTS``:
        block tables, positions, offsets, lengths, take's indices) is
        float32 whatever the anchor: bf16 would round its values above
        256, f16 above 2048 (the JAX package lets them take the anchor).
        Returns ``{variable name: dtype}`` and ``{(id(node), idx):
        dtype}``."""
        dtypes = {k: torch_dtype(v) for k, v in known.items()}
        env, pending = {}, set()
        for node in self._topo():
            if node.is_var:
                dt = dtypes.get(node.name)
                if dt is None and "__dtype__" in node.str_attrs:
                    dt = torch_dtype(node.str_attrs["__dtype__"])
                if dt is None:
                    pending.add(id(node))
                env[(id(node), 0)] = dt or torch.float32
                continue
            anchor = next((env[(id(inp), oi)] for inp, oi in node.inputs
                           if not (inp.is_var and id(inp) in pending)
                           and env[(id(inp), oi)].is_floating_point), None)
            index = INDEX_INPUTS.get(node.op.name, ())
            for (inp, _), nm in zip(node.inputs,
                                    node.op.names_for(len(node.inputs))):
                if not (inp.is_var and id(inp) in pending):
                    continue
                if nm in index:
                    env[(id(inp), 0)] = dtypes[inp.name] = torch.float32
                elif anchor is not None:
                    env[(id(inp), 0)] = dtypes[inp.name] = anchor
                else:
                    continue
                pending.discard(id(inp))
            outs = out_dtypes(node.op.name,
                              [env[(id(inp), oi)] for inp, oi in node.inputs],
                              node.attrs, node.op.out_count(node.attrs))
            for i, dt in enumerate(outs):
                env[(id(node), i)] = dt
        for node in self._topo():
            if node.is_var:
                dtypes.setdefault(node.name, env[(id(node), 0)])
        return dtypes, env

    def infer_type(self, *args, **kwargs):
        """``(arg_types, out_types, aux_types)`` from the given input
        types (positional in ``list_arguments`` order, or by name)."""
        known = {n: t for n, t in zip(self.list_arguments(), args)
                 if t is not None}
        known.update(kwargs)
        dtypes, env = self._infer_types(known)
        return ([dtypes[n] for n in self.list_arguments()],
                [env[(id(n), i)] for n, i in self._entries],
                [dtypes[n] for n in self.list_auxiliary_states()])

    def infer_shape_type(self, shape_kwargs, type_kwargs=None):
        """Shapes and types together: ``(arg_shapes, arg_types,
        aux_shapes, aux_types)``."""
        arg_shapes, _, aux_shapes = self.infer_shape(**shape_kwargs)
        dtypes, _ = self._infer_types(type_kwargs or {})
        return (arg_shapes, [dtypes[n] for n in self.list_arguments()],
                aux_shapes, [dtypes[n] for n in self.list_auxiliary_states()])

    def simple_bind(self, ctx=None, grad_req="null", shared_exec=None,
                    type_dict=None, **shapes):
        """Allocate every argument (zeros, in its inferred type: float32
        unless ``type_dict`` or the same-type rule says otherwise) on
        ``ctx`` from the inferred shapes and return an Executor.
        Gradients take their argument's type.  ``grad_req`` is
        ``'write'``, ``'add'`` or ``'null'``, one value for every
        argument or a dict per argument (missing names: ``'null'``).
        With ``shared_exec``, each argument and auxiliary state whose
        name, shape and type match one of that executor's takes its
        NDArray, the same object, and such an argument its gradient
        NDArray: the two executors then hold one copy of the weights,
        their gradients and the paged caches."""
        from ..executor import Executor
        return Executor(self, ctx, grad_req, shapes, shared_exec, type_dict)

    # ------------------------------------------------------------------
    def _binop(self, other, op, scalar_op, reverse=False):
        from . import _invoke_op
        if isinstance(other, Symbol):
            return _invoke_op(op, [other, self] if reverse else [self, other])
        if isinstance(other, numeric_types):
            return _invoke_op(scalar_op, [self],
                              {"scalar": float(other), "reverse": reverse})
        return NotImplemented

    def __add__(self, o): return self._binop(o, "broadcast_add", "_plus_scalar")
    def __radd__(self, o): return self._binop(o, "broadcast_add", "_plus_scalar", True)
    def __sub__(self, o): return self._binop(o, "broadcast_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binop(o, "broadcast_sub", "_minus_scalar", True)
    def __mul__(self, o): return self._binop(o, "broadcast_mul", "_mul_scalar")
    def __rmul__(self, o): return self._binop(o, "broadcast_mul", "_mul_scalar", True)
    def __truediv__(self, o): return self._binop(o, "broadcast_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binop(o, "broadcast_div", "_div_scalar", True)
    def __pow__(self, o): return self._binop(o, "broadcast_power", "_power_scalar")
    def __neg__(self): return self._binop(-1.0, None, "_mul_scalar")
    def __gt__(self, o): return self._binop(o, "broadcast_greater", "_greater_scalar")
    def __ge__(self, o): return self._binop(o, "broadcast_greater_equal", "_greater_equal_scalar")
    def __lt__(self, o): return self._binop(o, "broadcast_lesser", "_lesser_scalar")
    def __le__(self, o): return self._binop(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    def __eq__(self, o):
        """Elementwise equality as a graph node (reference Symbol)."""
        return self._binop(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")

    __hash__ = object.__hash__

    # ------------------------------------------------------------------
    def tojson(self):
        """The reference's symbol.json, the JAX package's string."""
        nodes = self._topo()
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes, arg_nodes = [], []
        for i, n in enumerate(nodes):
            if n.is_var:
                arg_nodes.append(i)
            attrs = {k: _attr_to_str(v)
                     for k, v in n.explicit_attrs().items()}
            attrs.update(n.str_attrs)
            jn = {"op": "null" if n.is_var else n.op.name, "name": n.name,
                  "inputs": [[nid[id(inp)], oi, 0] for inp, oi in n.inputs]}
            if attrs:
                jn["attrs"] = attrs
            jnodes.append(jn)
        heads = [[nid[id(n)], oi, 0] for n, oi in self._entries]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "heads": heads,
                           "attrs": {"mxnet_version": ["str",
                                                       "tpu-native-0.1"]}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def reshape(self, shape):
        from . import _invoke_op
        return _invoke_op("Reshape", [self], {"shape": tuple(shape)})

    def slice_axis(self, axis, begin, end):
        from . import _invoke_op
        return _invoke_op("slice_axis", [self],
                          {"axis": axis, "begin": begin, "end": end})


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


def _make_node(opdef, name, attrs, inputs, given=None, named=False):
    """A node of ``opdef``; ``name`` is given to the current name manager
    unless ``named`` (a name it gave already: a ``Prefix`` would prefix
    it twice)."""
    given = list(attrs) if given is None else given
    attrs = opdef.normalize_attrs(attrs)
    nm = name if named else current_name_manager().get(
        name, opdef.name.replace("_", ""))
    node = _Node(opdef, nm, attrs, inputs, given_attrs=given)
    vis = opdef.visible_out_count(attrs)
    return Symbol([(node, i) for i in range(vis)])


def _entry_of(s):
    if not isinstance(s, Symbol) or len(s._entries) != 1:
        raise MXNetError("an op input must be a single-output Symbol; "
                         "index a multi-output Symbol first")
    return s._entries[0]


def _attr_to_str(v):
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, (tuple, list)):
        return "(" + ", ".join(str(x) for x in v) + ")"
    if v is None:
        return "None"
    return str(v)


def _parse_attr_string(v):
    """An attribute string of symbol.json as a value: 'True', '(2, 2)',
    '1e-3', 'relu'."""
    s = v.strip()
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low == "none":
        return None
    if s.startswith("(") or s.startswith("["):
        inner = s[1:-1].strip()
        if not inner:
            return ()
        return tuple(_parse_attr_string(t) for t in inner.split(",")
                     if t.strip())
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return v


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    """A Symbol from symbol.json, the legacy layouts the reference
    upgrades included (src/nnvm/legacy_json_util.cc): op parameters
    under ``param`` (before 0.9), user attributes under ``attr``
    (0.9-1.1) and the merged ``attrs`` (1.2 on)."""
    from ..ops import registry as _reg
    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        attrs = dict(jn.get("param", {}) or {})
        attrs.update(jn.get("attr", {}) or {})
        attrs.update(jn.get("attrs", {}) or {})
        inputs = [(nodes[i], oi) for i, oi, *_ in jn["inputs"]]
        if jn["op"] == "null":
            shape = attrs.get("__shape__")
            nodes.append(_Node(None, jn["name"], {}, [],
                               _parse_attr_string(shape) if shape else None,
                               attrs))
            continue
        if jn.get("subgraphs"):
            raise MXNetError("load_json: node %s (%s) holds subgraphs: "
                             "control flow comes with a later slice of the "
                             "PyTorch port (ROADMAP A.6)"
                             % (jn["name"], jn["op"]))
        opdef = _reg.get_op(jn["op"])
        given = [k for k in attrs if k in opdef.attr_defaults]
        typed = opdef.normalize_attrs(
            {k: _parse_attr_string(attrs[k]) if isinstance(attrs[k], str)
             else attrs[k] for k in given})
        user = {k: v for k, v in attrs.items()
                if k not in opdef.attr_defaults}
        nodes.append(_Node(opdef, jn["name"], typed, inputs, None, user,
                           given_attrs=given))
    return Symbol([(nodes[h[0]], h[1]) for h in data["heads"]])
