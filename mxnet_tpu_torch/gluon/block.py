"""Block and HybridBlock.

Counterpart of ``mxnet_tpu/gluon/block.py`` (reference
python/mxnet/gluon/block.py).  Blocks name their parameters as the JAX
package's do (``resnetv20_stage1_conv2d0_weight``: a top-level block
takes its prefix from the name manager, children count per parent
scope), so one numpy weight set carries between the packages by name
(``weights.gluon_params_from_numpy``).

A HybridBlock runs eagerly (``hybrid_forward`` with ``F`` = ``mx.nd``)
until ``hybridize()``.  Hybridized, its first call per input signature
traces ``hybrid_forward`` with ``F`` = ``mx.sym`` (children traced the
same way) into one graph, and every call runs that graph through the
executor's walk (``executor.run_graph``: each intermediate dropped
after its last reader) with the parameters' tensors as the leaves,
under ``torch.set_grad_enabled(autograd.is_recording())``, so autograd
records it as it records the eager path.  A graph run with a float16
input or parameter takes ``simple_bind``'s check
(``executor.check_float16_graph``): an op outside
``executor.FLOAT16_OPS`` raises before the walk.  PyTorch has no compiler to
hand the graph to: the gain over the eager path is one walk instead of
one Python dispatch per op and per block.  In a train-mode call
(``autograd.is_training()``) BatchNorm's new moving statistics are
written into its running_mean/running_var parameters in both paths.

``save_parameters``/``load_parameters`` write and read the reference's
NDArray file keyed by the blocks' structural names
(``features.0.weight``), ``HybridBlock.export`` writes
``path-symbol.json`` and ``path-%04d.params`` (``arg:``/``aux:`` keys),
and ``SymbolBlock`` (``SymbolBlock.imports``) runs such a symbol with
its parameters through the same walk: the JAX package's files in both
directions.
"""
from __future__ import annotations

import re
import threading

import torch

from .. import autograd
from .. import random as _random
from ..base import MXNetError, NameManager, current_name_manager
from ..executor import GraphPlan, check_float16_graph, run_graph
from ..ndarray.ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope:
    """Name scope of a Block (reference block.py _BlockScope): children
    created inside ``with block.name_scope():`` count per parent."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = current_name_manager().get(None, hint) + "_"
            params = ParameterDict(prefix) if params is None \
                else ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = "%s%d_" % (hint, count)
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class Block:
    """Base building block (reference gluon/block.py Block)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}
        self._forward_hooks = []
        self._forward_pre_hooks = []

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        if not self._children:
            return "%s()" % self.__class__.__name__
        body = "\n".join("  (%s): %s" % (key, str(block).replace(
            "\n", "\n  ")) for key, block in self._children.items())
        return "%s(\n%s\n)" % (self.__class__.__name__, body)

    def __setattr__(self, name, value):
        existing = self.__dict__.get(name)
        if isinstance(existing, (Parameter, Block)) \
                and not isinstance(value, type(existing)):
            raise TypeError("Changing attribute type for %s from %s to %s "
                            "is not allowed." % (name, type(existing),
                                                 type(value)))
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            if self._reg_params.get(name, value) is not value:
                raise MXNetError("Overriding Parameter attribute %s is not "
                                 "allowed." % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """Every Parameter of this block and its children, optionally
        those whose name matches the regular expression ``select``."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({n: p for n, p in self.params.items()
                        if pattern.match(n)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def register_child(self, block, name=None):
        self._children[name if name is not None
                       else str(len(self._children))] = block

    def register_forward_hook(self, hook):
        self._forward_hooks.append(hook)
        return hook

    def register_forward_pre_hook(self, hook):
        self._forward_pre_hooks.append(hook)
        return hook

    def apply(self, fn):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the current
        context, the card unless the caller asks for the CPU) with
        ``init`` (default ``Uniform()``) where a parameter has no
        initializer of its own."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for param in self._reg_params.values():
            param.cast(dtype)

    def _collect_params_with_prefix(self, prefix=""):
        """``{structural name: Parameter}``: attribute names joined by
        dots down the children (``features.0.weight``)."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Save the parameters by structural name in the reference's
        NDArray file."""
        from ..serialization import save_ndarray_file
        params = self._collect_params_with_prefix()
        save_ndarray_file(filename, {k: v.data() for k, v in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a :meth:`save_parameters` file (either package's) into
        the parameters of the same structural names; one not yet created
        takes the file's shape, on ``ctx``."""
        from ..serialization import load_ndarray_file
        loaded = load_ndarray_file(filename)
        params = self._collect_params_with_prefix()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError("Parameter '%s' missing in '%s'"
                                     % (name, filename))
        for name, v in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise MXNetError("Parameter '%s' from '%s' not found in "
                                     "Block" % (name, filename))
                continue
            params[name]._load(v, ctx)

    save_params = save_parameters
    load_params = load_parameters

    def __call__(self, *args):
        for hook in self._forward_pre_hooks:
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError


class _CachedGraph:
    """One traced graph of a hybridized block: the walk's plan, the
    input variables' names, the parameters it reads and the block's name
    (errors name it); ``f16_checked`` once a float16 run has passed
    ``executor.check_float16_graph``."""

    def __init__(self, plan, input_names, params, name):
        self.plan = plan
        self.input_names = input_names
        self.params = params
        self.name = name
        self.f16_checked = False


class HybridBlock(Block):
    """A Block whose ``hybrid_forward(F, x, ...)`` runs on NDArrays
    (``F`` = ``mx.nd``) or traces on Symbols (``F`` = ``mx.sym``)
    (reference gluon/block.py HybridBlock)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached = {}

    def hybridize(self, active=True, **kwargs):
        """Run through one traced graph per input signature from the
        next call on (``static_alloc`` and the other flags are accepted
        and have nothing to configure here)."""
        self._active = active
        self._cached = {}
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._cached = {}
        super().cast(dtype)

    def _infer_param_shapes(self, *args):
        """Complete the unknown (0) dimensions of this block's own
        parameters from the forward's inputs (layers override it)."""

    def forward(self, *args):
        from ..symbol import Symbol
        if args and isinstance(args[0], Symbol):
            return self._symbolic_forward(*args)
        if self._active and all(p._data is not None for p in
                                self.collect_params().values()):
            return self._call_cached(*args)
        return self._eager_forward(*args)

    def _eager_forward(self, *args):
        """``hybrid_forward`` on NDArrays; a deferred parameter takes its
        shape from the inputs here (the reference's deferred shape
        inference)."""
        from .. import ndarray as F
        try:
            params = {k: p.data() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._infer_param_shapes(*args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            params = {k: p.data() for k, p in self._reg_params.items()}
        return self.hybrid_forward(F, *args, **params)

    def _symbolic_forward(self, *args):
        from .. import symbol as F
        params = {k: p.var() for k, p in self._reg_params.items()}
        return self.hybrid_forward(F, *args, **params)

    def _build_cache(self, args):
        """Trace ``hybrid_forward`` on Symbols into a graph (its op names
        from a fresh name scope, so tracing takes no names from the
        blocks built after it)."""
        from .. import symbol
        names = ["data"] + ["data%d" % i for i in range(1, len(args))]
        with NameManager():
            out = self._symbolic_forward(*[symbol.Variable(n)
                                           for n in names])
        if isinstance(out, (list, tuple)):
            out = symbol.Group(list(out))
        params = {p.name: p for p in self.collect_params().values()}
        plan = GraphPlan(out)
        stray = {n.name for n in plan.nodes if n.is_var} - set(names) \
            - set(params)
        if stray:
            raise MXNetError("%s: hybrid_forward created variable(s) %s "
                             "that are neither inputs nor parameters"
                             % (self.name, sorted(stray)))
        return _CachedGraph(plan, names, params, self.name)

    def _call_cached(self, *args):
        for a in args:
            if not isinstance(a, NDArray):
                raise MXNetError("%s: a hybridized block takes NDArray "
                                 "inputs, got %s" % (self.name, type(a)))
        key = tuple((a.shape, a.dtype) for a in args)
        cached = self._cached.get(key)
        if cached is None:
            cached = self._cached[key] = self._build_cache(args)
        return _run_cached(cached, args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` (``hybrid_forward`` traced on one
        input named ``data``) and ``path-%04d.params`` (``arg:`` for
        parameters with a gradient, ``aux:`` for the others), the files
        ``SymbolBlock.imports`` and ``Module.load`` read.  Returns the
        symbol."""
        from .. import symbol
        from ..serialization import save_ndarray_file
        with NameManager():
            out = self._symbolic_forward(symbol.Variable("data"))
        if isinstance(out, (list, tuple)):
            out = symbol.Group(list(out))
        out.save("%s-symbol.json" % path)
        arrs = {}
        for p in self.collect_params().values():
            arrs[("aux:" if p.grad_req == "null" else "arg:") + p.name] = \
                p.data()
        save_ndarray_file("%s-%04d.params" % (path, epoch), arrs)
        return out


def _run_cached(cached, args):
    """Run a traced graph on NDArray ``args`` with its parameters'
    tensors as the leaves (recorded when autograd records); a train-mode
    call writes the new moving statistics into their parameters."""
    is_train = autograd.is_training()
    values = {n: p._data._data for n, p in cached.params.items()}
    values.update(zip(cached.input_names, (a._data for a in args)))
    if not cached.f16_checked and any(t.dtype == torch.float16
                                      for t in values.values()):
        check_float16_graph(cached.plan.nodes, (torch.float16,),
                            "hybridized %s" % cached.name)
        cached.f16_checked = True
    rng = None
    if cached.plan.draws:
        dev = next(iter(values.values())).device
        rng = _random.StepRandom(_random.next_seed(dev))
    with torch.set_grad_enabled(autograd.is_recording()):
        heads, new_aux = run_graph(cached.plan, values, is_train, rng)
    with torch.no_grad():
        for name, t in new_aux.items():
            cached.params[name]._data._data.copy_(t)
    outs = [NDArray(t) for t in heads]
    return outs[0] if len(outs) == 1 else outs


class SymbolBlock(HybridBlock):
    """A Block over a Symbol and its parameters (reference block.py
    SymbolBlock): ``inputs`` are the graph's input variables, every other
    argument and auxiliary state is a Parameter (taken from ``params``
    where it holds the name; auxiliary states get ``grad_req='null'``),
    created with the shape of the first input's forward when not yet
    initialized.  The forward runs the graph through the executor's
    walk, as a hybridized block does."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=None)
        from ..symbol import Group, Symbol
        if isinstance(outputs, (list, tuple)):
            outputs = Group(list(outputs))
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        self._symbol = outputs
        self._input_names = [i.list_outputs()[0] for i in inputs]
        aux_names = set(outputs.list_auxiliary_states())
        existing = dict(params.items()) if params is not None else {}
        attrs = outputs.attr_dict()
        for name in outputs.list_arguments() + sorted(aux_names):
            if name in self._input_names:
                continue
            if name in existing:
                self._params._params[name] = existing[name]
                continue
            a = attrs.get(name, {})
            self._params._params[name] = Parameter(
                name, allow_deferred_init=True,
                grad_req="null" if name in aux_names else "write",
                lr_mult=float(a.get("__lr_mult__", 1.0)),
                wd_mult=float(a.get("__wd_mult__", 1.0)))
        self._graph = None

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock over ``symbol_file`` (``export``'s or the JAX
        package's) with the parameters of ``param_file`` on ``ctx``."""
        from ..serialization import load_ndarray_file
        from ..symbol import Variable, load
        sym = load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        block = SymbolBlock(sym, [Variable(n) for n in input_names])
        if param_file is not None:
            params = block._params._params
            for k, v in load_ndarray_file(param_file).items():
                name = k.split(":", 1)[-1]
                if name in params:
                    params[name].dtype = v.dtype
                    params[name]._load(v, ctx)
        return block

    def forward(self, *args):
        from ..symbol import Symbol
        if args and isinstance(args[0], Symbol):
            # the JAX package cannot either: its SymbolBlock.forward reads
            # a Symbol's shape, and a hybridized block holding one has no
            # hybrid_forward to trace (mxnet_tpu/gluon/block.py:443-470,
            # :578-600); the port raises where it fails
            raise MXNetError("SymbolBlock cannot be composed into another "
                             "symbol: it runs on NDArrays only, as in the "
                             "JAX package, where calling it on a Symbol, "
                             "hybridizing a block that holds it or "
                             "exporting such a block fails too")
        params = dict(self._params.items())
        if any(p._data is None for p in params.values()):
            shapes, _, aux_shapes = self._symbol.infer_shape(
                **{n: a.shape for n, a in zip(self._input_names, args)})
            known = dict(zip(self._symbol.list_arguments(), shapes))
            known.update(zip(self._symbol.list_auxiliary_states(),
                             aux_shapes))
            for name, p in params.items():
                if p._data is None:
                    p.shape = tuple(known[name])
                    p._finish_deferred_init()
        if self._graph is None:
            self._graph = _CachedGraph(GraphPlan(self._symbol),
                                       self._input_names, params, self.name)
        return _run_cached(self._graph, args)
