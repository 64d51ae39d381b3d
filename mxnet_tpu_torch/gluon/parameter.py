"""Parameter, Constant and ParameterDict.

Counterpart of ``mxnet_tpu/gluon/parameter.py`` (reference
python/mxnet/gluon/parameter.py): a Parameter with deferred
initialization (the shape completed from the first forward's input),
``grad_req``, ``lr_mult``/``wd_mult``, and a ParameterDict with prefix
scoping and sharing.  A parameter's data is one NDArray on one device;
with a gradient (``grad_req`` 'write' or 'add') it is an autograd leaf
with a gradient buffer of zeros (``autograd.mark_variables``).  Data on
several devices at once comes with the multi-GPU slice.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import autograd
from ..base import MXNetError, numpy_to_tensor, torch_dtype
from ..context import Context, current_context
from ..initializer import InitDesc, Uniform
from ..initializer import create as init_create
from ..ndarray.ndarray import NDArray, zeros

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]

class DeferredInitializationError(MXNetError):
    """A parameter was read before its deferred initialization ran."""


def _one_context(ctx):
    """The single Context of ``ctx`` (a Context, a list of them, or None
    for the current context)."""
    if ctx is None:
        return current_context()
    if isinstance(ctx, Context):
        return ctx
    ctxs = list(dict.fromkeys(ctx))
    if len(ctxs) != 1:
        raise MXNetError("a Parameter lives on one device in the PyTorch "
                         "port; data on several (%s) comes with the "
                         "multi-GPU slice (ROADMAP A.8)" % ctxs)
    return ctxs[0]


class Parameter:
    """A weight of a Block (reference gluon/parameter.py Parameter)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if stype != "default" or grad_stype != "default":
            raise MXNetError("Parameter %s: sparse storage is not in the "
                             "PyTorch port yet (ROADMAP A.6)" % name)
        self.name = name
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._data = None
        self._grad = None
        self._deferred_init = ()
        self._grad_req = None
        self.grad_req = grad_req if differentiable else "null"

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be 'write', 'add' or 'null', "
                             "got %r" % (req,))
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if self._data is not None:
            self._init_grad()

    # ------------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate and initialize the data on ``ctx`` (default: the
        current context), or defer that to the first forward while the
        shape has unknown (0) dimensions."""
        if self._data is not None and not force_reinit:
            return
        ctx = _one_context(ctx)
        default_init = default_init if default_init is not None \
            else Uniform()
        if self.shape is None or any(s == 0 for s in self.shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError("Cannot initialize Parameter '%s' because it "
                             "has invalid shape %s." % (self.name,
                                                        self.shape))
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctx, default_init):
        self._deferred_init = ()
        arr = zeros(self.shape, ctx, self.dtype)
        initializer = init or self.init or default_init
        if isinstance(initializer, str):
            initializer = init_create(initializer)
        initializer(InitDesc(self.name, {"__init__": ""}), arr)
        self._data = arr
        self._init_grad()

    def _init_grad(self):
        """(Re)attach the gradient buffer by ``grad_req``."""
        if self._grad_req == "null":
            self._grad = None
            autograd.mark_variables([self._data], [None], "null")
            return
        self._grad = zeros(self._data.shape, self._data.context,
                           self._data.dtype)
        autograd.mark_variables([self._data], [self._grad],
                                grad_reqs=self._grad_req)

    def _finish_deferred_init(self):
        if self._deferred_init:
            init, ctx, default_init = self._deferred_init
            if self.shape is None or any(s == 0 for s in self.shape):
                raise DeferredInitializationError(
                    "Parameter '%s' has unknown shape %s" % (self.name,
                                                            self.shape))
            self._finish_init(init, ctx, default_init)

    def _shape_from_data(self, data_shape):
        """Complete unknown (0) dimensions from a forward's input."""
        data_shape = tuple(data_shape)
        if self.shape is None:
            self.shape = data_shape
            return
        if len(self.shape) != len(data_shape) or any(
                s != 0 and s != d for s, d in zip(self.shape, data_shape)):
            raise MXNetError("Parameter %s: inferred shape %s incompatible "
                             "with declared %s" % (self.name, data_shape,
                                                   self.shape))
        self.shape = data_shape

    # ------------------------------------------------------------------
    def data(self, ctx=None):
        if self._data is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    "Parameter '%s' has not been initialized yet because "
                    "initialization was deferred. Run a forward pass "
                    "first." % self.name)
            raise MXNetError("Parameter '%s' has not been initialized. "
                             "Initialize it with Block.initialize()."
                             % self.name)
        return self._data

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        if self._grad is None:
            raise MXNetError("Cannot get gradient array for Parameter '%s' "
                             "because grad_req='null'" % self.name)
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        return [self._data.context] if self._data is not None else []

    def zero_grad(self):
        if self._grad is not None:
            self._grad[:] = 0

    def set_data(self, data):
        """Write ``data`` (an NDArray, tensor or numpy array of this
        shape) into the parameter, in place, in its type."""
        shape = tuple(data.shape)
        if self._data is None:
            if not self._deferred_init:
                raise MXNetError("set_data on uninitialized Parameter '%s'"
                                 % self.name)
            self.shape = shape
            self._finish_deferred_init()
        if shape != self._data.shape:
            raise MXNetError("Parameter %s: set_data of shape %s into %s"
                             % (self.name, shape, self._data.shape))
        if isinstance(data, NDArray):
            data = data._data
        elif not isinstance(data, torch.Tensor):
            data = numpy_to_tensor(_np.asarray(data))
        with torch.no_grad():
            self._data._data.copy_(data)

    def _load(self, value, ctx=None):
        """Write a loaded value into the data; a parameter without data
        takes the value's shape (and, when its type was not set, the
        value's type) and is created on ``ctx`` first."""
        if self._data is None:
            self.shape = tuple(value.shape)
            self.initialize(ctx=ctx if ctx is not None
                            else (self._deferred_init[1]
                                  if self._deferred_init else None))
            self._finish_deferred_init()
        self.set_data(value)

    def cast(self, dtype):
        """Cast the data (and gradient) to ``dtype``."""
        self.dtype = dtype
        if self._data is not None:
            self._data = NDArray(self._data._data.detach().to(
                torch_dtype(dtype)))
            self._init_grad()

    def var(self):
        """This parameter as a Symbol variable (hybridization's trace)."""
        from .. import symbol
        return symbol.Variable(self.name, shape=self.shape,
                               lr_mult=self.lr_mult, wd_mult=self.wd_mult)


class Constant(Parameter):
    """A parameter that is never updated (reference Constant)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = NDArray(numpy_to_tensor(
                _np.asarray(value, dtype=_np.float32)))
        self.value = value

        class _ConstantInit:
            def __call__(self, desc, arr):
                arr[:] = value

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_ConstantInit(),
                         differentiable=False)


class ParameterDict:
    """Parameters by name, with a prefix and sharing (reference
    ParameterDict)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        return "ParameterDict '%s' (%s)" % (self._prefix,
                                            ", ".join(sorted(self._params)))

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, created with ``kwargs`` when
        absent; an existing (or shared) one keeps its attributes, which
        must agree with ``kwargs`` (0 dimensions are unknowns)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = self._params[name] = Parameter(name, **kwargs)
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                if v is not None:
                    setattr(param, k, v)
                continue
            if k == "shape" and v is not None:
                v, cur = tuple(v), tuple(existing)
                if len(cur) == len(v) and all(a == b or 0 in (a, b)
                                              for a, b in zip(cur, v)):
                    param.shape = tuple(b if a == 0 else a
                                        for a, b in zip(cur, v))
                    continue
            if v is not None and v != existing:
                raise MXNetError("Parameter '%s' %s mismatch: %s vs %s"
                                 % (name, k, existing, v))
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError("No constant named '%s'" % name)
            param = self._params[name] = Constant(name, value)
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("Cannot update self with other because "
                                 "they have different Parameters with the "
                                 "same name '%s'" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter (``init``, default ``Uniform()``,
        for those without an initializer of their own) on ``ctx``."""
        for _, p in sorted(self._params.items()):
            p.initialize(None, ctx, init or Uniform(), force_reinit)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def setattr(self, name, value):
        for p in self._params.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Save every parameter's data by name (minus ``strip_prefix``)
        in the reference's NDArray file (``serialization.py``)."""
        from ..serialization import save_ndarray_file
        arg = {}
        for p in self._params.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg[name] = p.data()
        save_ndarray_file(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load a file written by :meth:`save` (or ``Block.export``'s
        ``arg:``/``aux:`` file) into the parameters of the same names;
        an uninitialized parameter is created on ``ctx`` with the
        file's shape."""
        from ..serialization import load_ndarray_file
        loaded = load_ndarray_file(filename)
        params = {restore_prefix + k.split(":", 1)[-1]: v
                  for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in params:
                    raise MXNetError("Parameter '%s' is missing in file "
                                     "'%s'" % (name, filename))
        for name, v in params.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError("Parameter '%s' loaded from file '%s' "
                                     "is not present in ParameterDict"
                                     % (name, filename))
                continue
            self._params[name]._load(v, ctx)
