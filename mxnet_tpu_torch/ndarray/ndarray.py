"""NDArray over ``torch.Tensor``: MXNet's imperative tensor.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  ``_data`` is the
tensor; it lives on one device, the card unless the caller asked for
the CPU.  Every operator (arithmetic, comparisons, reductions, shape
ops, the fluent ``x.<op>(...)`` form) goes through the op registry
(``dispatch.invoke``), so ``autograd.record()`` sees it; indexing is
torch's own, recorded the same way.  ``asnumpy``/``asscalar`` copy to
the host and wait for the device (``wait_to_read`` waits without a
copy).

Mutation follows MXNet: ``x[...] = v``, ``x += v`` and ``out=`` write
into the array.  Outside ``autograd.record()`` the write is in place
(the tensor keeps its identity, so a parameter with an attached
gradient stays a leaf).  Inside it, writing into an array that the
recorded graph holds (one with an attached gradient, or the output of
a recorded op), or writing a recorded value, raises ``MXNetError``, as
the reference does; any other array is rebound to the new value, which
then joins the graph.

``attach_grad`` makes the array a leaf of the graph (a detached tensor
that requires a gradient) with a gradient buffer of zeros in its type;
``backward`` and ``grad`` are ``autograd``'s.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import (MXNetError, integer_types, numeric_types,
                    numpy_to_tensor, torch_dtype)
from ..context import Context, context_of, current_context
from . import dispatch as _dispatch

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "moveaxis", "onehot_encode", "waitall"]


class NDArray:
    """A tensor on one device.  ``_data`` is the ``torch.Tensor``.
    Numpy data is copied onto ``ctx`` (default: the current context) as
    float32 unless ``dtype`` names another numpy type."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    # numpy defers to NDArray's reflected operators
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None, dtype=None):
        self._grad = None
        self._grad_req = "null"
        if isinstance(data, NDArray):
            data = data._data
        if isinstance(data, torch.Tensor):
            self._data = data if ctx is None else data.to(ctx.torch_device)
            return
        arr = _np.ascontiguousarray(data, dtype=dtype or _np.float32)
        dev = (ctx if ctx is not None else current_context()).torch_device
        self._data = torch.from_numpy(arr).to(dev)

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def context(self) -> Context:
        return context_of(self._data.device)

    ctx = context

    @property
    def dtype(self):
        """The element type, a torch dtype."""
        return self._data.dtype

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def stype(self):
        return "default"

    @property
    def grad(self):
        """The gradient buffer ``attach_grad`` made (None before)."""
        return self._grad

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __hash__(self):
        return id(self)

    def __getattr__(self, name):
        # the fluent form: x.norm(), x.nansum(axis=...), ... for every
        # registered op, with this array as the first input
        if name.startswith("_"):
            raise AttributeError(name)
        from ..ops import registry as _registry
        try:
            opdef = _registry.get_op(name)
        except MXNetError:
            raise AttributeError("'NDArray' object has no attribute %r"
                                 % name) from None

        def fluent(*args, **kwargs):
            return _dispatch.invoke(opdef, (self,) + args, kwargs)
        fluent.__name__ = name
        return fluent

    # ------------------------------------------------------------------
    # host and device
    # ------------------------------------------------------------------
    def asnumpy(self):
        """Copy to a host numpy array (waits for the device); the copy
        never shares memory with the array.  bf16 comes back as float32,
        which holds it exactly."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy()
        return t.cpu().numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()

    def __getstate__(self):
        """The JAX package's pickled state, ``{"data": numpy, "ctx":
        "cpu(0)"}`` (host data: a loader places it).  A bfloat16 array
        is written as ``ml_dtypes``' bfloat16 where that package exists
        (the JAX package's own form), else as float32 with a ``dtype``
        entry the port reads back."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            try:
                import ml_dtypes
            except ImportError:
                return {"data": t.float().cpu().numpy(), "ctx": "cpu(0)",
                        "dtype": "bfloat16"}
            bits = t.cpu().contiguous().view(torch.int16).numpy()
            return {"data": bits.view(ml_dtypes.bfloat16), "ctx": "cpu(0)"}
        return {"data": t.cpu().numpy().copy() if t.device.type == "cpu"
                else t.cpu().numpy(), "ctx": "cpu(0)"}

    def __setstate__(self, state):
        """Either package's pickled state, as an array on the CPU."""
        t = numpy_to_tensor(state["data"])
        if state.get("dtype"):
            t = t.to(torch_dtype(state["dtype"]))
        self._data = t
        self._grad = None
        self._grad_req = "null"

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def astype(self, dtype, copy=True):
        """A new NDArray holding a copy in ``dtype`` (a name, numpy or
        torch dtype), on the same device; not recorded by autograd, as
        in the JAX package.  ``copy=False`` returns this array when it
        already has that type."""
        dt = torch_dtype(dtype)
        if not copy and dt == self._data.dtype:
            return self
        return NDArray(self._data.detach().to(dt, copy=True))

    def copy(self):
        """A new NDArray holding a copy, on the same device."""
        return NDArray(self._data.detach().clone())

    def copyto(self, other):
        """Copy into another NDArray of the same shape, or onto a
        Context (a new NDArray)."""
        if isinstance(other, NDArray):
            if other is self:
                return other
            if other.shape != self.shape:
                raise MXNetError("copyto: shape %s into %s"
                                 % (self.shape, other.shape))
            _write(other, self._data.detach())
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True))
        raise MXNetError("copyto: target must be an NDArray or a Context")

    def as_in_context(self, context):
        """This array when it is on ``context``, else a copy there."""
        if context == self.context:
            return self
        return self.copyto(context)

    def wait_to_read(self):
        """Wait until the device has computed this array."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def _set_data(self, t):
        self._data = t

    # ------------------------------------------------------------------
    # indexing and assignment
    # ------------------------------------------------------------------
    def _key(self, key):
        """NDArray and list indices as tensors on this array's device,
        at any level of a tuple key."""
        if isinstance(key, NDArray):
            t = key._data
            return t if t.dtype == torch.bool else t.long()
        if isinstance(key, (list, _np.ndarray)):
            return torch.as_tensor(_np.asarray(key)).to(self._data.device)
        if isinstance(key, tuple):
            return tuple(self._key(k) if isinstance(
                k, (list, _np.ndarray, NDArray)) else k for k in key)
        return key

    def __getitem__(self, key):
        """Basic and advanced indexing (ints, slices, lists and NDArray
        indices); recorded when autograd records."""
        from .. import autograd
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data[self._key(key)])

    def __setitem__(self, key, value):
        """Write ``value`` (a scalar, numpy array, list, tensor or
        NDArray, broadcast to the slot) into ``self[key]``."""
        _guard_write(self, value)
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, (torch.Tensor, bool) + numeric_types):
            value = numpy_to_tensor(_np.asarray(value))
        key = self._key(key)
        if isinstance(key, tuple) and not key:
            key = slice(None)
        with torch.no_grad():
            slot = self._data[key]
            if isinstance(value, torch.Tensor):
                value = value.to(self._data.device, self._data.dtype)
                if value.dim() > slot.dim() or not _broadcastable(
                        value.shape, slot.shape):
                    # a value with extra size-1 axes squeezes into the
                    # slot (the reference's b[0] = np.array([x])); any
                    # other shape raises
                    squeezed = [d for d in value.shape if d != 1]
                    if squeezed != [d for d in slot.shape if d != 1]:
                        raise MXNetError(
                            "assignment of shape %s into a slot of %s"
                            % (tuple(value.shape), tuple(slot.shape)))
                    value = value.reshape(slot.shape)
            self._data[key] = value

    # ------------------------------------------------------------------
    # shape ops, through the registry so autograd records them
    # ------------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if not shape:
            shape = tuple(kwargs.get("shape", ()))
        return _dispatch.invoke_by_name("Reshape", [self], {"shape": shape})

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def expand_dims(self, axis):
        return _dispatch.invoke_by_name("expand_dims", [self],
                                        {"axis": axis})

    def squeeze(self, axis=None):
        return _dispatch.invoke_by_name("squeeze", [self], {"axis": axis})

    def transpose(self, *axes, **kwargs):
        if not axes and kwargs.get("axes") is not None:
            axes = tuple(kwargs["axes"])
        elif len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _dispatch.invoke_by_name("transpose", [self], {"axes": axes})

    @property
    def T(self):
        return self.transpose()

    def flatten(self):
        return self.reshape((self.shape[0], -1))

    def broadcast_to(self, shape):
        return _dispatch.invoke_by_name("broadcast_to", [self],
                                        {"shape": tuple(shape)})

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def swapaxes(self, dim1, dim2):
        return _dispatch.invoke_by_name("SwapAxis", [self],
                                        {"dim1": dim1, "dim2": dim2})

    def tile(self, reps):
        return _dispatch.invoke_by_name("tile", [self], {"reps": reps})

    def slice_axis(self, axis, begin, end):
        return _dispatch.invoke_by_name(
            "slice_axis", [self], {"axis": axis, "begin": begin, "end": end})

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return _dispatch.invoke_by_name(
            "one_hot", [self],
            {"depth": depth, "on_value": on_value, "off_value": off_value})

    def clip(self, a_min, a_max):
        return _dispatch.invoke_by_name("clip", [self],
                                        {"a_min": a_min, "a_max": a_max})

    def abs(self):
        return _dispatch.invoke_by_name("abs", [self], {})

    def _reduce(self, op, axis, keepdims):
        return _dispatch.invoke_by_name(op, [self], {"axis": axis,
                                                     "keepdims": keepdims})

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._reduce("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._reduce("argmin", axis, keepdims)

    # ------------------------------------------------------------------
    # autograd
    # ------------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a leaf of the graph with a zero gradient
        buffer (``grad_req`` 'write' or 'add')."""
        from .. import autograd
        autograd.mark_variables([self], [zeros(self.shape, self.context,
                                               self.dtype)],
                                grad_reqs=grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], out_grads=None if out_grad is None
                          else [out_grad], retain_graph=retain_graph,
                          train_mode=train_mode)

    def detach(self):
        return NDArray(self._data.detach())

    # ------------------------------------------------------------------
    # arithmetic, through the registry
    # ------------------------------------------------------------------
    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return _dispatch.invoke_by_name(op, [a, b], {})
        if isinstance(other, numeric_types):
            return _dispatch.invoke_by_name(
                scalar_op, [self], {"scalar": other, "reverse": reverse})
        if isinstance(other, _np.ndarray):
            return self._binop(array(other, self.context), op, scalar_op,
                               reverse)
        return NotImplemented

    def __add__(self, o): return self._binop(o, "broadcast_add", "_plus_scalar")
    def __radd__(self, o): return self._binop(o, "broadcast_add", "_plus_scalar", True)
    def __sub__(self, o): return self._binop(o, "broadcast_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binop(o, "broadcast_sub", "_minus_scalar", True)
    def __mul__(self, o): return self._binop(o, "broadcast_mul", "_mul_scalar")
    def __rmul__(self, o): return self._binop(o, "broadcast_mul", "_mul_scalar", True)
    def __truediv__(self, o): return self._binop(o, "broadcast_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binop(o, "broadcast_div", "_div_scalar", True)
    def __mod__(self, o): return self._binop(o, "broadcast_mod", "_mod_scalar")
    def __rmod__(self, o): return self._binop(o, "broadcast_mod", "_mod_scalar", True)
    def __pow__(self, o): return self._binop(o, "broadcast_power", "_power_scalar")
    def __rpow__(self, o): return self._binop(o, "broadcast_power", "_power_scalar", True)
    def __neg__(self): return self._binop(-1.0, None, "_mul_scalar")
    def __gt__(self, o): return self._binop(o, "broadcast_greater", "_greater_scalar")
    def __ge__(self, o): return self._binop(o, "broadcast_greater_equal", "_greater_equal_scalar")
    def __lt__(self, o): return self._binop(o, "broadcast_lesser", "_lesser_scalar")
    def __le__(self, o): return self._binop(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    def __eq__(self, o):
        if o is None:
            return False
        return self._binop(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")

    def _inplace(self, out):
        if out is NotImplemented:
            return out
        if out.shape != self.shape:
            raise MXNetError("in-place operation: result shape %s does not "
                             "match %s" % (out.shape, self.shape))
        _write(self, out._data)
        return self

    def __iadd__(self, o):
        _guard_write(self, None)
        return self._inplace(self.__add__(o))

    def __isub__(self, o):
        _guard_write(self, None)
        return self._inplace(self.__sub__(o))

    def __imul__(self, o):
        _guard_write(self, None)
        return self._inplace(self.__mul__(o))

    def __itruediv__(self, o):
        _guard_write(self, None)
        return self._inplace(self.__truediv__(o))


def _broadcastable(src, dst):
    return all(s in (1, d) for s, d in zip(reversed(tuple(src)),
                                           reversed(tuple(dst))))


def _in_graph(nd):
    """Whether the recorded graph holds ``nd``: an attached gradient,
    or a tensor that autograd tracks."""
    return isinstance(nd, NDArray) and (nd._grad is not None
                                        or nd._data.requires_grad)


def _guard_write(dst, value):
    """The reference's rule: while recording, no in-place write into
    an array the graph holds, and no write of a recorded value."""
    from .. import autograd
    if autograd.is_recording() and (_in_graph(dst) or _in_graph(value)):
        raise MXNetError(
            "Inplace operations (+=, -=, x[:]=, out=, etc) are not "
            "supported when recording with autograd: the array is part "
            "of the recorded graph; compute a new array instead")


def _write(dst, t):
    """Store tensor ``t`` into the whole of ``dst``: in place, or, when
    ``t`` is a recorded value (``_guard_write`` has checked ``dst``), by
    rebinding ``dst`` to it, so it joins the graph."""
    from .. import autograd
    if autograd.is_recording() and t.requires_grad:
        dst._data = t.to(dst._data.dtype)
        return
    with torch.no_grad():
        dst._data.copy_(t)


# ----------------------------------------------------------------------
# creation
# ----------------------------------------------------------------------
def _device(ctx):
    return (ctx if ctx is not None else current_context()).torch_device


def _shape(shape):
    return (int(shape),) if isinstance(shape, integer_types) \
        else tuple(shape)


def array(source, ctx=None, dtype=None):
    """A new NDArray holding a copy of ``source``.  A tensor or NDArray
    keeps its dtype (unless ``dtype``) and, without ``ctx``, its device;
    numpy data and lists keep their type except float64 -> float32 and
    int64 -> int32 (the JAX package's rule), on ``ctx`` (default: the
    current context)."""
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        dev = _device(ctx) if ctx is not None else source.device
        out = source.detach().to(dev, copy=True)
        return NDArray(out if dtype is None else out.to(torch_dtype(dtype)))
    arr = _np.asarray(source)
    if dtype is not None:
        t = numpy_to_tensor(arr.astype(dtype) if arr.dtype.name != "bfloat16"
                            else arr).to(torch_dtype(dtype))
    else:
        if arr.dtype == _np.float64:
            arr = arr.astype(_np.float32)
        elif arr.dtype == _np.int64:
            arr = arr.astype(_np.int32)
        t = numpy_to_tensor(arr)
    return NDArray(t.to(_device(ctx), copy=True))


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx, dtype)


def _emit(t, out):
    if out is None:
        return NDArray(t)
    _guard_write(out, None)
    _write(out, t)
    return out


def zeros(shape, ctx=None, dtype="float32", out=None):
    """An NDArray of zeros (float32 by default) on ``ctx`` (default: the
    current context)."""
    return _emit(torch.zeros(_shape(shape), dtype=torch_dtype(
        dtype or "float32"), device=_device(ctx)), out)


def ones(shape, ctx=None, dtype="float32", out=None):
    return _emit(torch.ones(_shape(shape), dtype=torch_dtype(
        dtype or "float32"), device=_device(ctx)), out)


def full(shape, val, ctx=None, dtype="float32", out=None):
    return _emit(torch.full(_shape(shape), val, dtype=torch_dtype(
        dtype or "float32"), device=_device(ctx)), out)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                     device=_device(ctx))
    return NDArray(t.repeat_interleave(int(repeat)) if repeat > 1 else t)


def moveaxis(tensor, source, destination):
    return NDArray(tensor._data.movedim(source, destination))


def concatenate(arrays, axis=0, always_copy=True):
    if not arrays:
        raise ValueError("concatenate needs at least one array")
    return _dispatch.invoke_by_name("Concat", list(arrays), {"dim": axis})


def onehot_encode(indices, out):
    """Write the one-hot rows of ``indices`` into ``out``."""
    depth = out.shape[1]
    t = torch.nn.functional.one_hot(indices._data.long(), depth)
    return _emit(t.to(out.dtype), out)


def waitall():
    """Wait for all work queued on the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
