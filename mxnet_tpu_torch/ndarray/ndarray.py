"""NDArray over ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``, reduced to what the
serving and training slices use: construction from numpy or a tensor
onto a context (``array``, ``zeros``), ``shape``/``context``,
``asnumpy``, ``copy``, ``copyto``, ``dtype`` and ``astype``,
whole-array assignment (``arr[:] = value``, as the initializers write)
and ``_set_data``.
Imperative operators and autograd come with the imperative slice.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, numpy_to_tensor, torch_dtype
from ..context import Context, context_of, current_context

__all__ = ["NDArray", "array", "zeros"]


class NDArray:
    """A tensor on one device.  ``_data`` is the ``torch.Tensor``.
    Numpy data is copied onto ``ctx`` (default: the current context) as
    float32 unless ``dtype`` names another numpy type."""

    __slots__ = ("_data",)

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if isinstance(data, torch.Tensor):
            self._data = data if ctx is None else data.to(ctx.torch_device)
            return
        arr = _np.ascontiguousarray(data, dtype=dtype or _np.float32)
        dev = (ctx if ctx is not None else current_context()).torch_device
        self._data = torch.from_numpy(arr).to(dev)

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def context(self) -> Context:
        return context_of(self._data.device)

    @property
    def dtype(self):
        """The element type, a torch dtype."""
        return self._data.dtype

    def astype(self, dtype):
        """A new NDArray holding a copy in ``dtype`` (a name, numpy or
        torch dtype), on the same device."""
        return NDArray(self._data.detach().to(torch_dtype(dtype), copy=True))

    def __setitem__(self, key, value):
        """Whole-array assignment only (``arr[:] = value``): a scalar,
        numpy array, tensor or NDArray of the same shape, written in
        place without recording a gradient."""
        if not (isinstance(key, slice) and key == slice(None)):
            raise MXNetError("NDArray assignment supports arr[:] = value "
                             "only in the PyTorch port")
        if isinstance(value, NDArray):
            value = value._data
        with torch.no_grad():
            if isinstance(value, (int, float)):
                self._data.fill_(value)
                return
            if not isinstance(value, torch.Tensor):
                value = numpy_to_tensor(_np.asarray(value))
            if tuple(value.shape) != self.shape:
                raise MXNetError("assignment of shape %s into %s"
                                 % (tuple(value.shape), self.shape))
            self._data.copy_(value)

    def asnumpy(self):
        """Copy to a host numpy array (waits for the device).  bf16
        comes back as float32, which holds it exactly."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def _set_data(self, t):
        self._data = t

    def copy(self):
        """A new NDArray holding a copy, on the same device."""
        return NDArray(self._data.detach().clone())

    def copyto(self, other):
        """Copy into another NDArray of the same shape, or onto a
        Context (a new NDArray)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto: shape %s into %s"
                                 % (self.shape, other.shape))
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True))
        raise MXNetError("copyto: target must be an NDArray or a Context")

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)


def array(source, ctx=None):
    """A new NDArray holding a copy of ``source``: a tensor or NDArray
    keeps its dtype and (without ``ctx``) its device; numpy or a list
    becomes float32 on ``ctx`` (default: the current context)."""
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        dev = (ctx if ctx is not None else context_of(source.device)) \
            .torch_device
        return NDArray(source.detach().to(dev, copy=True))
    return NDArray(_np.array(source, dtype=_np.float32), ctx=ctx)


def zeros(shape, ctx=None):
    """A float32 NDArray of zeros on ``ctx`` (default: the current
    context)."""
    dev = (ctx if ctx is not None else current_context()).torch_device
    return NDArray(torch.zeros(tuple(shape), dtype=torch.float32,
                               device=dev))
