"""NDArray over ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``, reduced to what the
serving slice uses: construction from numpy or a tensor onto a context,
``shape``/``context``, ``asnumpy``, ``copyto`` and ``_set_data``.
Imperative operators and autograd come with the imperative slice.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..context import Context, context_of, current_context

__all__ = ["NDArray"]


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

    def asnumpy(self):
        """Copy to a host numpy array (waits for the device).  bf16
        comes back as float32, which holds it exactly."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def _set_data(self, t):
        self._data = t

    def copyto(self, other):
        """Copy into another NDArray of the same shape, or onto a
        Context (a new NDArray)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto: shape %s into %s"
                                 % (self.shape, other.shape))
            other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device, copy=True))
        raise MXNetError("copyto: target must be an NDArray or a Context")

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)
