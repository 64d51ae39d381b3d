"""Foundation utilities: the error type and small shared helpers.

Counterpart of ``mxnet_tpu/base.py``.  The backend here is PyTorch, so
the base layer carries only the error type, the anonymous-name counter
the symbol layer uses, the numeric type tuples and the dtype names.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

__all__ = ["MXNetError", "numeric_types", "integer_types", "NameManager",
           "current_name_manager", "torch_dtype", "check_float_dtype",
           "numpy_to_tensor", "LOW_PRECISION"]


class MXNetError(RuntimeError):
    """Error raised by mxnet_tpu_torch (the reference's dmlc error)."""


numeric_types = (float, int, _np.generic)
integer_types = (int, _np.integer)


class NameManager:
    """Unique names for anonymous symbols and Gluon blocks:
    ``{hint_lower}{counter}``, as the reference's python/mxnet/name.py
    hands them out.  ``with NameManager():`` opens a fresh counter scope
    on this thread (what the JAX package's ``base.NameManager`` does), so
    a block built inside it gets the names it would get first in a
    process (``resnetv20_...``)."""

    _scopes = threading.local()

    def __init__(self):
        self._counter = {}
        self._lock = threading.Lock()

    def __enter__(self):
        stack = getattr(NameManager._scopes, "stack", None)
        if stack is None:
            stack = NameManager._scopes.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        NameManager._scopes.stack.pop()

    def get(self, name, hint):
        if name:
            return name
        hint = hint.lower()
        with self._lock:
            idx = self._counter.get(hint, 0)
            self._counter[hint] = idx + 1
        return "%s%d" % (hint, idx)


NAMES = NameManager()


def current_name_manager():
    """The innermost ``with NameManager():`` scope of this thread, else
    the process-wide ``NAMES``."""
    stack = getattr(NameManager._scopes, "stack", None)
    return stack[-1] if stack else NAMES


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
           "int8": torch.int8}
# float16 serves and trains the transformer and trains ResNet (ROADMAP
# A.1): a float16 graph binds over the ops whose float16 forms are held
# against the JAX package (executor.FLOAT16_OPS); the float16 forms of
# the other registered ops wait for ROADMAP A.6
FLOAT16_OPS_LATER = ("no float16 form of these ops is held against the JAX "
                     "package yet (ROADMAP A.6): float16 graphs bind over "
                     "the ops of the transformer's and ResNet's serving and "
                     "training graphs (executor.FLOAT16_OPS)")


def torch_dtype(dtype):
    """A torch dtype from a torch dtype, a name (``'bfloat16'``), a numpy
    dtype or a numpy scalar type (the JAX package's ``np.dtype``
    values, ``ml_dtypes``' bfloat16 included, by name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, _np.dtype):
        name = dtype.name
    elif isinstance(dtype, type) and issubclass(dtype, _np.generic):
        name = _np.dtype(dtype).name
    else:
        name = str(dtype)
    try:
        return _DTYPES[name]
    except KeyError:
        raise MXNetError("unknown dtype %r" % (dtype,)) from None


def check_float_dtype(dtype, where):
    """``dtype`` as a torch dtype: float32, bfloat16 or float16; raises
    for any other type.  Which graphs float16 may bind is the
    executor's check (``executor.FLOAT16_OPS``)."""
    dt = torch_dtype(dtype)
    if dt not in (torch.float32, torch.bfloat16, torch.float16):
        raise MXNetError("%s: %s is not a type the port computes in yet "
                         "(ROADMAP A.1): float32, bfloat16 and float16"
                         % (where, dt))
    return dt


LOW_PRECISION = (torch.bfloat16, torch.float16)


def numpy_to_tensor(a):
    """A CPU tensor over numpy ``a``: bfloat16 arrays (``ml_dtypes``', as
    the JAX package's bf16 arrays come to numpy) are carried bit for bit
    as ``torch.bfloat16``; other types as ``torch.from_numpy`` takes
    them."""
    a = _np.array(a, copy=not (isinstance(a, _np.ndarray)
                               and a.flags.writeable
                               and a.flags.c_contiguous))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(_np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)
