"""Foundation utilities: the error type and small shared helpers.

Counterpart of ``mxnet_tpu/base.py``.  The backend here is PyTorch, so
the base layer carries only the error type, the anonymous-name counter
the symbol layer uses, and the numeric type tuples.
"""
from __future__ import annotations

import threading

import numpy as _np

__all__ = ["MXNetError", "numeric_types", "NameManager"]


class MXNetError(RuntimeError):
    """Error raised by mxnet_tpu_torch (the reference's dmlc error)."""


numeric_types = (float, int, _np.generic)


class NameManager:
    """Unique names for anonymous symbols: ``{op_name_lower}{counter}``,
    as the reference's python/mxnet/name.py hands them out."""

    def __init__(self):
        self._counter = {}
        self._lock = threading.Lock()

    def get(self, name, hint):
        if name:
            return name
        hint = hint.lower()
        with self._lock:
            idx = self._counter.get(hint, 0)
            self._counter[hint] = idx + 1
        return "%s%d" % (hint, idx)


NAMES = NameManager()
