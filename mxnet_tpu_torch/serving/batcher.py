"""Serving errors shared with the decode engine.

Counterpart of ``mxnet_tpu/serving/batcher.py``: the structured error
classes and the nearest-rank percentile.  The batching server itself
comes with the serving slice.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServingError", "QueueFullError", "DeadlineExceededError",
           "ServerClosedError", "percentile"]


def percentile(sorted_vals, q):
    """Nearest-rank percentile of an already-sorted sequence (None when
    empty)."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class ServingError(MXNetError):
    """Base class for structured serving errors."""


class QueueFullError(ServingError):
    """Admission control: the request queue is at capacity; retry later."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired before a forward slot ran it."""


class ServerClosedError(ServingError):
    """The server is stopped (or stopping) and accepts no new work."""
