"""Serving errors (counterpart of ``mxnet_tpu/serving``)."""
from .batcher import (DeadlineExceededError, QueueFullError,
                      ServerClosedError, ServingError)

__all__ = ["ServingError", "QueueFullError", "DeadlineExceededError",
           "ServerClosedError"]
