"""Operators of the PyTorch port (counterpart of ``mxnet_tpu/ops``).
Importing the package registers every op module."""
from . import (contrib_ops, elemwise, fused, nn,  # noqa: F401  (registration)
               random_ops, rnn, tensor)
from .registry import get_op, list_ops, register

__all__ = ["get_op", "list_ops", "register"]
