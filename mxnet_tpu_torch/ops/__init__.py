"""Operators of the PyTorch port (counterpart of ``mxnet_tpu/ops``).
Importing the package registers every op module."""
from . import elemwise, fused, nn, tensor  # noqa: F401  (registration)
from .registry import get_op, list_ops, register

__all__ = ["get_op", "list_ops", "register"]
