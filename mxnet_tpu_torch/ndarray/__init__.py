"""NDArray over torch tensors (counterpart of ``mxnet_tpu/ndarray``)."""
from .ndarray import NDArray

__all__ = ["NDArray"]
