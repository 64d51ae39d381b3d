"""NDArray over torch tensors (counterpart of ``mxnet_tpu/ndarray``)."""
from .ndarray import NDArray, array, zeros

__all__ = ["NDArray", "array", "zeros"]
