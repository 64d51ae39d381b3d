"""Model zoo of the PyTorch port (counterpart of ``mxnet_tpu/models``)."""
from . import transformer

__all__ = ["transformer"]
