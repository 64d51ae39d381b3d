"""Data iterators (counterpart of ``mxnet_tpu/io``)."""
from .io import DataBatch, DataDesc, DataIter, NDArrayIter

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]
