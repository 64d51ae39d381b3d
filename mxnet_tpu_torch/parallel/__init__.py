"""Parallel training helpers (counterpart of ``mxnet_tpu/parallel``):
the 2-bit gradient compressor.  Meshes, sharding and the collective
stores come with the multi-GPU slice."""
from .compression import TwoBitCompressor

__all__ = ["TwoBitCompressor"]
