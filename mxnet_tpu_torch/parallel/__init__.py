"""Parallel training helpers (counterpart of ``mxnet_tpu/parallel``):
the 2-bit gradient compressor and ``TrainStep`` on one device.  Meshes,
sharding and the collective stores come with the multi-GPU slice."""
from .compression import TwoBitCompressor
from .trainer import TrainStep

__all__ = ["TwoBitCompressor", "TrainStep"]
