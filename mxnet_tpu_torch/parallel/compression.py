"""2-bit gradient compression with error feedback.

Counterpart of ``mxnet_tpu/parallel/compression.py`` (reference
src/kvstore/gradient_compression.h, rahul003's contribution):

  residual += grad
  q = +threshold where residual >  threshold
      -threshold where residual < -threshold
      0 otherwise
  residual -= q          (error feedback)

``compress_decompress`` is the local form the single-process store
uses; it runs ``kvstore_fused.two_bit_quantize``, so the eager per-key
path launches the same CUDA kernel as the bucketed one on the card.
The 2-bit wire packing (``compress``/``decompress``, 4 codes per byte)
exists only for the cross-host hop and comes with the multi-GPU slice.
"""
from __future__ import annotations

__all__ = ["TwoBitCompressor"]


class TwoBitCompressor:
    """The compression config; equal when the thresholds are equal."""

    def __init__(self, threshold=0.5):
        self.threshold = float(threshold)

    def __eq__(self, other):
        return (type(other) is type(self)
                and other.threshold == self.threshold)

    def __hash__(self):
        return hash((type(self).__name__, self.threshold))

    def compress_decompress(self, grad, residual):
        """``(quantized_grad, new_residual)`` of f32 tensors: the
        quantize followed by its dequantize, which is the identity on
        the quantized values."""
        from ..kvstore_fused import two_bit_quantize
        return two_bit_quantize(residual, grad, self.threshold)
