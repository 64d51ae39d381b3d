"""Error-feedback 2-bit quantize, the kvstore's gradient compressor.

Counterpart of ``mxnet_tpu/pallas/quant.py`` ``two_bit_quantize_fused``.
The kernel is ``csrc/quant.cu`` (design notes in the source): one
grid-stride pass over the flat operands, 16-byte vectors where the
pointers allow, nothing padded.  ``two_bit_quantize_plain`` is the same
function in plain PyTorch: the CPU path and the kernel's yardstick on
the card.  Both return the JAX package's bits: the threshold is rounded
to f32 before it meets an f32 sum, and the op sequence (add, compares,
exact-constant selects, subtract) is the reference's.

Neither writes over its inputs: the new residual is a new tensor, as in
the JAX package's functional form.
"""
from __future__ import annotations

import ctypes

import numpy as _np
import torch

from . import _build
from .dispatch import check_tensor, count_launch, count_plain, on_cpu

__all__ = ["two_bit_quantize_fused", "two_bit_quantize_plain"]

_KERNEL = "two_bit_quantize_fused"


def _lib():
    lib = _build.load("quant")
    fn = lib.mx_two_bit_quantize
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int64, ctypes.c_float,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def _f32(threshold):
    """The threshold as the f32 value the reference compares with
    (``jnp.asarray(threshold, float32)``), held in a Python float."""
    return float(_np.float32(threshold))


def two_bit_quantize_plain(residual, grad, threshold):
    """``acc = residual + grad``; ``q`` is ``+t`` where ``acc > t``,
    ``-t`` where ``acc < -t`` and 0 elsewhere; ``new_residual = acc -
    q``.  Returns ``(q, new_residual)`` in f32, shaped like ``grad``."""
    count_plain(_KERNEL)
    t = _f32(threshold)
    acc = residual.float() + grad.float()
    q = torch.zeros_like(acc)
    q.masked_fill_(acc > t, t)
    q.masked_fill_(acc < -t, -t)
    return q, acc - q


def two_bit_quantize_fused(residual, grad, threshold):
    """Error-feedback 2-bit quantize in one pass: ``(q, new_residual)``
    with the bits of :func:`two_bit_quantize_plain`.  Takes f32 tensors
    of one shape, any length (0 included); CPU tensors take the plain
    version, CUDA tensors launch the kernel or raise."""
    if on_cpu(_KERNEL, residual, grad):
        return two_bit_quantize_plain(residual, grad, threshold)
    check_tensor(_KERNEL, "grad", grad, dtypes=(torch.float32,))
    check_tensor(_KERNEL, "residual", residual, dtypes=(torch.float32,),
                 shape=grad.shape)
    q = torch.empty_like(grad)
    new_residual = torch.empty_like(grad)
    n = grad.numel()
    if n == 0:
        return q, new_residual
    lib = _lib()
    err = lib.mx_two_bit_quantize(
        residual.data_ptr(), grad.data_ptr(), q.data_ptr(),
        new_residual.data_ptr(), n, _f32(threshold), grad.device.index or 0,
        torch.cuda.current_stream(grad.device).cuda_stream)
    _build.check(lib, _KERNEL, err)
    count_launch(_KERNEL, grad.dtype)
    return q, new_residual
