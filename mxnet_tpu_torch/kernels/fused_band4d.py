"""``relu(x * scale + shift) @ w`` over a 4-D channel-last ``x``: the
fused BatchNorm-apply, ReLU and 1x1 convolution of the fused-sandwich
microbenchmark, without a residual.

Counterpart of ``tools/fused_sandwich_bench.py`` ``pal4d_band`` (the
Pallas kernel ``_kern4d``, the 4-D form of ``mxnet_tpu/ops/fused.py``
``_pallas_fwd``).  The kernel is ``csrc/fused_band4d.cu`` (design notes
in the source): a GEMM over the (b, h, w) rows of ``x``, read through
``x``'s own strides, whose prologue applies the per-channel affine and
the ReLU in shared memory, on the tensor cores (``mma.sync``): in bf16
and f16 the two instances of the 16-bit GEMM of
``csrc/fused_gemm_bf16.cuh``, in f32 the split-TF32 GEMM of
``csrc/fused_gemm_f32.cuh``, each the one row 7's kernel runs, so rows 7
and 10 give the same bits on the same operands.  ``x``
(B, H, W, K) and ``w`` (K, N) share one type, f32, bf16 or f16 (a mixed
pair raises before any pointer reaches the kernel); ``scale`` and
``shift`` are f32 (K,); the output is a contiguous (B, H, W, N) in
``x``'s type.  The activation is computed in f32 and rounded to
``w``'s type before the product, the product accumulates in f32 and
the output is rounded once, the TPU kernel's rounding points.

``x`` need not be contiguous: a ``channels_last`` view of a
convolution's output and a contiguous (B, H, W, K) tensor both go to
the kernel as they are, with no copy.  ``fused_band4d_plain`` is the
same function in plain PyTorch: the CPU path and the kernel's
yardstick on the card.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build
from .dispatch import (DTYPE_CODE, FLOAT_TYPES, check_tensor, count_launch,
                       count_plain, on_cpu)

__all__ = ["fused_band4d", "fused_band4d_plain"]

_KERNEL = "fused_band4d"


def _lib():
    lib = _build.load("fused_band4d")
    fn = lib.mx_fused_band4d
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, i64, i64, i64, i64, i64, i64, i64,
                       i64, i64, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def fused_band4d_plain(x, scale, shift, w):
    """``relu(x * scale + shift) @ w``: x (B, H, W, K), scale and shift
    (K,) f32, w (K, N); the activation rounded to w's dtype, the product
    in f32, the result in x's dtype."""
    count_plain(_KERNEL)
    a = torch.relu(x.float() * scale + shift).to(w.dtype)
    return torch.matmul(a.float(), w.float()).to(x.dtype)


def _check(x, scale, shift, w):
    if x.dtype not in FLOAT_TYPES:
        raise MXNetError("%s: x has dtype %s; the kernel takes %s"
                         % (_KERNEL, x.dtype,
                            ", ".join(str(d) for d in FLOAT_TYPES)))
    if x.dim() != 4:
        raise MXNetError("%s: x must be 4-D (B, H, W, K), got shape %s"
                         % (_KERNEL, tuple(x.shape)))
    K = x.shape[3]
    check_tensor(_KERNEL, "w", w, dtypes=(x.dtype,), ndim=2)
    if w.shape[0] != K:
        raise MXNetError("%s: w has shape %s, expected (%d, N)"
                         % (_KERNEL, tuple(w.shape), K))
    for name, t in (("scale", scale), ("shift", shift)):
        check_tensor(_KERNEL, name, t, dtypes=(torch.float32,), shape=(K,))


def fused_band4d(x, scale, shift, w):
    """The band in one launch: the value of :func:`fused_band4d_plain`
    up to the order of the sums over K.  Takes f32, bf16 or f16 ``x`` (any
    strides) and contiguous ``w`` of the same type, f32 ``scale`` and
    ``shift``, any B, H, W, K and N; CPU tensors take the plain
    version, CUDA tensors launch the kernel or raise."""
    if on_cpu(_KERNEL, x, scale, shift, w):
        _check(x, scale, shift, w)
        return fused_band4d_plain(x, scale, shift, w)
    _check(x, scale, shift, w)
    B, H, W, K = x.shape
    N = w.shape[1]
    y = torch.empty(B, H, W, N, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    err = lib.mx_fused_band4d(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
        y.data_ptr(), B, H, W, K, N, *x.stride(), DTYPE_CODE[x.dtype],
        x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, _KERNEL, err)
    count_launch(_KERNEL, x.dtype)
    return y
