"""``relu(x * scale + shift) @ w^T (+ res)``, the fused BatchNorm-apply,
ReLU and 1x1 convolution of channel-last ResNets.

Counterpart of ``mxnet_tpu/ops/fused.py`` ``_pallas_fwd`` (the Pallas
kernel of ``fused_scale_relu_matmul``).  The kernel is
``csrc/fused_matmul.cu`` (design notes in the sources): a GEMM whose
prologue applies the per-channel affine and the ReLU to each tile of
``x`` in shared memory, so the activation never exists in device
memory, and whose epilogue adds the residual; every type on the tensor
cores with ``mma.sync``: bf16 and f16 through the two instances of the
16-bit GEMM of ``csrc/fused_gemm_bf16.cuh`` (a template over the element
type) that row 10's ``fused_band4d`` shares, f32 through
``csrc/fused_gemm_f32.cuh`` in split TF32 (three TF32 products on the
hi and lo halves of each operand, summed in f32: within rtol 1e-4 /
atol 1e-5 of the plain f32 version, where one TF32 product is not).
``x``, ``w``, ``res`` and the output share one type, f32, bf16 or f16
(a mixed pair, f16 ``x`` with bf16 ``w``, raises before any pointer
reaches the kernel); ``scale`` and ``shift`` are f32.  In 16 bits the
kernel follows the TPU kernel's rounding points: the activation is
computed in f32 and rounded to the 16-bit type before the product, the
product and the residual add run in f32, and the output is rounded
once (in f16 a value past 65504 becomes inf there, as in the plain
version).
``w`` is ``(N, K)``: the OHWI convolution weight viewed as it is stored,
with no transpose.  ``fused_scale_relu_matmul_plain`` is the same
function in plain PyTorch (the JAX package's ``_jnp_fwd``, with the
kernel's f32 accumulation): the CPU path and the kernel's yardstick on
the card.

Unlike the TPU kernel, which gives up unless ``M % 128 == 0`` (the JAX
package then takes its jnp path), the CUDA kernel takes any M, K and N:
nothing is padded, and a CUDA tensor always launches it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .dispatch import (DTYPE_CODE, FLOAT_TYPES, check_tensor, count_launch,
                       count_plain, on_cpu)

__all__ = ["fused_scale_relu_matmul_fwd", "fused_scale_relu_matmul_plain"]

_KERNEL = "fused_scale_relu_matmul"


def _lib():
    lib = _build.load("fused_matmul")
    fn = lib.mx_fused_scale_relu_matmul
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def fused_scale_relu_matmul_plain(x, scale, shift, w, res=None):
    """``relu(x * scale + shift) @ w^T``, plus ``res`` when given: x
    (M, K), scale and shift (K,) f32, w (N, K), res (M, N); the
    activation rounded to x's dtype, the product and the residual add
    in f32, the result in x's dtype."""
    count_plain(_KERNEL)
    a = torch.relu(x.float() * scale + shift).to(x.dtype)
    y = torch.matmul(a.float(), w.float().t())
    if res is not None:
        y = y + res.float()
    return y.to(x.dtype)


def fused_scale_relu_matmul_fwd(x, scale, shift, w, res=None):
    """The fused forward in one launch: the value of
    :func:`fused_scale_relu_matmul_plain` up to the order of the sums
    over K.  Takes contiguous f32, bf16 or f16 ``x``/``w``/``res`` (one type)
    and f32 ``scale``/``shift``, any M, K and N; CPU tensors take the
    plain version, CUDA tensors launch the kernel or raise."""
    if on_cpu(_KERNEL, x, scale, shift, w, res):
        return fused_scale_relu_matmul_plain(x, scale, shift, w, res)
    f32 = (torch.float32,)
    check_tensor(_KERNEL, "x", x, dtypes=FLOAT_TYPES, ndim=2)
    M, K = x.shape
    same = (x.dtype,)
    check_tensor(_KERNEL, "w", w, dtypes=same, ndim=2)
    N = w.shape[0]
    check_tensor(_KERNEL, "w", w, dtypes=same, shape=(N, K))
    check_tensor(_KERNEL, "scale", scale, dtypes=f32, shape=(K,))
    check_tensor(_KERNEL, "shift", shift, dtypes=f32, shape=(K,))
    if res is not None:
        check_tensor(_KERNEL, "res", res, dtypes=same, shape=(M, N))
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    lib = _lib()
    err = lib.mx_fused_scale_relu_matmul(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
        None if res is None else res.data_ptr(), y.data_ptr(), M, K, N,
        DTYPE_CODE[x.dtype], x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, _KERNEL, err)
    count_launch(_KERNEL, x.dtype)
    return y
