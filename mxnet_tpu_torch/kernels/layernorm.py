"""Fused LayerNorm forward (+ optional residual add).

Counterpart of ``mxnet_tpu/pallas/layernorm.py`` ``layernorm_fused``
(forward only; the backward kernel comes with the training slice).  The
kernel is ``csrc/layernorm.cu``: one thread block per row, the row
staged once in shared memory, mean and centred variance by block
reductions (design note in the source).  ``layernorm_plain`` is the
same function in plain PyTorch: the CPU path and the kernel's yardstick
on the card.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build
from .dispatch import (DTYPE_CODE, FLOAT_TYPES, check_tensor, count_launch,
                       count_plain, on_cpu)

__all__ = ["layernorm_fused", "layernorm_plain"]

_KERNEL = "layernorm_fused"
_MAX_SMEM = 232448             # bytes of shared memory a block may use


def _lib():
    lib = _build.load("layernorm")
    fn = lib.mx_layernorm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = i
    return lib


def layernorm_plain(x, gamma, beta, *, residual=None, eps=1e-5):
    """LayerNorm over the last axis in plain PyTorch: ``(out, mean,
    rstd)``, out in ``x.dtype``, the per-row stats in f32."""
    count_plain(_KERNEL)
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    mean = xf.mean(dim=-1, keepdim=True)
    d = xf - mean
    rstd = torch.rsqrt((d * d).mean(dim=-1, keepdim=True) + eps)
    out = d * rstd * gamma.float() + beta.float()
    return out.to(x.dtype), mean.squeeze(-1), rstd.squeeze(-1)


def layernorm_fused(x, gamma, beta, *, residual=None, eps=1e-5):
    """Fused LayerNorm over the LAST axis, optionally of ``x +
    residual``.  Returns ``(out, mean, rstd)``: out in ``x.dtype``, the
    stats in f32 with shape ``x.shape[:-1]``.  CPU tensors take
    :func:`layernorm_plain`; CUDA tensors launch the kernel or raise."""
    if on_cpu(_KERNEL, x, gamma, beta, residual):
        return layernorm_plain(x, gamma, beta, residual=residual, eps=eps)
    cols = x.shape[-1]
    check_tensor(_KERNEL, "x", x, dtypes=FLOAT_TYPES)
    check_tensor(_KERNEL, "gamma", gamma, dtypes=FLOAT_TYPES, shape=(cols,))
    check_tensor(_KERNEL, "beta", beta, dtypes=(gamma.dtype,), shape=(cols,))
    if residual is not None:
        check_tensor(_KERNEL, "residual", residual, dtypes=(x.dtype,),
                     shape=x.shape)
    if cols * 4 > _MAX_SMEM:
        raise MXNetError("%s: rows of %d features exceed the kernel's "
                         "shared-memory row buffer" % (_KERNEL, cols))
    lead = x.shape[:-1]
    rows = x.numel() // cols if cols else 0
    out = torch.empty_like(x)
    mean = torch.empty(lead, dtype=torch.float32, device=x.device)
    rstd = torch.empty(lead, dtype=torch.float32, device=x.device)
    if rows == 0:
        return out, mean, rstd
    lib = _lib()
    err = lib.mx_layernorm_fwd(
        x.data_ptr(), residual.data_ptr() if residual is not None else None,
        gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), rows, cols, float(eps), DTYPE_CODE[x.dtype],
        DTYPE_CODE[gamma.dtype], x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, _KERNEL, err)
    count_launch(_KERNEL)
    return out, mean, rstd
