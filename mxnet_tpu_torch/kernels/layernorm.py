"""Fused LayerNorm (+ optional residual add), forward and backward.

Counterpart of ``mxnet_tpu/pallas/layernorm.py`` ``layernorm_fused``.
The kernels are ``csrc/layernorm.cu`` (design notes in the source): the
forward takes one thread block per row; the backward computes dx from
the saved mean and rstd and reduces dgamma/dbeta over all rows in two
deterministic stages (per-block partial sums, then a fixed-order column
sum), so two runs give the same bits.  ``layernorm_plain`` and
``layernorm_bwd_plain`` are the same functions in plain PyTorch: the
CPU path and the kernels' yardsticks on the card.

:class:`LayerNormFn` wraps the two in a ``torch.autograd.Function``
(the counterpart of the JAX package's ``jax.custom_vjp`` pair).  As
there, the cotangents of the mean and rstd outputs are not propagated:
those outputs are marked non-differentiable.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build
from .dispatch import (DTYPE_CODE, FLOAT_TYPES, check_tensor, count_launch,
                       count_plain, on_cpu)

__all__ = ["layernorm_fused", "layernorm_plain", "layernorm_fused_bwd",
           "layernorm_bwd_plain", "LayerNormFn", "layernorm"]

_KERNEL = "layernorm_fused"
_BWD = "layernorm_fused_bwd"
_BWD_BLOCKS = 256              # most row blocks of the backward's stage 1
_MAX_SMEM = 232448             # bytes of shared memory a block may use


def _lib():
    lib = _build.load("layernorm")
    fn = lib.mx_layernorm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = i
        lib.mx_layernorm_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i,
                                         i, i, i, i, p]
        lib.mx_layernorm_bwd.restype = i
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


# ----------------------------------------------------------------------
# backward
# ----------------------------------------------------------------------
def layernorm_bwd_plain(x, gamma, mean, rstd, dy, *, residual=None):
    """The LayerNorm gradient in plain PyTorch, from the saved per-row
    ``mean`` and ``rstd``: ``(dx, dgamma, dbeta)``, dx in ``x.dtype``
    (it is also the residual's gradient), dgamma and dbeta summed over
    every row, in ``gamma.dtype``."""
    count_plain(_BWD)
    cols = x.shape[-1]
    xf = x.reshape(-1, cols).float()
    if residual is not None:
        xf = xf + residual.reshape(-1, cols).float()
    xhat = (xf - mean.reshape(-1, 1)) * rstd.reshape(-1, 1)
    dyf = dy.reshape(-1, cols).float()
    g = dyf * gamma.float()
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = (g * xhat).mean(dim=-1, keepdim=True)
    dx = rstd.reshape(-1, 1) * (g - m1 - xhat * m2)
    return (dx.to(x.dtype).reshape(x.shape),
            (dyf * xhat).sum(dim=0).to(gamma.dtype),
            dyf.sum(dim=0).to(gamma.dtype))


def layernorm_fused_bwd(x, gamma, mean, rstd, dy, *, residual=None):
    """Gradient of :func:`layernorm_fused` with respect to x (and the
    residual: the same tensor), gamma and beta, from the forward's saved
    ``mean`` and ``rstd``.  Returns ``(dx, dgamma, dbeta)``.  CPU tensors
    take :func:`layernorm_bwd_plain`; CUDA tensors launch the kernel's
    two stages (counted as one launch) or raise."""
    if on_cpu(_BWD, x, gamma, mean, rstd, dy, residual):
        return layernorm_bwd_plain(x, gamma, mean, rstd, dy,
                                   residual=residual)
    cols = x.shape[-1]
    rows = x.numel() // cols if cols else 0
    check_tensor(_BWD, "x", x, dtypes=FLOAT_TYPES)
    check_tensor(_BWD, "gamma", gamma, dtypes=FLOAT_TYPES, shape=(cols,))
    check_tensor(_BWD, "dy", dy, dtypes=(x.dtype,), shape=x.shape)
    for name, t in (("mean", mean), ("rstd", rstd)):
        check_tensor(_BWD, name, t, dtypes=(torch.float32,),
                     shape=x.shape[:-1])
    if residual is not None:
        check_tensor(_BWD, "residual", residual, dtypes=(x.dtype,),
                     shape=x.shape)
    if cols * 16 > _MAX_SMEM:
        raise MXNetError("%s: rows of %d features exceed the kernel's "
                         "shared-memory row buffers" % (_BWD, cols))
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(gamma)
    if rows == 0:
        return dx, dgamma.zero_(), dbeta.zero_()
    per_block = -(-rows // _BWD_BLOCKS)
    nblk = -(-rows // per_block)
    part = torch.empty((2, nblk, cols), dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.mx_layernorm_bwd(
        x.data_ptr(), residual.data_ptr() if residual is not None else None,
        gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), part.data_ptr(),
        rows, cols, per_block, DTYPE_CODE[x.dtype], DTYPE_CODE[gamma.dtype],
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, _BWD, err)
    count_launch(_BWD)
    return dx, dgamma, dbeta


class LayerNormFn(torch.autograd.Function):
    """Differentiable fused LayerNorm: the forward kernel, then the
    backward kernel from the saved stats.  ``apply(x, gamma, beta,
    residual, eps)`` returns ``(out, mean, rstd)``; only ``out`` carries
    a gradient (mean and rstd are marked non-differentiable, as the JAX
    package drops their cotangents)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, residual, eps):
        out, mean, rstd = layernorm_fused(x, gamma, beta, residual=residual,
                                          eps=eps)
        ctx.save_for_backward(x, gamma, residual, mean, rstd)
        ctx.mark_non_differentiable(mean, rstd)
        return out, mean, rstd

    @staticmethod
    def backward(ctx, dout, _dmean, _drstd):
        x, gamma, residual, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = layernorm_fused_bwd(
            x, gamma, mean, rstd, dout.contiguous(), residual=residual)
        return (dx, dgamma, dbeta, dx if residual is not None else None,
                None)


def layernorm(x, gamma, beta, *, residual=None, eps=1e-5):
    """:func:`layernorm_fused` made differentiable through
    :class:`LayerNormFn` (the ops' entry point)."""
    return LayerNormFn.apply(x, gamma, beta, residual, float(eps))
