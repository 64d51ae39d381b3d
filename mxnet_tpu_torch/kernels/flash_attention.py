"""Causal flash attention, forward and backward.

Counterpart of ``mxnet_tpu/ops/nn.py`` ``_flash_attention``, which calls
jax's library Pallas kernel on the TPU (a forward kernel and two
backward kernels, dK/dV and dQ).  The port's kernels are
``csrc/flash_attention.cu`` (design note in the source): causal, with
``scale``, on contiguous head-major ``(B, H, S, D)`` f32, ``D <= 128``,
any ``S``.  The forward also writes each row's log-sum-exp, and the
backward recomputes the probabilities from it; no ``S x S`` tensor is
stored.  ``Dr = rowsum(dO * O)`` is computed in plain PyTorch between
the forward and the backward kernels, as jax's own backward does.

Beside each wrapper is its plain PyTorch version: the CPU path and the
kernel's yardstick on the card.  :func:`flash_attention_plain` is the
materialised masked softmax of ``ops/nn.py`` with autograd's backward,
the reference the tests hold the whole function against.
:class:`FlashAttentionFn` ties the three wrappers into one
``torch.autograd.Function``.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build
from .dispatch import check_tensor, count_launch, count_plain, on_cpu

__all__ = ["flash_attention", "flash_attention_plain", "FlashAttentionFn",
           "flash_attention_fwd", "flash_attention_fwd_plain",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_plain",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_plain"]

_FWD = "flash_attention_fwd"
_DKV = "flash_attention_bwd_dkv"
_DQ = "flash_attention_bwd_dq"
_MAX_D = 128
_F32 = (torch.float32,)


def _lib():
    lib = _build.load("flash_attention")
    if lib.mx_flash_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mx_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, f, i, p]
        lib.mx_flash_fwd.restype = i
        lib.mx_flash_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, i,
                                         p]
        lib.mx_flash_bwd_dkv.restype = i
        lib.mx_flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, f, i, p]
        lib.mx_flash_bwd_dq.restype = i
    return lib


def _check_qkv(kernel, q, k, v):
    check_tensor(kernel, "q", q, dtypes=_F32, ndim=4)
    for name, t in (("k", k), ("v", v)):
        check_tensor(kernel, name, t, dtypes=_F32, shape=q.shape)
    if q.shape[-1] > _MAX_D:
        raise MXNetError("%s: head_dim %d exceeds the kernel's %d"
                         % (kernel, q.shape[-1], _MAX_D))


def _check_grads(kernel, q, dout, lse, delta):
    check_tensor(kernel, "dout", dout, dtypes=_F32, shape=q.shape)
    for name, t in (("lse", lse), ("delta", delta)):
        check_tensor(kernel, name, t, dtypes=_F32, shape=q.shape[:-1])


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _causal_scores(q, k, scale):
    """The masked score matrix (B, H, S, S) in f32."""
    S = q.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    return s.masked_fill(~mask, -1e30)


# ----------------------------------------------------------------------
# the reference
# ----------------------------------------------------------------------
def flash_attention_plain(q, k, v, *, scale):
    """Causal softmax(Q K^T * scale) V by the materialised masked
    softmax (``ops/nn.py``'s XLA path).  Differentiable by autograd."""
    p = torch.softmax(_causal_scores(q, k, scale), dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------
def flash_attention_fwd_plain(q, k, v, *, scale):
    """Plain version of the forward kernel: ``(out, lse)``, the row
    log-sum-exp in f32 with shape ``q.shape[:-1]``."""
    count_plain(_FWD)
    s = _causal_scores(q, k, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse.unsqueeze(-1))
    return torch.matmul(p, v.float()).to(q.dtype), lse


def flash_attention_fwd(q, k, v, *, scale):
    """Causal flash-attention forward on head-major ``(B, H, S, D)``:
    ``(out, lse)``.  CPU tensors take :func:`flash_attention_fwd_plain`;
    CUDA tensors launch the kernel or raise."""
    if on_cpu(_FWD, q, k, v):
        return flash_attention_fwd_plain(q, k, v, scale=scale)
    _check_qkv(_FWD, q, k, v)
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _lib()
    err = lib.mx_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), B * H, S, D,
                           float(scale), q.device.index or 0, _stream(q))
    _build.check(lib, _FWD, err)
    count_launch(_FWD)
    return out, lse


# ----------------------------------------------------------------------
# backward
# ----------------------------------------------------------------------
def _plain_probs_and_ds(q, k, v, dout, lse, delta, scale):
    p = torch.exp(_causal_scores(q, k, scale) - lse.unsqueeze(-1))
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta.unsqueeze(-1))


def flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, *, scale):
    """Plain version of the dK/dV kernel: ``(dk, dv)``."""
    count_plain(_DKV)
    p, ds = _plain_probs_and_ds(q, k, v, dout, lse, delta, scale)
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, *, scale):
    """Plain version of the dQ kernel."""
    count_plain(_DQ)
    _, ds = _plain_probs_and_ds(q, k, v, dout, lse, delta, scale)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, scale):
    """dK and dV of causal flash attention, from the forward's ``lse``
    and ``delta = rowsum(dout * out)``: ``(dk, dv)``.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if on_cpu(_DKV, q, k, v, dout, lse, delta):
        return flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                             scale=scale)
    _check_qkv(_DKV, q, k, v)
    _check_grads(_DKV, q, dout, lse, delta)
    B, H, S, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    lib = _lib()
    err = lib.mx_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               dout.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                               B * H, S, D, float(scale),
                               q.device.index or 0, _stream(q))
    _build.check(lib, _DKV, err)
    count_launch(_DKV)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, scale):
    """dQ of causal flash attention (see :func:`flash_attention_bwd_dkv`).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    if on_cpu(_DQ, q, k, v, dout, lse, delta):
        return flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta,
                                            scale=scale)
    _check_qkv(_DQ, q, k, v)
    _check_grads(_DQ, q, dout, lse, delta)
    B, H, S, D = q.shape
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    lib = _lib()
    err = lib.mx_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              dout.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dq.data_ptr(), B * H, S, D,
                              float(scale), q.device.index or 0, _stream(q))
    _build.check(lib, _DQ, err)
    count_launch(_DQ)
    return dq


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable causal flash attention: the forward kernel, then
    the dK/dV and dQ kernels, which recompute the probabilities from the
    saved log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                         scale=ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                    scale=ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, scale):
    """Causal attention through :class:`FlashAttentionFn` (the ops'
    entry point)."""
    return FlashAttentionFn.apply(q, k, v, float(scale))
