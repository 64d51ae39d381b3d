"""Fused BatchNorm -> ReLU -> 1x1 Convolution operator.

Counterpart of ``mxnet_tpu/ops/fused.py``: ``symbol/fuse.py``'s pass
rewrites each such triple of a channel-last graph into one
``_FusedBNReluConv`` node, whose big-tensor pass

    y = relu(x * scale + shift) @ W^T  (+ residual)

is one launch of the ``fused_scale_relu_matmul`` kernel
(``kernels/fused_matmul.py``): the per-channel affine (the BatchNorm
apply) and the ReLU happen on the tile the product is about to consume,
so the activation never exists in device memory.  The batch statistics
stay plain PyTorch reductions (``sum`` and ``sum`` of squares), and
``scale``/``shift`` are computed from them and (gamma, beta) by
differentiable tensor ops, so autograd assembles the BatchNorm backward
through the statistics; the autograd Function below supplies only the
big-tensor passes, as the JAX package's custom VJP does.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..kernels import fused_scale_relu_matmul_fwd
from .registry import register

__all__ = ["fused_scale_relu_matmul", "fused_bn_relu_conv"]


class _FusedScaleReluMatmulFn(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU).  Backward: the
    JAX package's ``_core_bwd_rule`` in plain PyTorch, from ``x``, not
    from a saved activation (``z`` is recomputed, as there):

    * ``da = dy @ W``; ``dz = da`` where ``z > 0``, else 0;
    * ``dscale = sum(dz * x)``, ``dshift = sum(dz)`` over rows;
    * ``dx = dz * scale``; ``dW = dy^T @ relu(z)``; ``dres = dy``.

    The products are plain matrix products (``lax.dot_general`` outside
    the Pallas kernel in the JAX package): ``torch.matmul``."""

    @staticmethod
    def forward(ctx, x2d, scale, shift, w, res):
        ctx.save_for_backward(x2d, scale, shift, w)
        ctx.has_res = res is not None
        return fused_scale_relu_matmul_fwd(x2d, scale, shift, w, res)

    @staticmethod
    def backward(ctx, dy):
        x2d, scale, shift, w = ctx.saved_tensors
        da = torch.matmul(dy, w)
        z = x2d.float() * scale + shift
        dz = torch.where(z > 0, da.float(), 0.0)
        dscale = (dz * x2d.float()).sum(0)
        dshift = dz.sum(0)
        dx = (dz * scale).to(x2d.dtype)
        a = torch.relu(z).to(x2d.dtype)
        dw = torch.matmul(dy.t(), a)
        return (dx, dscale.to(scale.dtype), dshift.to(shift.dtype),
                dw.to(w.dtype), dy if ctx.has_res else None)


def fused_scale_relu_matmul(x2d, scale, shift, w, res=None):
    """``relu(x2d * scale + shift) @ w^T (+ res)``, differentiable: x2d
    (M, K); scale, shift (K,) f32; w (N, K), the OHWI weight as stored
    (the JAX function takes its transpose, (K, N)); res (M, N) or
    None."""
    return _FusedScaleReluMatmulFn.apply(x2d, scale, shift, w, res)


def _fused_unused(attrs):
    return set() if attrs.get("with_residual") else {"residual"}


@register("_FusedBNReluConv", num_outputs=3, num_visible_outputs=1,
          mutate_inputs=(("moving_mean", 1), ("moving_var", 2)),
          unused_inputs=_fused_unused)
def fused_bn_relu_conv(data, gamma, beta, moving_mean, moving_var, weight,
                       residual=None, *, num_filter, eps=2e-5, momentum=0.9,
                       fix_gamma=False, use_global_stats=False, layout="NHWC",
                       with_residual=False, is_train=False):
    """BatchNorm -> ReLU -> Convolution(1x1, stride 1, no bias) in one
    kernel launch, channel-last only.  An optional ``residual`` of the
    output's shape is added in the kernel's epilogue (the shortcut add
    of a pre-activation ResNet unit); one that broadcasts is added
    after it.  Returns ``(y, new_moving_mean, new_moving_var)``; in
    training mode (``is_train`` and not ``use_global_stats``) the batch
    statistics normalize and the moving ones move by ``momentum`` as
    BatchNorm's do, otherwise the moving statistics normalize and stay
    as they are.  Made by ``symbol/fuse.py``'s pass; not an op of the
    reference (its parts: batch_norm.cc, activation.cc,
    convolution.cc)."""
    if not str(layout).endswith("C"):
        raise MXNetError("_FusedBNReluConv requires a channel-last layout")
    k = data.shape[-1]
    red = tuple(range(data.dim() - 1))
    eps, momentum = float(eps), float(momentum)
    if is_train and not use_global_stats:
        n = data.numel() // k
        # differentiable statistics: autograd carries the BatchNorm
        # backward through them (the JAX package's jnp sums)
        xf = data.float()
        mean = xf.sum(dim=red) / n
        var = torch.clamp(xf.square().sum(dim=red) / n - mean.square(),
                          min=0.0)
        with torch.no_grad():
            new_mm = (moving_mean.float() * momentum
                      + mean * (1 - momentum)).to(moving_mean.dtype)
            new_mv = (moving_var.float() * momentum
                      + var * (1 - momentum)).to(moving_var.dtype)
    else:
        mean = moving_mean.detach().float()
        var = moving_var.detach().float()
        new_mm, new_mv = moving_mean, moving_var
    inv_std = torch.rsqrt(var + eps)
    g32 = torch.ones_like(inv_std) if fix_gamma else gamma.float()
    scale = g32 * inv_std
    shift = beta.float() - mean * scale

    o = int(num_filter)
    w = weight.reshape(o, k)          # OHWI (O, 1, 1, K) viewed (O, K)
    x2d = data.reshape(-1, k)
    out_shape = tuple(data.shape[:-1]) + (o,)
    res2d = post_add = None
    if with_residual and residual is not None:
        if tuple(residual.shape) == out_shape:
            res2d = residual.reshape(-1, o)
        else:
            post_add = residual
    y = fused_scale_relu_matmul(x2d, scale, shift, w, res2d).reshape(out_shape)
    if post_add is not None:
        y = y + post_add
    return y, new_mm, new_mv
