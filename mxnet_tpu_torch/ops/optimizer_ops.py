"""Optimizer update operators, in place, in plain PyTorch.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (``sgd_update``,
``sgd_mom_update``, ``adam_update``; reference
src/operator/optimizer_op.cc), with the same arithmetic: the gradient
is rescaled, clipped when ``clip_gradient >= 0``, and has ``wd *
weight`` added, in that order.  The JAX package returns new arrays; the
port writes the weight and the optimizer state IN PLACE (no gradient is
recorded), which keeps one copy of each in device memory.  The JAX
package has no Pallas kernel for these; they are elementwise passes
that PyTorch runs as they are.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update"]


def _apply_common(grad, weight, rescale_grad, clip_gradient, wd):
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    if wd:
        g = g + wd * weight.float()
    return g


@torch.no_grad()
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """weight -= lr * g."""
    g = _apply_common(grad, weight, rescale_grad, clip_gradient, wd)
    weight.copy_(weight.float() - lr * g)


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """mom = momentum * mom - lr * g; weight += mom."""
    g = _apply_common(grad, weight, rescale_grad, clip_gradient, wd)
    mom.copy_(momentum * mom.float() - lr * g)
    weight.copy_(weight.float() + mom)


@torch.no_grad()
def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Adam with the bias correction folded into ``lr`` by the caller."""
    g = _apply_common(grad, weight, rescale_grad, clip_gradient, wd)
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * g * g)
    weight.copy_(weight.float() - lr * mean / (var.sqrt() + epsilon))
