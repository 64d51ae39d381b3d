"""Optimizer update operators, in place, in plain PyTorch.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (``sgd_update``,
``sgd_mom_update``, ``adam_update``, ``signsgd_update``,
``signum_update``, ``rmsprop_update``, ``rmspropalex_update``,
``adagrad_update``, and the multi-precision ``mp_sgd_update`` and
``mp_sgd_mom_update``; reference src/operator/optimizer_op.cc), with the
same arithmetic: the gradient is rescaled, clipped when ``clip_gradient
>= 0``, and has ``wd * weight`` added, in that order (signsgd and
adagrad apply ``wd`` in their own step instead).  The JAX package returns new arrays; the
port writes the weight and the optimizer state IN PLACE (no gradient is
recorded), which keeps one copy of each in device memory.  The JAX
package has no Pallas kernel for these; they are elementwise passes
that PyTorch runs as they are.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update", "signsgd_update",
           "signum_update", "rmsprop_update", "rmspropalex_update",
           "adagrad_update"]


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
def mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """Multi-precision SGD: the f32 master ``weight32 -= lr * g`` (the
    gradient and weight decay taken against the master), then the
    low-precision ``weight`` is the master rounded to its type."""
    g = _apply_common(grad, weight32, rescale_grad, clip_gradient, wd)
    weight32.copy_(weight32 - lr * g)
    weight.copy_(weight32)


@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Multi-precision momentum SGD: ``mom = momentum * mom - lr * g``
    and ``weight32 += mom`` in f32, then ``weight`` is the master
    rounded to its type."""
    g = _apply_common(grad, weight32, rescale_grad, clip_gradient, wd)
    mom.copy_(momentum * mom - lr * g)
    weight32.copy_(weight32 + mom)
    weight.copy_(weight32)


@torch.no_grad()
def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Adam with the bias correction folded into ``lr`` by the caller."""
    g = _apply_common(grad, weight, rescale_grad, clip_gradient, wd)
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * g * g)
    weight.copy_(weight.float() - lr * mean / (var.sqrt() + epsilon))


@torch.no_grad()
def signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """weight -= lr * (sign(g) + wd * weight)."""
    g = _apply_common(grad, weight, rescale_grad, clip_gradient, 0.0)
    weight.copy_(weight.float() - lr * (torch.sign(g) + wd * weight))


@torch.no_grad()
def signum_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """Signum: mom = momentum * mom - (1 - momentum) * g; weight += lr *
    (sign(mom) - wd_lh * weight)."""
    g = _apply_common(grad, weight, rescale_grad, clip_gradient, wd)
    mom.copy_(momentum * mom - (1 - momentum) * g)
    weight.copy_(weight.float() + lr * (torch.sign(mom) - wd_lh * weight))


@torch.no_grad()
def rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """n = (1 - gamma1) * g^2 + gamma1 * n; weight -= lr * g / sqrt(n +
    epsilon), clipped to +-clip_weights when that is positive."""
    g = _apply_common(grad, weight, rescale_grad, clip_gradient, wd)
    n.copy_((1 - gamma1) * g.square() + gamma1 * n)
    new_w = weight.float() - lr * g / torch.sqrt(n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        new_w = new_w.clamp(-clip_weights, clip_weights)
    weight.copy_(new_w)


@torch.no_grad()
def rmspropalex_update(weight, grad, n, g, delta, *, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves): n and g are running means of gr^2 and
    gr; delta = gamma2 * delta - lr * gr / sqrt(n - g^2 + epsilon);
    weight += delta.  ``clip_weights`` is accepted and, as in the
    reference op, not applied."""
    gr = _apply_common(grad, weight, rescale_grad, clip_gradient, wd)
    n.copy_((1 - gamma1) * gr.square() + gamma1 * n)
    g.copy_((1 - gamma1) * gr + gamma1 * g)
    delta.copy_(gamma2 * delta
                - lr * gr / torch.sqrt(n - g.square() + epsilon))
    weight.copy_(weight.float() + delta)


@torch.no_grad()
def adagrad_update(weight, grad, history, *, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """history += g^2; weight -= lr * (g / sqrt(history + epsilon) + wd *
    weight)."""
    g = _apply_common(grad, weight, rescale_grad, clip_gradient, 0.0)
    history.add_(g.square())
    weight.copy_(weight.float()
                 - lr * (g / torch.sqrt(history + epsilon) + wd * weight))
