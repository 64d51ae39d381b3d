"""Neural-network operators of the serving, training and vision slices.

Counterpart of ``mxnet_tpu/ops/nn.py`` for the ops the transformer's
mixed decode step and training symbol and the LeNet and ResNet symbols
use, with the same layouts (NCHW data with (num_filter, C / groups, kh,
kw) convolution weights, or NHWC data with (num_filter, kh, kw,
C / groups) weights).  The projections, the FFN and the
convolutions are plain PyTorch calls (``torch.matmul``,
``F.conv2d``: the JAX package left them to XLA, in no Pallas kernel);
LayerNorm, the causal training attention and the three paged attentions
go through the hand-written kernels in ``..kernels``, which take the
plain PyTorch versions only for tensors on the CPU.  Gradients are
autograd's, with ``torch.autograd.Function``s where the JAX package had
a custom VJP (LayerNorm, flash attention, SoftmaxOutput, BatchNorm).
Dropout is a mask draw (:func:`dropout_mask`, from the walk's step seed,
``random.keep_mask``) and a mask apply (:func:`dropout_apply`);
LeakyReLU's ``rrelu`` draws its slopes from the same seed
(:func:`rrelu_slopes`).  Deconvolution is ``F.conv_transpose{1,2,3}d``
(the JAX package computes it outside Pallas too).  ``L2Normalization``
and ``LRN`` (SSD's conv4_3 source, AlexNet) are plain passes, as the
JAX ops are plain jnp.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import LOW_PRECISION, MXNetError
from ..kernels import (flash_attention, layernorm, paged_chunk_prefill_attend,
                       paged_decode_attend, paged_prefill_attend)
from .registry import register


def _tuple(v, n):
    """An int or int sequence as an ``n``-tuple (``()`` gives ones)."""
    if isinstance(v, (tuple, list)):
        t = tuple(int(x) for x in v)
        return t if t else (1,) * n
    return (int(v),) * n


def _channel_last(layout):
    return layout is not None and str(layout).endswith("C")


def _channel_last_call(fn, *tensors, **attrs):
    """``fn`` (a channels-first op) on channel-last tensors, by views:
    each tensor's last axis moved to axis 1, which for contiguous NHWC
    data or OHWI weights is PyTorch's channels_last layout, with no
    copy; the convolution and pooling kernels take that layout as it
    is and return it, and the result is moved back, again a view.  The
    JAX package's design has no relayout copy anywhere in the step, so
    nothing here makes a tensor contiguous."""
    out = fn(*[t if t is None or t.dim() == 1 else t.movedim(-1, 1)
               for t in tensors], **attrs)
    return out.movedim(1, -1)


def _linear(x, weight, bias=None):
    """``x W^T + b`` with the reference's (num_hidden, in_dim) weight."""
    y = torch.matmul(x, weight.t())
    return y if bias is None else y + bias


@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(data, weight, bias=None, *, num_hidden, no_bias=False,
                    flatten=True):
    """y = x W^T + b (ref src/operator/nn/fully_connected-inl.h)."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    return _linear(x, weight, None if no_bias else bias)


@register("LayerNorm", aliases=("layer_norm",), num_outputs=3,
          num_visible_outputs=lambda a: 3 if a.get("output_mean_var") else 1)
def layer_norm(data, gamma, beta, *, axis=-1, eps=1e-5,
               output_mean_var=False):
    """Layer normalization over the last axis through the fused kernels
    (``kernels/layernorm.py``), differentiable through
    ``LayerNormFn``.  Returns ``(out, mean, inv_std)``; gradients flow
    through ``out`` only."""
    if int(axis) % data.dim() != data.dim() - 1:
        raise MXNetError("LayerNorm over a non-last axis is not in the "
                         "PyTorch port yet (axis=%s)" % (axis,))
    return layernorm(data.contiguous(), gamma.reshape(-1), beta.reshape(-1),
                     eps=float(eps))


@register("InstanceNorm")
def instance_norm(data, gamma, beta, *, eps=1e-3):
    """Normalize each sample and channel over its spatial axes (ref
    src/operator/instance_norm.cc; the biased variance)."""
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = (data - mean).square().mean(dim=red, keepdim=True)
    out = (data - mean) * torch.rsqrt(var + float(eps))
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


@register("L2Normalization")
def l2_normalization(data, *, eps=1e-10, mode="instance"):
    """``data`` over its L2 norm, ``eps`` inside the square root (ref
    src/operator/l2_normalization.cc): across every axis but the batch
    (``instance``), across the channels at each position (``channel``),
    or across the positions of each channel (``spatial``)."""
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    elif mode == "spatial":
        red = tuple(range(2, data.dim()))
    else:
        raise MXNetError("L2Normalization: unknown mode %r" % (mode,))
    return data / torch.sqrt(data.square().sum(dim=red, keepdim=True)
                             + float(eps))


@register("LRN")
def lrn(data, *, nsize, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalization across channels (ref
    src/operator/nn/lrn.cc): ``data * (knorm + alpha * S / nsize) **
    -beta``, S the sum of squares over a window of ``nsize`` channels
    centred on each (zeros past the edges)."""
    nsize = int(nsize)
    if nsize % 2 != 1:
        raise MXNetError("LRN: nsize must be odd, got %d" % nsize)
    half = nsize // 2
    sq = data.square().reshape(data.shape[0], 1, data.shape[1], -1)
    summed = F.avg_pool2d(sq, (nsize, 1), stride=1, padding=(half, 0),
                          divisor_override=1).reshape(data.shape)
    return data * torch.pow(float(knorm) + float(alpha) * summed / nsize,
                            -float(beta))


@register("Flatten", aliases=("flatten",))
def flatten(data):
    """(N, ...) -> (N, prod(...)) (ref src/operator/tensor/matrix_op.cc)."""
    return data.reshape(data.shape[0], -1)


# ----------------------------------------------------------------------
# Convolution
# ----------------------------------------------------------------------
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", aliases=("convolution",))
def convolution(data, weight, bias=None, *, kernel, num_filter, stride=(),
                dilate=(), pad=(), num_group=1, no_bias=False, cudnn_tune=None,
                cudnn_off=False, workspace=1024, layout=None):
    """1-, 2- or 3-D convolution (ref src/operator/nn/convolution.cc),
    with groups, dilation and symmetric padding; the bias, when there is
    one, is added per output channel.  Channels-first data takes
    (num_filter, C / groups, *kernel) weights; a channel-last ``layout``
    (NWC, NHWC, NDHWC) takes channel-last data and (num_filter, *kernel,
    C / groups) weights, as the JAX package's ``_conv_dnums`` pairs
    them."""
    if _channel_last(layout):
        return _channel_last_call(convolution, data, weight, bias,
                                  kernel=kernel, num_filter=num_filter,
                                  stride=stride, dilate=dilate, pad=pad,
                                  num_group=num_group, no_bias=no_bias)
    nd = len(kernel)
    if nd not in _CONV or data.dim() != nd + 2:
        raise MXNetError("Convolution: a %d-D kernel over %d-D data is not "
                         "in the PyTorch port" % (nd, data.dim()))
    conv = partial(_CONV[nd], stride=_tuple(stride, nd),
                   padding=_tuple(pad or 0, nd), dilation=_tuple(dilate, nd),
                   groups=int(num_group))
    bias = None if no_bias else bias
    if data.dtype == torch.float16 and data.device.type == "cpu":
        # cuDNN's f16 convolutions sum in f32 and round each result once,
        # forward and backward; PyTorch's CPU f16 backward adds the
        # overlapping windows' input gradients in f16 (and takes seconds
        # at ResNet's sizes), so the CPU computes the same f32 sums
        # through casts that autograd follows back, rounding once
        up = [None if t is None else t.float() for t in (data, weight, bias)]
        return conv(*up).to(torch.float16)
    return conv(data, weight, bias)


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution", aliases=("deconvolution",),
          unused_inputs=lambda a: ("bias",) if a.get("no_bias", True)
          else ())
def deconvolution(data, weight, bias=None, *, kernel, num_filter, stride=(),
                  dilate=(), pad=(), adj=(), target_shape=(), num_group=1,
                  no_bias=True, cudnn_tune=None, cudnn_off=False,
                  workspace=512, layout=None):
    """1-, 2- or 3-D transposed convolution (ref
    src/operator/nn/deconvolution.cc; the JAX package's
    ``mxnet_tpu/ops/nn.py`` ``deconvolution``): channels-first data and
    (C, num_filter / groups, *kernel) weights, the output
    ``(in - 1) * stride - 2 * pad + dilate * (kernel - 1) + 1 + adj``
    wide, the bias (when ``no_bias`` is False) added per output channel.
    ``target_shape`` and ``layout`` are accepted and change nothing, as
    in the JAX package."""
    nd = len(kernel)
    if nd not in _CONV_T or data.dim() != nd + 2:
        raise MXNetError("Deconvolution: a %d-D kernel over %d-D data is "
                         "not in the PyTorch port" % (nd, data.dim()))
    deconv = partial(_CONV_T[nd], stride=_tuple(stride, nd),
                     padding=_tuple(pad or 0, nd),
                     output_padding=_tuple(adj or 0, nd),
                     groups=int(num_group), dilation=_tuple(dilate, nd))
    bias = None if no_bias else bias
    if data.dtype == torch.float16 and data.device.type == "cpu":
        # as Convolution: f32 sums rounded once, as cuDNN gives them
        up = [None if t is None else t.float() for t in (data, weight, bias)]
        return deconv(*up).to(torch.float16)
    return deconv(data, weight, bias)


# ----------------------------------------------------------------------
# BatchNorm: the JAX package's _bn_train_fused, statistics and backward
# ----------------------------------------------------------------------
class _BatchNormTrainFn(torch.autograd.Function):
    """Training-mode batch norm with the JAX package's arithmetic
    (``_bn_train_fused``): the statistics are ``sum(x)`` and
    ``sum(x^2)`` in f32, ``var = max(E[x^2] - mean^2, 0)`` (biased);
    the output is ``x * scale + shift`` per channel.  The backward is the
    hand-derived one: two channel sums of ``dy`` and ``dy * x``, then
    ``dx = dy * scale + x * b + c`` per channel.  Returns ``(out, mean,
    var)``; mean and var take no cotangent.  (Not ``F.batch_norm``: it
    computes the variance another way and keeps an unbiased running
    variance.)"""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, fix_gamma, red, bshape, n):
        xf = x.float()
        mean = xf.sum(dim=red) / n
        var = torch.clamp(xf.square().sum(dim=red) / n - mean.square(),
                          min=0.0)
        inv_std = torch.rsqrt(var + eps)
        g32 = torch.ones_like(inv_std) if fix_gamma else gamma.float()
        scale = g32 * inv_std
        shift = beta.float() - mean * scale
        out = (xf * scale.view(bshape) + shift.view(bshape)).to(x.dtype)
        ctx.save_for_backward(x, mean, inv_std, g32)
        ctx.fix_gamma, ctx.red, ctx.bshape, ctx.n = fix_gamma, red, bshape, n
        ctx.gamma_dtype = gamma.dtype
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv_std, g32 = ctx.saved_tensors
        red, bshape, n = ctx.red, ctx.bshape, ctx.n
        dyf, xf = dy.float(), x.float()
        t1 = dyf.sum(dim=red)
        t2 = (dyf * xf).sum(dim=red)
        dgamma = (t2 - mean * t1) * inv_std
        dbeta = t1
        scale = g32 * inv_std
        bcoef = -scale * inv_std * dgamma / n
        ccoef = (scale * inv_std * dgamma * mean - scale * dbeta) / n
        dx = (dyf * scale.view(bshape) + xf * bcoef.view(bshape)
              + ccoef.view(bshape)).to(x.dtype)
        if ctx.fix_gamma:
            dgamma = torch.zeros_like(dgamma)
        return (dx, dgamma.to(ctx.gamma_dtype), dbeta.to(ctx.gamma_dtype),
                None, None, None, None, None)


@register("BatchNorm", aliases=("batch_norm", "CuDNNBatchNorm"),
          num_outputs=5,
          num_visible_outputs=lambda a: 3 if a.get("output_mean_var") else 1,
          mutate_inputs=(("moving_mean", 3), ("moving_var", 4)))
def batch_norm(data, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               is_train=False):
    """Batch normalization over every axis but ``axis`` (ref
    src/operator/nn/batch_norm.cc).  Returns ``(out, mean, inv_std,
    new_moving_mean, new_moving_var)``; the executor writes the last two
    into the moving statistics after a train forward.  Training mode
    (``is_train`` and not ``use_global_stats``) normalizes with the
    batch statistics through :class:`_BatchNormTrainFn` and moves the
    statistics by ``momentum`` in f32 (the biased variance); otherwise
    the moving statistics normalize and stay as they are.
    ``fix_gamma`` uses a scale of one and gives gamma a zero
    gradient."""
    ax = int(axis) % data.dim()
    red = tuple(i for i in range(data.dim()) if i != ax)
    bshape = tuple(data.shape[i] if i == ax else 1 for i in range(data.dim()))
    eps, momentum = float(eps), float(momentum)
    if is_train and not use_global_stats:
        n = float(data.numel() // data.shape[ax])    # elements per channel
        out, mean, var = _BatchNormTrainFn.apply(
            data, gamma, beta, eps, bool(fix_gamma), red, bshape, n)
        with torch.no_grad():
            inv_std = torch.rsqrt(var + eps)
            new_mm = (moving_mean.float() * momentum
                      + mean * (1 - momentum)).to(moving_mean.dtype)
            new_mv = (moving_var.float() * momentum
                      + var * (1 - momentum)).to(moving_var.dtype)
        return out, mean, inv_std, new_mm, new_mv
    mean = moving_mean.detach().float()
    var = moving_var.detach().float()
    inv_std = torch.rsqrt(var + eps)
    g32 = torch.ones_like(inv_std) if fix_gamma else gamma.float()
    scale = g32 * inv_std
    shift = beta.float() - mean * scale
    out = (data.float() * scale.view(bshape)
           + shift.view(bshape)).to(data.dtype)
    return out, mean, inv_std, moving_mean, moving_var


# ----------------------------------------------------------------------
# Pooling
# ----------------------------------------------------------------------
_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling", aliases=("pooling",))
def pooling(data, *, kernel=(), pool_type="max", global_pool=False,
            stride=(), pad=(), pooling_convention="valid", cudnn_off=False,
            count_include_pad=True, p_value=2, layout=None):
    """Max, average or sum pooling over 1-, 2- or 3-D data, channels first
    or, with a channel-last ``layout``, channel last (ref
    src/operator/nn/pooling.cc).  ``pooling_convention='full'``
    rounds the output size up, padding the far edge as needed.  The
    padding is explicit (``-inf`` for max, zeros otherwise), so every
    window is a whole kernel: ``avg`` divides by the kernel size, or,
    without ``count_include_pad``, by its count of real elements.  The
    max-pool gradient goes to the first maximum of each window in
    row-major order, as XLA's select-and-scatter gives it (ties are
    common: ReLU outputs tie at 0)."""
    if _channel_last(layout):
        return _channel_last_call(
            pooling, data, kernel=kernel, pool_type=pool_type,
            global_pool=global_pool, stride=stride, pad=pad,
            pooling_convention=pooling_convention,
            count_include_pad=count_include_pad)
    nd = data.dim() - 2
    if nd == 1 and not global_pool:
        # 1-D as 2-D over a unit height
        return pooling(
            data.unsqueeze(2), kernel=(1,) + _tuple(kernel, 1),
            pool_type=pool_type, stride=(1,) + _tuple(stride, 1),
            pad=(0,) + _tuple(pad or 0, 1),
            pooling_convention=pooling_convention,
            count_include_pad=count_include_pad).squeeze(2)
    if global_pool:
        red = tuple(range(2, 2 + nd))
        if pool_type == "max":
            return data.amax(dim=red, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=red, keepdim=True)
        return data.mean(dim=red, keepdim=True)
    if nd not in _MAX_POOL:
        raise MXNetError("Pooling over %d-D data is not in the PyTorch port"
                         % data.dim())
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError("Pooling pool_type=%r is not in the PyTorch port"
                         % (pool_type,))
    kernel = _tuple(kernel, nd)
    stride = _tuple(stride, nd)
    pad = _tuple(pad or 0, nd)
    lo_hi = []
    for i in range(nd):
        hi = pad[i]
        if pooling_convention == "full":
            size = data.shape[2 + i] + 2 * pad[i]
            out_sz = -(-(size - kernel[i]) // stride[i]) + 1
            hi += max(0, (out_sz - 1) * stride[i] + kernel[i] - size)
        lo_hi.append((pad[i], hi))
    # F.pad takes (lo, hi) pairs from the last axis back
    fpad = [p for pair in reversed(lo_hi) for p in pair]
    if pool_type == "max":
        x = F.pad(data, fpad, value=float("-inf")) if any(fpad) else data
        return _MAX_POOL[nd](x, kernel, stride)
    x = F.pad(data, fpad) if any(fpad) else data
    summed = _AVG_POOL[nd](x, kernel, stride, divisor_override=1)
    if pool_type == "sum":
        return summed
    if count_include_pad:
        denom = 1
        for k in kernel:
            denom *= k
        return summed / denom
    ones = torch.ones_like(data)
    counts = _AVG_POOL[nd](F.pad(ones, fpad) if any(fpad) else ones, kernel,
                           stride, divisor_override=1)
    return summed / counts


# ----------------------------------------------------------------------
# Activations
# ----------------------------------------------------------------------
_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign}


@register("Activation", aliases=("activation",))
def activation(data, *, act_type):
    """relu, sigmoid, tanh, softrelu (softplus) or softsign (ref
    src/operator/nn/activation.cc)."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise MXNetError("unknown act_type %s" % act_type)
    return fn(data)


def _weak(v, dtype):
    """The Python scalar ``v`` rounded to ``dtype``, as the JAX package's
    weakly typed constants meet a tensor of that type (in bf16, 1.6733
    enters a product as 1.671875)."""
    return float(torch.tensor(float(v), dtype=dtype))


# the SELU constants of the reference (Klambauer et al. 2017)
_SELU_ALPHA, _SELU_LAMBDA = 1.6732632423543772, 1.0507009873554805


def rrelu_slopes(data, lower_bound, upper_bound, rng=None):
    """The slopes of one ``rrelu`` draw in training: one per element of
    ``data``, uniform on ``[lower_bound, upper_bound)`` in float32
    (``random.uniform``, counter-based from ``rng``'s step seed and next
    site, or a fresh seed of the device's generator when ``rng`` is
    None), rounded to ``data``'s type."""
    if rng is None:
        seed, site = _random.next_seed(data.device), 0
    else:
        seed, site = rng.next()
    return _random.uniform(seed, site, data.shape, lower_bound, upper_bound,
                           data.device).to(data.dtype)


def _leaky_unused(attrs):
    return () if attrs.get("act_type") == "prelu" else ("gamma",)


@register("LeakyReLU", unused_inputs=_leaky_unused,
          draws=lambda a: a.get("act_type") == "rrelu")
def leaky_relu(data, gamma=None, *, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, is_train=False,
               rng=None):
    """leaky, prelu, elu, selu, gelu and rrelu (ref
    src/operator/leaky_relu.cc; ``mxnet_tpu/ops/nn.py`` ``leaky_relu``),
    and the tanh-approximated GELU (``gelu_tanh``, the GPT-2 convention
    the transformer uses).  ``prelu`` takes the learned per-channel
    ``gamma`` (axis 1); ``elu`` is ``slope * expm1(x)`` below 0; ``selu``
    ``lambda * (x or alpha * expm1(x))``; ``gelu`` the erf form;
    ``rrelu`` in training multiplies each negative element by its own
    slope, drawn uniform on ``[lower_bound, upper_bound)`` from the
    walk's step seed (:func:`rrelu_slopes`: a captured graph draws anew
    on each replay, and the card and the CPU draw the same slopes), and
    outside training by ``(lower_bound + upper_bound) / 2``.  Constants
    meet the data in its own type, as the JAX package's do.  In bf16 and
    f16, prelu, elu, selu and gelu compute in f32 and round once,
    forward and backward (autograd follows the casts): the JAX package
    rounds after each of its steps, and its f16 ``expm1`` is off by an
    ulp, which the gradient's ``expm1(x) + 1`` magnifies."""
    dt = data.dtype
    if dt in LOW_PRECISION and act_type in ("prelu", "elu", "selu", "gelu"):
        return leaky_relu(data.float(),
                          None if gamma is None else gamma.float(),
                          act_type=act_type, slope=slope).to(dt)
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 else gamma
        return torch.where(data > 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data, _weak(slope, dt) * data.expm1())
    if act_type == "selu":
        neg = _weak(_SELU_ALPHA, dt) * data.expm1()
        return _weak(_SELU_LAMBDA, dt) * torch.where(data > 0, data, neg)
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "gelu_tanh":
        return F.gelu(data, approximate="tanh")
    if act_type == "rrelu":
        s = rrelu_slopes(data, lower_bound, upper_bound, rng) if is_train \
            else _weak((lower_bound + upper_bound) / 2.0, dt)
        return torch.where(data > 0, data, s * data)
    raise MXNetError("unknown act_type %s" % act_type)


# ----------------------------------------------------------------------
# Dropout (ref src/operator/nn/dropout-inl.h; mxnet_tpu/ops/nn.py:572)
# ----------------------------------------------------------------------
def dropout_scale(p, dtype):
    """``1 / (1 - p)`` as the reference's mask holds it: 1 divided by
    ``1 - p`` rounded to ``dtype``, in ``dtype`` (in bf16, 1/0.9 comes
    out of bf16(0.9), not of 0.9), as a Python float."""
    one = torch.ones((), dtype=dtype)
    return float(one / torch.tensor(1.0 - float(p), dtype=dtype))


def dropout_mask(data, p, axes=(), rng=None):
    """The scaled mask of one Dropout draw: ``bernoulli(1 - p)`` in
    ``data``'s type times :func:`dropout_scale`, values exactly 0 or
    that scale, of ``data``'s shape with size 1 on ``axes`` (broadcast
    by the apply).  Drawn from ``rng``'s step seed and next site
    (``random.StepRandom``), or from a fresh seed of the device's
    generator when ``rng`` is None (an imperative call)."""
    axes = tuple(int(a) % data.dim() for a in (axes or ()))
    shape = tuple(1 if i in axes else s for i, s in enumerate(data.shape))
    if rng is None:
        seed, site = _random.next_seed(data.device), 0
    else:
        seed, site = rng.next()
    keep = _random.keep_mask(seed, site, shape, 1.0 - float(p), data.device)
    return keep.to(data.dtype) * dropout_scale(p, data.dtype)


def dropout_apply(data, mask):
    """``data * mask`` in ``data``'s type (the mask broadcast over its
    size-1 axes); autograd's backward is ``grad * mask``."""
    return data * mask


@register("Dropout", aliases=("dropout",), num_outputs=2,
          num_visible_outputs=1)
def dropout(data, *, p=0.5, mode="training", axes=(), cudnn_off=False,
            is_train=False, rng=None):
    """Inverted dropout: outputs ``(data * mask, mask)`` with the mask
    (invisible) broadcast to ``data``'s shape; the identity with a mask
    of ones when ``p <= 0`` or when not training and ``mode`` is not
    ``'always'``.  ``cudnn_off`` is accepted and changes nothing."""
    p = float(p)
    if p <= 0.0 or (not is_train and mode != "always"):
        return data, data.new_ones(()).expand(data.shape)
    mask = dropout_mask(data, p, axes, rng)
    return dropout_apply(data, mask), mask.expand(data.shape)


@register("Embedding")
def embedding(data, weight, *, input_dim, output_dim, dtype="float32",
              sparse_grad=False):
    """Row gather with ids clipped into range (ref indexing_op.cc)."""
    return weight[data.long().clamp(0, weight.shape[0] - 1)]


# ----------------------------------------------------------------------
# SoftmaxOutput: softmax forward, the reference's fused softmax +
# cross-entropy gradient backward (src/operator/softmax_output-inl.h)
# ----------------------------------------------------------------------
def _softmax_grad(prob, label, attrs):
    """``ops/nn.py`` ``_softmax_grad`` of the JAX package: (prob -
    one_hot(label)) with label smoothing, ignored labels masked, then
    normalised by ``null`` (1), ``batch`` (prob.shape[0]) or ``valid``
    (the count of labels not ignored), times ``grad_scale``."""
    if attrs["multi_output"]:
        caxis, nclass = 1, prob.shape[1]
    else:
        caxis, nclass = prob.dim() - 1, prob.shape[-1]
    lab = label.long()
    oh = F.one_hot(lab.clamp(0, nclass - 1), nclass).to(prob.dtype)
    # out-of-range labels (the ignore label -1) one-hot to zeros, as
    # jax.nn.one_hot gives
    oh = oh * ((lab >= 0) & (lab < nclass)).unsqueeze(-1).to(prob.dtype)
    if attrs["multi_output"]:
        oh = oh.movedim(-1, 1)
    alpha = attrs["smooth_alpha"]
    if alpha:
        oh = oh * (1.0 - alpha) + alpha / (nclass - 1) * (1.0 - oh)
    grad = prob - oh
    valid = torch.ones(lab.shape, dtype=prob.dtype, device=prob.device)
    if attrs["use_ignore"]:
        valid = (lab != int(attrs["ignore_label"])).to(prob.dtype)
        grad = grad * valid.unsqueeze(caxis)
    if attrs["normalization"] == "valid":
        grad = grad / torch.clamp(valid.sum(), min=1.0)
    elif attrs["normalization"] == "batch":
        grad = grad / prob.shape[0]
    return grad * attrs["grad_scale"]


class _SoftmaxOutputFn(torch.autograd.Function):
    """Softmax forward; the backward ignores the incoming gradient and
    returns ``_softmax_grad`` (as the reference does unless
    ``out_grad``)."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        prob = torch.softmax(data, dim=1 if attrs["multi_output"] else -1)
        ctx.save_for_backward(prob, label)
        ctx.attrs = attrs
        return prob

    @staticmethod
    def backward(ctx, _grad):
        prob, label = ctx.saved_tensors
        return _softmax_grad(prob, label, ctx.attrs).to(prob.dtype), None, \
            None


@register("SoftmaxOutput", aliases=("Softmax",))
def softmax_output(data, label, *, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax over the last axis (axis 1 with ``multi_output``), with
    the fused softmax + cross-entropy gradient as its backward."""
    if out_grad:
        raise MXNetError("SoftmaxOutput(out_grad=True) is not in the "
                         "PyTorch port yet")
    if normalization not in ("null", "batch", "valid"):
        raise MXNetError("SoftmaxOutput: unknown normalization %r"
                         % (normalization,))
    attrs = dict(grad_scale=float(grad_scale),
                 ignore_label=float(ignore_label),
                 multi_output=bool(multi_output), use_ignore=bool(use_ignore),
                 normalization=normalization, smooth_alpha=float(smooth_alpha))
    return _SoftmaxOutputFn.apply(data, label, attrs)


# ----------------------------------------------------------------------
# Regression outputs (ref src/operator/regression_output-inl.h): the
# forward's identity or sigmoid, and ``(out - label) * grad_scale /
# batch`` (the sign of the difference for MAE) as the backward
# ----------------------------------------------------------------------
class _RegressionOutputFn(torch.autograd.Function):
    """``fwd(data)``; the backward ignores the incoming gradient and
    returns ``grad(out - label) * grad_scale / batch`` (the label takes
    none), as the JAX package's custom VJPs do."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad, grad_scale):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.grad, ctx.grad_scale = grad, grad_scale
        return out

    @staticmethod
    def backward(ctx, _grad):
        out, label = ctx.saved_tensors
        g = ctx.grad(out - label.reshape(out.shape)) * ctx.grad_scale \
            / out.shape[0]
        return g.to(out.dtype), None, None, None, None


def _identity(t):
    return t


@register("LinearRegressionOutput")
def linear_regression_output(data, label, *, grad_scale=1.0):
    """The identity, with the squared loss's gradient."""
    return _RegressionOutputFn.apply(data, label, _identity, _identity,
                                     float(grad_scale))


@register("MAERegressionOutput")
def mae_regression_output(data, label, *, grad_scale=1.0):
    """The identity, with the absolute loss's gradient (the sign)."""
    return _RegressionOutputFn.apply(data, label, _identity, torch.sign,
                                     float(grad_scale))


@register("LogisticRegressionOutput")
def logistic_regression_output(data, label, *, grad_scale=1.0):
    """The sigmoid, with the logistic loss's gradient."""
    return _RegressionOutputFn.apply(data, label, torch.sigmoid, _identity,
                                     float(grad_scale))


# ----------------------------------------------------------------------
# Causal self-attention of the training symbol
# ----------------------------------------------------------------------
@register("_contrib_CausalSelfAttention", aliases=("CausalSelfAttention",))
def causal_self_attention(qkv, *, num_heads, scale=None):
    """Causal multi-head self-attention over a packed QKV tensor, (B, S,
    3 * d) -> (B, S, d) (``mxnet_tpu/ops/nn.py`` ``causal_self_attention``):
    q, k and v are the thirds of the last axis (``jnp.split``), each
    (B, S, H, D) viewed head-major, through the flash kernels (row 8's
    forward, dK/dV and dQ, ``kernels.flash_attention``), with the scale
    ``1 / sqrt(D)`` unless given.  The kernels keep the scores in f32;
    the JAX package's path off the TPU rounds them to the input type
    before its f32 softmax, so 16-bit results differ by that rounding
    (ROADMAP C)."""
    B, S, d3 = qkv.shape
    if d3 % 3:
        raise MXNetError("CausalSelfAttention: the last axis (%d) is not "
                         "three equal parts q|k|v" % d3)
    d = d3 // 3
    H, D, sc = _heads(d, num_heads, scale)
    q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4).contiguous() \
        .unbind(0)
    o = flash_attention(q, k, v, scale=sc)                  # (B, H, S, D)
    return o.transpose(1, 2).reshape(B, S, d)


@register("_contrib_FusedCausalSelfAttention",
          aliases=("FusedCausalSelfAttention",))
def fused_causal_self_attention(data, qkv_weight, qkv_bias, proj_weight,
                                proj_bias, *, num_heads, scale=None,
                                head_axis=None):
    """The whole attention sublayer, (B, S, d) -> (B, S, d): the packed
    (3d, d) QKV projection viewed head-major (rows ``[j*d, (j+1)*d)``
    are q/k/v, each ordered (head, head_dim), the JAX op's
    ``qkv_weight.reshape(3, H, D, d)``), causal attention through the
    flash kernels on (B, H, S, D), and the (d, d) output projection.
    ``head_axis`` (tensor parallelism) comes with the multi-GPU
    slice."""
    if head_axis is not None:
        raise MXNetError("FusedCausalSelfAttention(head_axis=%r): tensor "
                         "parallelism comes with the multi-GPU slice of the "
                         "PyTorch port" % (head_axis,))
    B, S, d = data.shape
    H, D, sc = _heads(d, num_heads, scale)
    qkv = _linear(data, qkv_weight, qkv_bias).view(B, S, 3, H, D)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
    o = flash_attention(q, k, v, scale=sc)                  # (B, H, S, D)
    return _linear(o.transpose(1, 2).reshape(B, S, d), proj_weight,
                   proj_bias)


# ----------------------------------------------------------------------
# Paged-KV-cache attention (the decode engine's two attention ops)
# ----------------------------------------------------------------------
def _split_qkv(x, qkv_weight, qkv_bias, H):
    """The packed (3d, d) qkv projection viewed head-major: rows
    ``[j*d, (j+1)*d)`` of the weight are q/k/v, each ordered (head,
    head_dim), as ``_paged_qkv_weights`` reads them in the JAX package.
    Returns contiguous ``(..., H, D)`` q, k, v."""
    d = x.shape[-1]
    qkv = _linear(x, qkv_weight, qkv_bias)
    lead = x.shape[:-1]
    return [qkv[..., i * d:(i + 1) * d].reshape(*lead, H, d // H)
            .contiguous() for i in range(3)]


def _heads(d, num_heads, scale):
    H = int(num_heads)
    if d % H:
        raise MXNetError("d_model %d not divisible by num_heads %d" % (d, H))
    D = d // H
    return H, D, (1.0 / D ** 0.5) if scale is None else float(scale)


@register("_contrib_PagedDecodeAttention",
          aliases=("PagedDecodeAttention",), num_outputs=3)
def paged_decode_attention(data, qkv_weight, qkv_bias, proj_weight,
                           proj_bias, k_cache, v_cache, block_table,
                           positions, *, num_heads, scale=None):
    """One decode step over a paged KV cache.

    data (C, 1, d): current-token hidden states of C batch slots;
    caches (num_blocks, block_size, H, D); block_table (C, M);
    positions (C, 1), < 0 marks an inactive slot (nothing written, its
    output is zeros the engine masks).  The current token's K/V rows are
    written into the caches IN PLACE, then the decode kernel attends
    over rows 0..position.  Returns (attn_out (C, 1, d), k_cache,
    v_cache), the caches being the input tensors themselves."""
    C, _, d = data.shape
    H, D, sc = _heads(d, num_heads, scale)
    q, k, v = _split_qkv(data.reshape(C, d), qkv_weight, qkv_bias, H)

    nb, bs = k_cache.shape[0], k_cache.shape[1]
    kf = k_cache.view(nb * bs, H, D)
    vf = v_cache.view(nb * bs, H, D)
    pos = positions.reshape(C).long()
    table = block_table.long()
    blk = (pos // bs).clamp(0, table.shape[1] - 1)
    widx = table.gather(1, blk[:, None])[:, 0] * bs + pos % bs
    # Inactive slots must write nothing, without a host sync to find
    # them: each one repeats the first active slot's write (same row,
    # same bytes), or, when no slot is active, rewrites one row with its
    # own bytes.  Duplicate indices then always carry equal values.
    # (index_select, not t[src]: a 0-d index tensor would sync.)
    active = pos >= 0
    src = active.int().argmax().reshape(1)
    widx = torch.where(active, widx, widx.index_select(0, src))
    any_active = active.any()
    for cache, new in ((kf, k), (vf, v)):
        new = new.to(cache.dtype)
        fill = torch.where(any_active, new.index_select(0, src),
                           cache.index_select(0, widx.index_select(0, src)))
        cache.index_copy_(0, widx, torch.where(active[:, None, None], new,
                                               fill))

    o = paged_decode_attend(q, k_cache, v_cache,
                            block_table.to(torch.int32),
                            pos.to(torch.int32), scale=sc)
    out = _linear(o.reshape(C, d), proj_weight, proj_bias)
    return out.reshape(C, 1, d), k_cache, v_cache


@register("_contrib_PagedChunkPrefillAttention",
          aliases=("PagedChunkPrefillAttention",), num_outputs=3)
def paged_chunk_prefill_attention(data, qkv_weight, qkv_bias,
                                  proj_weight, proj_bias, k_cache,
                                  v_cache, block_table, start, lengths,
                                  *, num_heads, scale=None):
    """Chunked prompt-phase attention over an EXISTING cache prefix.

    data (B, K, d) holds one K-token chunk per row at absolute positions
    ``[start[b], start[b] + lengths[b])``; the kernel writes the chunk's
    K/V rows into the caches in place and attends each chunk query
    causally to the whole context so far.  Rows past ``lengths[b]`` are
    padding; ``lengths[b] == 0`` makes row b a no-op.  Returns (hidden
    (B, K, d), k_cache, v_cache)."""
    B, K, d = data.shape
    H, D, sc = _heads(d, num_heads, scale)
    q, k, v = _split_qkv(data, qkv_weight, qkv_bias, H)
    o, kc, vc = paged_chunk_prefill_attend(
        q, k, v, k_cache, v_cache, block_table.to(torch.int32),
        start.reshape(B).to(torch.int32), lengths.reshape(B).to(torch.int32),
        scale=sc)
    return _linear(o.reshape(B, K, d), proj_weight, proj_bias), kc, vc


@register("_contrib_PagedPrefillAttention",
          aliases=("PagedPrefillAttention",), num_outputs=3)
def paged_prefill_attention(data, qkv_weight, qkv_bias, proj_weight,
                            proj_bias, k_cache, v_cache, block_table,
                            lengths, *, num_heads, scale=None):
    """Prompt-phase attention that also fills the paged KV cache.

    data (B, S, d) is the padded prompt batch, lengths (B,) the real
    prompt lengths, block_table (B, M) the destination blocks.  The
    q/k/v projections land straight in the kernel's seq-major (B, S,
    H, D) layout; the kernel attends every row causally and writes the
    K/V rows below each length into the caches in place.  Returns
    (hidden (B, S, d), k_cache, v_cache)."""
    B, S, d = data.shape
    H, D, sc = _heads(d, num_heads, scale)
    q, k, v = _split_qkv(data, qkv_weight, qkv_bias, H)
    o, kc, vc = paged_prefill_attend(
        q, k, v, k_cache, v_cache, block_table.to(torch.int32),
        lengths.reshape(B).to(torch.int32), scale=sc)
    return _linear(o.reshape(B, S, d), proj_weight, proj_bias), kc, vc


@register("_contrib_GatherTimestep", aliases=("GatherTimestep",))
def gather_timestep(data, index):
    """data (B, S, d), index (B,) or (B, 1) -> (B, d): data[b, index[b]]
    with the index clipped into [0, S)."""
    B, S = data.shape[0], data.shape[1]
    idx = index.reshape(B).long().clamp(0, S - 1)
    return data[torch.arange(B, device=data.device), idx]
