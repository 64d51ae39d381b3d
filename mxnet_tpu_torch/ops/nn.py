"""Neural-network operators of the serving and training slices.

Counterpart of ``mxnet_tpu/ops/nn.py`` for the ops the transformer's
mixed decode step and training symbol use, with the same weight
layouts.  The projections and the FFN are plain matrix products
(``torch.matmul``, as the JAX package left them to XLA); LayerNorm, the
causal training attention and the two paged attentions go through the
hand-written kernels in ``..kernels``, which take the plain PyTorch
versions only for tensors on the CPU.  Gradients are autograd's, with
``torch.autograd.Function``s where the JAX package had a custom VJP
(LayerNorm, flash attention, SoftmaxOutput).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..kernels import (flash_attention, layernorm, paged_chunk_prefill_attend,
                       paged_decode_attend)
from .registry import register


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


@register("LeakyReLU")
def leaky_relu(data, gamma=None, *, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """leaky and tanh-approximated GELU (ref src/operator/leaky_relu.cc;
    ``gelu_tanh`` is the GPT-2 convention the transformer uses)."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "gelu_tanh":
        return F.gelu(data, approximate="tanh")
    raise MXNetError("LeakyReLU act_type=%s is not in the PyTorch port yet"
                     % act_type)


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
# Causal self-attention of the training symbol
# ----------------------------------------------------------------------
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


@register("_contrib_GatherTimestep", aliases=("GatherTimestep",))
def gather_timestep(data, index):
    """data (B, S, d), index (B,) or (B, 1) -> (B, d): data[b, index[b]]
    with the index clipped into [0, S)."""
    B, S = data.shape[0], data.shape[1]
    idx = index.reshape(B).long().clamp(0, S - 1)
    return data[torch.arange(B, device=data.device), idx]
