"""Shape rules for the ported operators.

``PARAM_SHAPES[op](ins, attrs)`` fills in the shapes of parameter
inputs from the data shapes (the counterpart of
``mxnet_tpu/ops/shape_rules.py``); ``OUT_SHAPES[op](ins, attrs)`` gives
the output shapes (the JAX package traced the op with
``jax.eval_shape`` for these).  ``ins`` maps input name -> shape tuple,
or None while unknown.
"""
from __future__ import annotations

import torch

from .tensor import infer_magic

__all__ = ["PARAM_SHAPES", "OUT_SHAPES"]


def _fc_params(ins, a):
    x = ins["data"]
    in_dim = 1
    for s in (x[1:] if a["flatten"] else x[-1:]):
        in_dim *= s
    return {"weight": (a["num_hidden"], in_dim), "bias": (a["num_hidden"],)}


def _fc_out(ins, a):
    x = ins["data"]
    lead = x[:1] if a["flatten"] and len(x) > 2 else x[:-1]
    return [tuple(lead) + (a["num_hidden"],)]


def _paged_params(ins, a):
    """The packed qkv and output projections of the attention ops."""
    d = ins["data"][-1]
    return {"qkv_weight": (3 * d, d), "qkv_bias": (3 * d,),
            "proj_weight": (d, d), "proj_bias": (d,)}


def _take_out(ins, a):
    x, idx = ins["a"], ins["indices"]
    axis = int(a["axis"]) % len(x)
    return [x[:axis] + idx + x[axis + 1:]]


def _argmax_out(ins, a):
    x = ins["data"]
    if a["axis"] is None:
        return [()]
    axis = int(a["axis"]) % len(x)
    keep = (1,) if a["keepdims"] else ()
    return [x[:axis] + keep + x[axis + 1:]]


def _reshape_out(ins, a):
    return [infer_magic(ins["data"], tuple(int(s) for s in a["shape"]))]


def _same(ins, a):
    return [next(iter(ins.values()))]


def _ints(v, n, empty):
    """An int or int sequence as an ``n``-tuple; ``()`` gives ``empty``."""
    if isinstance(v, (tuple, list)):
        t = tuple(int(x) for x in v)
        return t if t else (empty,) * n
    return (int(v),) * n


def _channel_last(a):
    return a.get("layout") is not None and str(a["layout"]).endswith("C")


def _split(x, a):
    """(channels, spatial dims) of a data shape in the op's layout."""
    return (x[-1], tuple(x[1:-1])) if _channel_last(a) else \
        (x[1], tuple(x[2:]))


def _join(n, c, sp, a):
    return (n,) + sp + (c,) if _channel_last(a) else (n, c) + sp


def _conv_params(ins, a):
    """OIHW weights for channels-first data, OHWI for channel-last."""
    c, _ = _split(ins["data"], a)
    kernel = tuple(int(k) for k in a["kernel"])
    cg = c // int(a["num_group"])
    w = (a["num_filter"],) + kernel + (cg,) if _channel_last(a) else \
        (a["num_filter"], cg) + kernel
    return {"weight": w, "bias": (a["num_filter"],)}


def _conv_out(ins, a):
    x = ins["data"]
    _, xs = _split(x, a)
    nd = len(a["kernel"])
    k = _ints(a["kernel"], nd, 1)
    s, d = _ints(a["stride"], nd, 1), _ints(a["dilate"], nd, 1)
    p = _ints(a["pad"], nd, 0)
    sp = tuple((xs[i] + 2 * p[i] - d[i] * (k[i] - 1) - 1) // s[i] + 1
               for i in range(nd))
    return [_join(x[0], a["num_filter"], sp, a)]


def _bn_params(ins, a):
    c = (ins["data"][int(a["axis"]) % len(ins["data"])],)
    return {"gamma": c, "beta": c, "moving_mean": c, "moving_var": c}


def _bn_out(ins, a):
    x = ins["data"]
    c = (x[int(a["axis"]) % len(x)],)
    return [x, c, c, c, c]


def _pool_out(ins, a):
    x = ins["data"]
    c, xs = _split(x, a)
    nd = len(xs)
    if a["global_pool"]:
        return [_join(x[0], c, (1,) * nd, a)]
    k = _ints(a["kernel"], nd, 1)
    s, p = _ints(a["stride"], nd, 1), _ints(a["pad"], nd, 0)
    sp = []
    for i in range(nd):
        span = xs[i] + 2 * p[i] - k[i]
        sp.append((-(-span // s[i]) if a["pooling_convention"] == "full"
                   else span // s[i]) + 1)
    return [_join(x[0], c, tuple(sp), a)]


def _fused_params(ins, a):
    """data (..., K) and num_filter O give the BatchNorm vectors (K,),
    the channel-last 1x1 weight (O, 1, ..., 1, K) and, with
    ``with_residual``, the residual (..., O)."""
    x = ins["data"]
    k, o = x[-1], int(a["num_filter"])
    out = {"gamma": (k,), "beta": (k,), "moving_mean": (k,),
           "moving_var": (k,), "weight": (o,) + (1,) * (len(x) - 2) + (k,)}
    if a["with_residual"]:
        out["residual"] = tuple(x[:-1]) + (o,)
    return out


def _fused_out(ins, a):
    x = ins["data"]
    o = tuple(x[:-1]) + (int(a["num_filter"]),)
    if a["with_residual"] and ins.get("residual") is not None:
        o = tuple(torch.broadcast_shapes(o, ins["residual"]))
    return [o, (x[-1],), (x[-1],)]


def _flatten_out(ins, a):
    x = ins["data"]
    n = 1
    for d in x[1:]:
        n *= d
    return [(x[0], n)]


PARAM_SHAPES = {
    "FullyConnected": _fc_params,
    "Convolution": _conv_params,
    "BatchNorm": _bn_params,
    "_FusedBNReluConv": _fused_params,
    "LayerNorm": lambda ins, a: {"gamma": (ins["data"][-1],),
                                 "beta": (ins["data"][-1],)},
    "Embedding": lambda ins, a: {"weight": (a["input_dim"],
                                            a["output_dim"])},
    "_contrib_PagedDecodeAttention": _paged_params,
    "_contrib_PagedChunkPrefillAttention": _paged_params,
    "_contrib_FusedCausalSelfAttention": _paged_params,
    "SoftmaxOutput": lambda ins, a: {
        "label": ins["data"][:1] + ins["data"][2:] if a["multi_output"]
        else ins["data"][:-1]},
}

OUT_SHAPES = {
    "FullyConnected": _fc_out,
    "Convolution": _conv_out,
    "BatchNorm": _bn_out,
    "_FusedBNReluConv": _fused_out,
    "Pooling": _pool_out,
    "Activation": _same,
    "Flatten": _flatten_out,
    "LayerNorm": lambda ins, a: [ins["data"], ins["data"][:-1],
                                 ins["data"][:-1]],
    "LeakyReLU": lambda ins, a: [ins["data"]],
    "Embedding": lambda ins, a: [ins["data"] + (a["output_dim"],)],
    "_contrib_PagedDecodeAttention":
        lambda ins, a: [ins["data"], ins["k_cache"], ins["v_cache"]],
    "_contrib_PagedChunkPrefillAttention":
        lambda ins, a: [ins["data"], ins["k_cache"], ins["v_cache"]],
    "_contrib_FusedCausalSelfAttention": lambda ins, a: [ins["data"]],
    "SoftmaxOutput": lambda ins, a: [ins["data"]],
    "_contrib_GatherTimestep":
        lambda ins, a: [(ins["data"][0], ins["data"][2])],
    "Reshape": _reshape_out,
    "Cast": _same,
    "take": _take_out,
    "argmax": _argmax_out,
    "broadcast_add": lambda ins, a: [tuple(torch.broadcast_shapes(
        ins["lhs"], ins["rhs"]))],
    "broadcast_sub": lambda ins, a: [tuple(torch.broadcast_shapes(
        ins["lhs"], ins["rhs"]))],
    "_plus_scalar": _same,
    "_minus_scalar": _same,
}
