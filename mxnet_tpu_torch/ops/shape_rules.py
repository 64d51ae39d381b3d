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


PARAM_SHAPES = {
    "FullyConnected": _fc_params,
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
