"""Shape and type rules for the ported operators.

``PARAM_SHAPES[op](ins, attrs)`` fills in the shapes of parameter
inputs from the data shapes (the counterpart of
``mxnet_tpu/ops/shape_rules.py``); ``OUT_SHAPES[op](ins, attrs)`` gives
the output shapes and :func:`out_dtypes` the output types (the JAX
package traced the op with ``jax.eval_shape`` for both).  ``ins`` maps
input name -> shape tuple, or None while unknown.
"""
from __future__ import annotations

import torch

from .tensor import infer_magic

__all__ = ["PARAM_SHAPES", "OUT_SHAPES", "INDEX_INPUTS", "out_dtypes"]


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


def _broadcast(ins, a):
    return [tuple(torch.broadcast_shapes(ins["lhs"], ins["rhs"]))]


def _slice_axis_out(ins, a):
    x = list(ins["data"])
    axis = int(a["axis"]) % len(x)
    end = x[axis] if a["end"] is None else int(a["end"])
    x[axis] = end - int(a["begin"])
    return [tuple(x)]


def _concat_out(ins, a):
    shapes = list(ins.values())
    out = list(shapes[0])
    dim = int(a["dim"]) % len(out)
    out[dim] = sum(s[dim] for s in shapes)
    return [tuple(out)]


def _same(ins, a):
    return [next(iter(ins.values()))]


def _broadcast_all(ins, a):
    return [tuple(torch.broadcast_shapes(*ins.values()))]


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


def _deconv_params(ins, a):
    """(C, num_filter / groups, *kernel) weights (``mxnet_tpu/ops/
    shape_rules.py`` ``_deconv_shapes``)."""
    kernel = tuple(int(k) for k in a["kernel"])
    nf, g = int(a["num_filter"]), int(a["num_group"])
    return {"weight": (ins["data"][1], nf // g) + kernel, "bias": (nf,)}


def _deconv_out(ins, a):
    x = ins["data"]
    nd = len(a["kernel"])
    k = _ints(a["kernel"], nd, 1)
    s, d = _ints(a["stride"], nd, 1), _ints(a["dilate"], nd, 1)
    p, adj = _ints(a["pad"], nd, 0), _ints(a["adj"], nd, 0)
    sp = tuple((x[2 + i] - 1) * s[i] - 2 * p[i] + d[i] * (k[i] - 1) + 1
               + adj[i] for i in range(nd))
    return [(x[0], int(a["num_filter"])) + sp]


def _csa_out(ins, a):
    b, s, d3 = ins["qkv"]
    return [(b, s, d3 // 3)]


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


def _reduce_out(ins, a):
    from .elemwise import reduce_axes
    x = ins["data"]
    dims = reduce_axes(len(x), a["axis"], a.get("exclude", False))
    if a["keepdims"]:
        return [tuple(1 if i in dims else s for i, s in enumerate(x))]
    return [tuple(s for i, s in enumerate(x) if i not in dims)]


def _transpose_out(ins, a):
    x = ins["data"]
    axes = tuple(int(i) for i in a["axes"]) if a["axes"] else \
        tuple(range(len(x) - 1, -1, -1))
    return [tuple(x[i] for i in axes)]


def _expand_dims_out(ins, a):
    x = list(ins["data"])
    x.insert(int(a["axis"]) % (len(x) + 1), 1)
    return [tuple(x)]


def _squeeze_out(ins, a):
    x = ins["data"]
    if a["axis"] is None:
        return [tuple(s for s in x if s != 1)]
    axes = (a["axis"],) if isinstance(a["axis"], int) else a["axis"]
    drop = {int(i) % len(x) for i in axes}
    return [tuple(s for i, s in enumerate(x) if i not in drop)]


def _swapaxes_out(ins, a):
    x = list(ins["data"])
    i, j = int(a["dim1"]), int(a["dim2"])
    x[i], x[j] = x[j], x[i]
    return [tuple(x)]


def _stack_out(ins, a):
    shapes = list(ins.values())
    out = list(shapes[0])
    out.insert(int(a["axis"]) % (len(out) + 1), len(shapes))
    return [tuple(out)]


def _pick_out(ins, a):
    x = list(ins["data"])
    ax = int(a["axis"]) % len(x)
    if a["keepdims"]:
        x[ax] = 1
    else:
        del x[ax]
    return [tuple(x)]


def _pad_out(ins, a):
    pw = a["pad_width"]
    return [tuple(s + int(pw[2 * i]) + int(pw[2 * i + 1])
                  for i, s in enumerate(ins["data"]))]


def _where_out(ins, a):
    return [tuple(torch.broadcast_shapes(ins["condition"], ins["x"],
                                         ins["y"]))]


def _random_out(ins, a):
    return [tuple(a["shape"])]


def _broadcast_to_out(ins, a):
    x = ins["data"]
    return [tuple(int(t) if int(t) != 0 else x[i]
                  for i, t in enumerate(a["shape"]))]


def _broadcast_axis_out(ins, a):
    x = list(ins["data"])
    axes = (a["axis"],) if isinstance(a["axis"], int) else a["axis"]
    sizes = (a["size"],) if isinstance(a["size"], int) else a["size"]
    for ax, n in zip(axes, sizes):
        x[ax] = n
    return [tuple(x)]


def _tile_out(ins, a):
    x = ins["data"]
    reps = (a["reps"],) if isinstance(a["reps"], int) else tuple(a["reps"])
    n = max(len(x), len(reps))
    x = (1,) * (n - len(x)) + tuple(x)
    reps = (1,) * (n - len(reps)) + reps
    return [tuple(s * r for s, r in zip(x, reps))]


def _repeat_out(ins, a):
    x = list(ins["data"])
    if a["axis"] is None:
        n = 1
        for s in x:
            n *= s
        return [(n * int(a["repeats"]),)]
    x[int(a["axis"])] *= int(a["repeats"])
    return [tuple(x)]


def _one_hot_out(ins, a):
    return [tuple(ins["indices"]) + (int(a["depth"]),)]


def _split_out(ins, a):
    x = list(ins["data"])
    ax = int(a["axis"]) % len(x)
    n = int(a["num_outputs"])
    x[ax] //= n
    if a["squeeze_axis"]:
        del x[ax]
    return [tuple(x)] * n


def _slice_out(ins, a):
    x = ins["data"]
    step = tuple(a["step"]) if a["step"] else (None,) * len(a["begin"])
    out = list(x)
    for i, (b, e, st) in enumerate(zip(a["begin"], a["end"], step)):
        out[i] = len(range(*slice(b, e, st).indices(x[i])))
    return [tuple(out)]


def _slice_like_out(ins, a):
    x, like = list(ins["data"]), ins["shape_like"]
    for ax in (tuple(a["axes"]) if a["axes"] else range(len(like))):
        x[ax] = like[ax]
    return [tuple(x)]


def _dot_out(ins, a):
    x, y = list(ins["lhs"]), list(ins["rhs"])
    if a["transpose_a"]:
        x = x[::-1] if len(x) == 2 else x[1:] + x[:1]
    if a["transpose_b"]:
        y = y[::-1] if len(y) == 2 else y[-1:] + y[:-1]
    return [tuple(x[:-1] + y[1:])]


def _batch_dot_out(ins, a):
    x, y = list(ins["lhs"]), list(ins["rhs"])
    if a["transpose_a"]:
        x[-1], x[-2] = x[-2], x[-1]
    if a["transpose_b"]:
        y[-1], y[-2] = y[-2], y[-1]
    return [tuple(x[:-1]) + (y[-1],)]


PARAM_SHAPES = {
    "FullyConnected": _fc_params,
    "Convolution": _conv_params,
    "Deconvolution": _deconv_params,
    "LeakyReLU": lambda ins, a: {"gamma": (ins["data"][1],)}
    if a["act_type"] == "prelu" else {},
    "LinearRegressionOutput": lambda ins, a: {"label": ins["data"]},
    "MAERegressionOutput": lambda ins, a: {"label": ins["data"]},
    "LogisticRegressionOutput": lambda ins, a: {"label": ins["data"]},
    "BatchNorm": _bn_params,
    "_FusedBNReluConv": _fused_params,
    "LayerNorm": lambda ins, a: {"gamma": (ins["data"][-1],),
                                 "beta": (ins["data"][-1],)},
    "Embedding": lambda ins, a: {"weight": (a["input_dim"],
                                            a["output_dim"])},
    "_contrib_PagedDecodeAttention": _paged_params,
    "_contrib_PagedChunkPrefillAttention": _paged_params,
    "_contrib_PagedPrefillAttention": _paged_params,
    "_contrib_FusedCausalSelfAttention": _paged_params,
    "SoftmaxOutput": lambda ins, a: {
        "label": ins["data"][:1] + ins["data"][2:] if a["multi_output"]
        else ins["data"][:-1]},
}

# inputs that carry indices (block ids, positions, offsets, lengths) as
# floats: type inference never gives them the type of the op's data, so
# in a bf16 or f16 graph they stay float32, exact to 2^24 (bf16 holds
# integers exactly only up to 256, f16 up to 2048).  The JAX package's
# same-type rule gives them the anchor's type there; the port differs on
# purpose (ROADMAP C).
INDEX_INPUTS = {
    "_contrib_PagedDecodeAttention": ("block_table", "positions"),
    "_contrib_PagedChunkPrefillAttention": ("block_table", "start",
                                            "lengths"),
    "_contrib_PagedPrefillAttention": ("block_table", "lengths"),
    "take": ("indices",),
    "_contrib_GatherTimestep": ("index",),
}

OUT_SHAPES = {
    "FullyConnected": _fc_out,
    "Convolution": _conv_out,
    "Deconvolution": _deconv_out,
    "_contrib_CausalSelfAttention": _csa_out,
    "LinearRegressionOutput": _same,
    "MAERegressionOutput": _same,
    "LogisticRegressionOutput": _same,
    "BatchNorm": _bn_out,
    "_FusedBNReluConv": _fused_out,
    "Pooling": _pool_out,
    "Activation": _same,
    "Flatten": _flatten_out,
    "LayerNorm": lambda ins, a: [ins["data"], ins["data"][:-1],
                                 ins["data"][:-1]],
    "LeakyReLU": lambda ins, a: [ins["data"]],
    "Dropout": lambda ins, a: [ins["data"], ins["data"]],
    "Embedding": lambda ins, a: [ins["data"] + (a["output_dim"],)],
    "_contrib_PagedDecodeAttention":
        lambda ins, a: [ins["data"], ins["k_cache"], ins["v_cache"]],
    "_contrib_PagedChunkPrefillAttention":
        lambda ins, a: [ins["data"], ins["k_cache"], ins["v_cache"]],
    "_contrib_PagedPrefillAttention":
        lambda ins, a: [ins["data"], ins["k_cache"], ins["v_cache"]],
    "_contrib_FusedCausalSelfAttention": lambda ins, a: [ins["data"]],
    "SoftmaxOutput": lambda ins, a: [ins["data"]],
    "_contrib_GatherTimestep":
        lambda ins, a: [(ins["data"][0], ins["data"][2])],
    "Reshape": _reshape_out,
    "Cast": _same,
    "take": _take_out,
    "argmax": _argmax_out,
    "broadcast_add": _broadcast,
    "broadcast_sub": _broadcast,
    "broadcast_mul": _broadcast,
    "broadcast_equal": _broadcast,
    "_plus_scalar": _same,
    "_minus_scalar": _same,
    "_mul_scalar": _same,
    "slice_axis": _slice_axis_out,
    "Concat": _concat_out,
    "InstanceNorm": lambda ins, a: [ins["data"]],
    "transpose": _transpose_out,
    "expand_dims": _expand_dims_out,
    "squeeze": _squeeze_out,
    "SwapAxis": _swapaxes_out,
    "stack": _stack_out,
    "pick": _pick_out,
    "Pad": _pad_out,
    "where": _where_out,
    "reshape_like": lambda ins, a: [ins["rhs"]],
    "broadcast_like": lambda ins, a: [ins["rhs"]],
    "log_softmax": _same,
    "softmax": _same,
    "softmin": _same,
    "clip": _same,
    "BlockGrad": _same,
    "make_loss": _same,
    "add_n": _broadcast_all,
    "_random_uniform": _random_out,
    "_random_normal": _random_out,
    "_random_randint": _random_out,
    "argmin": _argmax_out,
    "norm": _reduce_out,
    "smooth_l1": _same,
    "reverse": _same,
    "broadcast_to": _broadcast_to_out,
    "broadcast_axis": _broadcast_axis_out,
    "tile": _tile_out,
    "repeat": _repeat_out,
    "one_hot": _one_hot_out,
    "SliceChannel": _split_out,
    "slice": _slice_out,
    "slice_like": _slice_like_out,
    "batch_take": lambda ins, a: [ins["a"][:1]],
    "dot": _dot_out,
    "batch_dot": _batch_dot_out,
}
for _op in ("broadcast_div", "broadcast_mod", "broadcast_power",
            "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
            "broadcast_not_equal", "broadcast_greater",
            "broadcast_greater_equal", "broadcast_lesser",
            "broadcast_lesser_equal"):
    OUT_SHAPES[_op] = _broadcast
for _op in ("_div_scalar", "_mod_scalar", "_power_scalar",
            "_maximum_scalar", "_minimum_scalar", "_equal_scalar",
            "_not_equal_scalar", "_greater_scalar", "_greater_equal_scalar",
            "_lesser_scalar", "_lesser_equal_scalar"):
    OUT_SHAPES[_op] = _same
for _op in ("sum", "mean", "prod", "max", "min", "nansum"):
    OUT_SHAPES[_op] = _reduce_out


def _register_unary():
    from .elemwise import _UNARY
    for op in tuple(_UNARY) + ("identity",):
        OUT_SHAPES[op] = _same


_register_unary()


# ops whose output takes the type of their data input (normalizations
# and loss heads keep the data's type whatever their parameters' are;
# the paged attention ops' output takes q's type, as the JAX kernels'
# outputs take q.dtype); every other op promotes its floating inputs, as
# jnp's arithmetic does
_DATA_TYPED = {"BatchNorm", "LayerNorm", "_FusedBNReluConv", "SoftmaxOutput",
               "_contrib_FusedCausalSelfAttention",
               "_contrib_CausalSelfAttention", "LinearRegressionOutput",
               "MAERegressionOutput", "LogisticRegressionOutput", "Pooling", "Activation",
               "Flatten", "LeakyReLU", "Dropout", "Reshape", "slice_axis",
               "_contrib_GatherTimestep", "_contrib_PagedDecodeAttention",
               "_contrib_PagedChunkPrefillAttention",
               "_contrib_PagedPrefillAttention"}
# the paged ops' outputs 1 and 2 are their caches (inputs 5 and 6),
# updated in place: each keeps its cache's own type
_CACHE_OUTPUTS = {"_contrib_PagedDecodeAttention": (5, 6),
                  "_contrib_PagedChunkPrefillAttention": (5, 6),
                  "_contrib_PagedPrefillAttention": (5, 6)}


def out_dtypes(op, in_dtypes, attrs, n_out):
    """The types of ``op``'s ``n_out`` outputs from its inputs' types
    (``in_dtypes``, in input order): ``Cast`` gives its ``dtype``
    attribute (as do ``one_hot`` and the random ops), ``Embedding`` its
    weight's type, ``argmax``/``argmin`` float32 (the reference returns
    indices as floats), the normalizations, pooling, activations, loss
    heads and attention ops their data's type (the paged ops' caches
    their own), and the rest the promotion of their floating inputs."""
    from ..base import torch_dtype
    if op in ("Cast", "one_hot", "_random_uniform", "_random_normal",
              "_random_randint"):
        dt = torch_dtype(attrs["dtype"])
    elif op == "Embedding":
        dt = in_dtypes[1]
    elif op in ("argmax", "argmin"):
        dt = torch.float32
    elif op in _DATA_TYPED or not in_dtypes:
        dt = in_dtypes[0] if in_dtypes else torch.float32
    else:
        floats = [d for d in in_dtypes if d.is_floating_point]
        dt = floats[0] if floats else in_dtypes[0]
        for d in floats[1:]:
            dt = torch.promote_types(dt, d)
    out = [dt] * n_out
    for i, src in enumerate(_CACHE_OUTPUTS.get(op, ()), start=1):
        out[i] = in_dtypes[src]
    return out
