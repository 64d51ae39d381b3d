"""Parameters between the JAX package (or any name -> numpy dict) and
a device, in both directions.

``symbol_shapes`` gives any symbol's parameter and auxiliary-state
shapes, and ``convert_symbol_params`` copies numpy weights and moving
statistics onto a device after checking them against those shapes: the
same numpy arrays then bind in both packages (the vision models, whose
BatchNorm statistics are auxiliary states).  A channel-last symbol's
convolution weights are OHWI and are carried as they are; a symbol
after ``symbol.fuse.fuse_conv_bn`` has the unfused one's parameters and
auxiliary states, so the same arrays bind in either.  The transformer's helpers
follow.

Both packages use MXNet's parameter names and layouts (FullyConnected
weights ``(num_hidden, in_dim)``, the packed qkv ``(3d, d)``), and the
training symbol (``transformer.get_symbol``) binds the same parameter
set as the mixed decode step.  So ``convert_params`` is a checked copy
(every parameter must be present with the shape the symbol infers; each
is copied as float32 onto the context; extra names such as optimizer
state are ignored), and ``export_params`` turns the port's parameters
back into numpy under the same names: a model trained by the port loads
into the JAX package and into the port's ``DecodeEngine``.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["convert_params", "convert_symbol_params", "export_params",
           "param_shapes", "symbol_shapes"]


def symbol_shapes(symbol, **input_shapes):
    """``({parameter: shape}, {auxiliary state: shape})`` of ``symbol``
    bound with ``input_shapes`` (the data and label shapes, which are
    left out)."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(**input_shapes)
    args = {n: tuple(s) for n, s in zip(symbol.list_arguments(), arg_shapes)
            if n not in input_shapes}
    return args, {n: tuple(s) for n, s in
                  zip(symbol.list_auxiliary_states(), aux_shapes)}


def convert_symbol_params(np_args, np_aux, ctx, symbol, **input_shapes):
    """``(arg_params, aux_params)`` as float32 NDArrays on ``ctx``, from
    name -> numpy dicts (or anything with ``asnumpy()``), checked against
    :func:`symbol_shapes`; extra names are ignored."""
    arg_shapes, aux_shapes = symbol_shapes(symbol, **input_shapes)
    return (_checked_copy(np_args, arg_shapes, ctx, "parameters"),
            _checked_copy(np_aux, aux_shapes, ctx, "auxiliary states"))


def _checked_copy(np_params, expected, ctx, what):
    """Every name of ``expected`` copied from ``np_params`` onto ``ctx``
    as float32; raises ``MXNetError`` naming every missing or misshapen
    one."""
    missing = sorted(n for n in expected if n not in np_params)
    if missing:
        raise MXNetError("convert: missing %s %s" % (what, missing))
    arrays = {}
    bad = []
    for name, shape in expected.items():
        v = np_params[name]
        arr = _np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v,
                          dtype=_np.float32)
        if arr.shape != tuple(shape):
            bad.append("%s %s (expected %s)" % (name, arr.shape,
                                                 tuple(shape)))
        arrays[name] = arr
    if bad:
        raise MXNetError("convert: misshapen %s: %s" % (what, "; ".join(bad)))
    dev = ctx.torch_device
    return {n: NDArray(torch.from_numpy(_np.ascontiguousarray(a)).to(dev))
            for n, a in arrays.items()}


def param_shapes(model_config):
    """``{name: shape}`` of every parameter of the mixed decode step for
    ``model_config`` (the ``transformer`` kwargs); the training symbol
    binds the same set."""
    from .models import transformer
    cfg = {k: v for k, v in model_config.items() if k != "dropout"}
    msym = transformer.get_mixed_step_symbol(block_size=1, num_blocks=1,
                                             **cfg)
    arg_shapes, _, _ = msym.infer_shape(
        data=(1, 1), positions=(1, 1), block_table=(1, 1),
        chunk_data=(1, 1), chunk_positions=(1, 1), chunk_start=(1,),
        chunk_len=(1,), chunk_table=(1, 1))
    return {n: s for n, s in zip(msym.list_arguments(), arg_shapes)
            if n not in transformer.MIXED_STEP_INPUTS
            and not n.endswith("_cache")}


def convert_params(np_params, ctx, model_config):
    """Copy ``np_params`` (name -> numpy array, or anything with
    ``asnumpy()``, such as the JAX package's NDArrays) onto ``ctx`` as
    float32 NDArrays, after checking names and shapes against the mixed
    decode step of ``model_config``.  Raises ``MXNetError`` naming every
    missing or misshapen parameter."""
    return _checked_copy(np_params, param_shapes(model_config), ctx,
                         "parameters")


def export_params(params):
    """``{name: float32 numpy array}`` from the port's parameters or
    auxiliary states (a dict of NDArrays or tensors on any device, such
    as either half of ``Module.get_params()``)."""
    out = {}
    for name, v in params.items():
        t = v._data if isinstance(v, NDArray) else v
        out[name] = t.detach().float().cpu().numpy()
    return out
