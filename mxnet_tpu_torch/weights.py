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
Gluon nets carry over by name too (``gluon_params_from_numpy``: a JAX
Gluon net's ``collect_params()`` as numpy, into the port's net of the
same construction, the RNN cells and fused layers of ``gluon.rnn``
included).  The ``mx.rnn`` cell zoos carry over by name in the same
way, and ``convert_symbol_params(from_cells=..., to_cells=...)`` moves
their weights between the fused op's packed vector and the step cells'
per-gate arrays (``unpack_weights``/``pack_weights``).  The transformer's training symbol
(``transformer.get_symbol``) binds the same parameter
set as the mixed decode step.  So ``convert_params`` is a checked copy
(every parameter must be present with the shape the symbol infers; each
is copied as float32 onto the context; extra names such as optimizer
state are ignored), and ``export_params`` turns the port's parameters
back into numpy under the same names: a model trained by the port loads
into the JAX package and into the port's ``DecodeEngine``.

bf16 and f16: a bfloat16 numpy array (``ml_dtypes``', as the JAX
package's bf16 parameters come to numpy) is carried bit for bit as a
``torch.bfloat16`` tensor, a float16 array as a ``torch.float16`` one;
every other array as float32.
``export_params`` gives float32 numpy, which holds a bf16 value exactly,
so a bf16 parameter cast back to bfloat16 in the JAX package has the
bits it had on the port.

Optimizer states cross the same way: ``export_updater_states`` turns an
``Updater``'s per-key states (either package's: None, an array, or
nested tuples such as multi-precision's ``(inner, weight32)``) into the
same nesting of numpy arrays in their own types, and
``convert_updater_states`` puts such a nesting on a device, so both
packages' updaters start from the same masters and moments.
"""
from __future__ import annotations

import numpy as _np

from .base import MXNetError, numpy_to_tensor
from .ndarray.ndarray import NDArray

__all__ = ["convert_params", "convert_symbol_params", "export_params",
           "gluon_params_from_numpy", "param_shapes", "symbol_shapes",
           "export_updater_states", "convert_updater_states"]


def symbol_shapes(symbol, **input_shapes):
    """``({parameter: shape}, {auxiliary state: shape})`` of ``symbol``
    bound with ``input_shapes`` (the data and label shapes, which are
    left out)."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(**input_shapes)
    args = {n: tuple(s) for n, s in zip(symbol.list_arguments(), arg_shapes)
            if n not in input_shapes}
    return args, {n: tuple(s) for n, s in
                  zip(symbol.list_auxiliary_states(), aux_shapes)}


def convert_symbol_params(np_args, np_aux, ctx, symbol, from_cells=(),
                          to_cells=(), **input_shapes):
    """``(arg_params, aux_params)`` as NDArrays on ``ctx`` (float32, or
    bfloat16 and float16 for arrays of those types), from
    name -> numpy dicts (or anything with ``asnumpy()``), checked against
    :func:`symbol_shapes`; extra names are ignored.  RNN weights cross
    between cell layouts on the way: each of ``from_cells`` (the
    ``mx.rnn`` cells the arrays were trained with, either package's)
    unpacks its weights to per-gate arrays, then each of ``to_cells``
    (``symbol``'s cells) packs them, so a ``FusedRNNCell``'s packed
    vector loads into its ``unfuse()`` stack and back."""
    if from_cells or to_cells:
        np_args = {k: _np.asarray(v.asnumpy() if hasattr(v, "asnumpy")
                                  else v) for k, v in np_args.items()}
        for cell in from_cells:
            np_args = cell.unpack_weights(np_args)
        for cell in to_cells:
            np_args = cell.pack_weights(np_args)
    arg_shapes, aux_shapes = symbol_shapes(symbol, **input_shapes)
    return (_checked_copy(np_args, arg_shapes, ctx, "parameters"),
            _checked_copy(np_aux, aux_shapes, ctx, "auxiliary states"))


# 16-bit floating arrays kept in their own type by _checked_copy
_SIXTEEN_BIT = ("bfloat16", "float16")


def _checked_copy(np_params, expected, ctx, what):
    """Every name of ``expected`` copied from ``np_params`` onto ``ctx``
    as float32 (bfloat16 and float16 arrays bit for bit in their own
    type); raises ``MXNetError`` naming every missing or misshapen
    one."""
    missing = sorted(n for n in expected if n not in np_params)
    if missing:
        raise MXNetError("convert: missing %s %s" % (what, missing))
    arrays = {}
    bad = []
    for name, shape in expected.items():
        v = np_params[name]
        arr = _np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)
        if arr.dtype.name not in _SIXTEEN_BIT:
            arr = arr.astype(_np.float32, copy=False)
        if arr.shape != tuple(shape):
            bad.append("%s %s (expected %s)" % (name, arr.shape,
                                                 tuple(shape)))
        arrays[name] = arr
    if bad:
        raise MXNetError("convert: misshapen %s: %s" % (what, "; ".join(bad)))
    dev = ctx.torch_device
    return {n: NDArray(numpy_to_tensor(a).to(dev))
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
    float32 NDArrays (bfloat16 and float16 arrays in their own type),
    after checking names and shapes against the mixed decode step of
    ``model_config`` (any of its dtypes).  Raises ``MXNetError`` naming
    every missing or misshapen parameter."""
    return _checked_copy(np_params, param_shapes(model_config), ctx,
                         "parameters")


def export_params(params):
    """``{name: float32 numpy array}`` from the port's parameters or
    auxiliary states (a dict of NDArrays or tensors on any device, such
    as either half of ``Module.get_params()``); bf16 and f16 values are
    exact in float32."""
    out = {}
    for name, v in params.items():
        t = v._data if isinstance(v, NDArray) else v
        out[name] = t.detach().float().cpu().numpy()
    return out


def gluon_params_from_numpy(net, arrays, ctx=None):
    """Copy ``arrays`` (parameter name -> numpy array, or anything with
    ``asnumpy()``; a JAX Gluon net's ``collect_params()`` as numpy) into
    the Gluon ``net``'s parameters of the same names, in place, in each
    parameter's type.  A parameter still waiting for its deferred
    initialization takes the array's shape and is initialized first
    (on its ``initialize`` context, or ``ctx``).  Every parameter of
    ``net`` must be present with its shape; extra names raise."""
    params = net.collect_params()
    arrays = {k: _np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)
              for k, v in arrays.items()}
    missing = sorted(set(params.keys()) - set(arrays))
    extra = sorted(set(arrays) - set(params.keys()))
    if missing or extra:
        raise MXNetError("gluon_params_from_numpy: missing %s, unknown %s"
                         % (missing, extra))
    for name, p in params.items():
        a = arrays[name]
        if p._data is None:
            if not p._deferred_init:
                p.shape = a.shape
                p.initialize(ctx=ctx)
        elif tuple(a.shape) != p._data.shape:
            raise MXNetError("gluon_params_from_numpy: %s has shape %s, "
                             "the net's %s" % (name, tuple(a.shape),
                                               p._data.shape))
        p.set_data(numpy_to_tensor(a))


def _map_nested(fn, state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_map_nested(fn, x) for x in state)
    return fn(state)


def export_updater_states(states):
    """``{key: nesting of numpy arrays}`` from an ``Updater``'s
    ``states`` (either package's NDArrays), each leaf through its
    ``asnumpy()``: float32 masters and moments as float32, a JAX bf16
    leaf as ``ml_dtypes``' bfloat16, a port bf16 leaf as the float32
    that holds it exactly."""
    return {k: _map_nested(lambda v: _np.asarray(v.asnumpy()), st)
            for k, st in states.items()}


def convert_updater_states(np_states, ctx):
    """``{key: nesting of NDArrays}`` on ``ctx`` from
    :func:`export_updater_states`' numpy nesting, every leaf in its own
    type (bf16 bit for bit): assign it to the port ``Updater``'s
    ``states`` before its first update."""
    dev = ctx.torch_device
    return {k: _map_nested(lambda a: NDArray(numpy_to_tensor(a).to(dev)), st)
            for k, st in np_states.items()}
