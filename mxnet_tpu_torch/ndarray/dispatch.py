"""Eager operator dispatch: the imperative runtime.

Counterpart of ``mxnet_tpu/ndarray/dispatch.py`` (reference
src/imperative/imperative.cc Invoke).  The JAX package jits each op per
attribute set and keeps its own autograd tape; here ``invoke`` calls the
op's function on the inputs' tensors under
``torch.set_grad_enabled(autograd.is_recording())``, so torch's
autograd records exactly what ``autograd.record()`` scopes, and hands an
op that declares ``is_train`` the flag ``autograd.is_training()``.
After the call, each output an op declares in ``mutate_inputs`` is
written into its input array in place (BatchNorm's moving statistics,
the reference's FMutateInputs), and ``out=`` arrays receive the
outputs.  Every array input must live on one device; numpy and scalar
tensor inputs are copied there.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, numpy_to_tensor
from ..ops import registry as _reg

__all__ = ["invoke", "invoke_by_name"]


def _split(opdef, args, kwargs):
    """(tensor inputs in the op's order, attributes)."""
    if opdef.var_inputs:
        attrs = dict(kwargs)
        attrs["num_args"] = len(args)
        return list(args), attrs
    names = opdef.input_names
    if len(args) > len(names):
        raise MXNetError("%s takes %d tensor inputs, got %d"
                         % (opdef.name, len(names), len(args)))
    attrs = {k: v for k, v in kwargs.items() if k not in names}
    inputs = list(args) + [kwargs.get(n) for n in names[len(args):]]
    for n, x in zip(names, inputs):
        if x is None and n not in opdef.optional_inputs:
            raise MXNetError("%s: input %r not given" % (opdef.name, n))
    return inputs, attrs


def _device_of(opdef, inputs):
    from .ndarray import NDArray
    devs = {x._data.device for x in inputs if isinstance(x, NDArray)}
    if len(devs) > 1:
        raise MXNetError("%s: all operands must live on one context, got %s;"
                         " move them with copyto()/as_in_context()"
                         % (opdef.name, sorted(str(d) for d in devs)))
    return devs.pop() if devs else None


def invoke(opdef, args, kwargs, out=None):
    """Run ``opdef`` on NDArray (or numpy) inputs; returns an NDArray,
    a list of them for several visible outputs, or ``out``."""
    from .. import autograd
    from ..context import current_context
    from .ndarray import NDArray, _guard_write, _write
    inputs, attrs = _split(opdef, args, kwargs)
    attrs = opdef.normalize_attrs(attrs)
    dev = _device_of(opdef, inputs)
    if dev is None and any(x is not None for x in inputs):
        dev = current_context().torch_device
    tensors = []
    for x in inputs:
        if isinstance(x, NDArray) or x is None:
            tensors.append(None if x is None else x._data)
        else:
            a = _np.asarray(x)
            if a.dtype in (_np.float64, _np.int64):     # as nd.array does
                a = a.astype(_np.float32 if a.dtype == _np.float64
                             else _np.int32)
            tensors.append(numpy_to_tensor(a).to(dev))
    if opdef.takes_is_train:
        attrs = dict(attrs, is_train=autograd.is_training())
    with torch.set_grad_enabled(autograd.is_recording()):
        raw = opdef.fn(*tensors, **attrs)
    outs = list(raw) if isinstance(raw, (tuple, list)) else [raw]
    if opdef.mutate_inputs:
        names = opdef.names_for(len(inputs))
        with torch.no_grad():
            for in_name, idx in opdef.mutate_inputs:
                dst = inputs[names.index(in_name)]
                if isinstance(dst, NDArray) and outs[idx] is not dst._data:
                    dst._data.copy_(outs[idx])
    n_vis = opdef.visible_out_count(attrs)
    if out is not None:
        dsts = out if isinstance(out, (list, tuple)) else [out]
        for dst, t in zip(dsts, outs[:n_vis]):
            _guard_write(dst, None)
            _write(dst, t)
        return out
    results = [NDArray(t) for t in outs[:n_vis]]
    return results[0] if n_vis == 1 else results


def invoke_by_name(name, args, kwargs, out=None):
    return invoke(_reg.get_op(name), args, kwargs, out=out)
