"""Executor: a bound Symbol run eagerly on its device.

Counterpart of ``mxnet_tpu/executor.py`` for inference.  ``simple_bind``
allocates every argument once on the bind device; ``forward`` copies the
fed inputs into those buffers and runs the graph's nodes in topological
order, each op launching its own kernels on PyTorch's current stream.
There is no compiled program: PyTorch runs eagerly.

Cache arguments (the paged K/V caches) are updated IN PLACE by the ops
that write them, and the outputs that carry the "new" caches are those
same tensors.  That is the counterpart of the JAX package's buffer
donation: no whole-cache copy in or out of a step.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError
from .context import current_context
from .ndarray.ndarray import NDArray

__all__ = ["Executor"]


class Executor:
    def __init__(self, symbol, ctx, grad_req, shapes):
        if grad_req != "null":
            raise MXNetError("training executors (grad_req=%r) come with the "
                             "training slice of the PyTorch port" % grad_req)
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else current_context()
        dev = self._ctx.torch_device
        arg_shapes, _, _ = symbol.infer_shape(**shapes)
        self.arg_dict = {
            name: NDArray(torch.zeros(shape, dtype=torch.float32,
                                      device=dev))
            for name, shape in zip(symbol.list_arguments(), arg_shapes)}
        self._nodes = symbol._topo()
        self.outputs = []

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameter values (NDArrays, tensors or numpy arrays)
        into the bound arguments of the same names."""
        for name, value in arg_params.items():
            dst = self.arg_dict.get(name)
            if dst is None:
                if allow_extra_params:
                    continue
                raise MXNetError("copy_params_from: %s is not an argument "
                                 "of the bound symbol" % name)
            dst._data.copy_(_as_tensor(value, dst.shape, name))

    def forward(self, is_train=False, **feeds):
        """Copy ``feeds`` into the bound inputs and run the graph.
        Returns the outputs as NDArrays (also kept in ``outputs``)."""
        if is_train:
            raise MXNetError("forward(is_train=True) comes with the training "
                             "slice of the PyTorch port")
        for name, value in feeds.items():
            dst = self.arg_dict.get(name)
            if dst is None:
                raise MXNetError("forward: unknown input %s" % name)
            dst._data.copy_(_as_tensor(value, dst.shape, name))
        env = {}
        for node in self._nodes:
            if node.is_var:
                env[(id(node), 0)] = self.arg_dict[node.name]._data
                continue
            out = node.op.fn(*[env[(id(n), i)] for n, i in node.inputs],
                             **node.attrs)
            for i, t in enumerate(out if isinstance(out, tuple) else (out,)):
                env[(id(node), i)] = t
        self.outputs = [NDArray(env[(id(n), i)])
                        for n, i in self._symbol._entries]
        return self.outputs


def _as_tensor(value, shape, name):
    if isinstance(value, NDArray):
        value = value._data
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(_np.ascontiguousarray(value))
    if tuple(value.shape) != tuple(shape):
        raise MXNetError("%s: shape %s does not match the bound %s"
                         % (name, tuple(value.shape), tuple(shape)))
    return value
