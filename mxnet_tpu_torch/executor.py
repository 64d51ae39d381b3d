"""Executor: a bound Symbol run eagerly on its device.

Counterpart of ``mxnet_tpu/executor.py``.  ``simple_bind`` allocates
every argument once on the bind device; ``forward`` copies the fed
inputs into those buffers and runs the graph's nodes in topological
order, each op launching its own kernels on PyTorch's current stream.
There is no compiled program: PyTorch runs eagerly.

Training: arguments whose ``grad_req`` is ``'write'`` or ``'add'`` are
leaf tensors that require a gradient, and the optimizer updates them in
place.  ``forward(is_train=True)`` records the graph with autograd;
``backward(out_grads=None)`` seeds every head with ones (or the given
``out_grads``) and writes each gradient into ``grad_dict`` (``'write'``
replaces it, ``'add'`` accumulates).  A loss head such as SoftmaxOutput
ignores its seed, as in MXNet.  Inference forwards record nothing.

Auxiliary states (BatchNorm's moving statistics) live in ``aux_dict``,
f32 zeros at bind, and take no gradient.  Ops that declare ``is_train``
are handed the forward's flag; after a train forward, each output an op
declares in ``mutate_inputs`` is copied into its auxiliary state in
place (the JAX package's executor returns the new states instead).

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

_GRAD_REQS = ("write", "add", "null")


def _normalize_grad_req(grad_req, arg_names):
    if isinstance(grad_req, str):
        req = {n: grad_req for n in arg_names}
    elif isinstance(grad_req, dict):
        req = {n: grad_req.get(n, "null") for n in arg_names}
    else:
        raise MXNetError("invalid grad_req %r" % (grad_req,))
    bad = {n: r for n, r in req.items() if r not in _GRAD_REQS}
    if bad:
        raise MXNetError("grad_req must be one of %s, got %s"
                         % (_GRAD_REQS, bad))
    return req


class Executor:
    def __init__(self, symbol, ctx, grad_req, shapes):
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else current_context()
        dev = self._ctx.torch_device
        self._arg_names = symbol.list_arguments()
        self._grad_req = _normalize_grad_req(grad_req, self._arg_names)
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        self._aux_names = symbol.list_auxiliary_states()
        self.aux_dict = {name: NDArray(torch.zeros(shape, dtype=torch.float32,
                                                   device=dev))
                         for name, shape in zip(self._aux_names, aux_shapes)}
        self.arg_dict = {}
        self.grad_dict = {}
        for name, shape in zip(self._arg_names, arg_shapes):
            t = torch.zeros(shape, dtype=torch.float32, device=dev)
            if self._grad_req[name] != "null":
                t.requires_grad_(True)
                self.grad_dict[name] = NDArray(torch.zeros_like(t))
            self.arg_dict[name] = NDArray(t)
        self._nodes = symbol._topo()
        self.outputs = []
        self._heads = None          # the graph-carrying outputs of a train forward

    @property
    def grad_arrays(self):
        """Per argument, its gradient NDArray (None where grad_req is
        'null'), in ``list_arguments`` order."""
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        """The auxiliary states, in ``list_auxiliary_states`` order."""
        return [self.aux_dict[n] for n in self._aux_names]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameter values (NDArrays, tensors or numpy arrays)
        into the bound arguments and auxiliary states of the same
        names."""
        for params, bound, kind in ((arg_params, self.arg_dict, "argument"),
                                    (aux_params or {}, self.aux_dict,
                                     "auxiliary state")):
            for name, value in params.items():
                dst = bound.get(name)
                if dst is None:
                    if allow_extra_params:
                        continue
                    raise MXNetError("copy_params_from: %s is not an %s of "
                                     "the bound symbol" % (name, kind))
                with torch.no_grad():
                    dst._data.copy_(_as_tensor(value, dst.shape, name))

    def _feed(self, feeds):
        for name, value in feeds.items():
            dst = self.arg_dict.get(name)
            if dst is None:
                raise MXNetError("forward: unknown input %s" % name)
            with torch.no_grad():
                dst._data.copy_(_as_tensor(value, dst.shape, name))

    def forward(self, is_train=False, **feeds):
        """Copy ``feeds`` into the bound inputs and run the graph.
        Returns the outputs as NDArrays (also kept in ``outputs``).
        With ``is_train`` the graph is recorded for :meth:`backward`."""
        self._feed(feeds)
        self._heads = None
        is_train = bool(is_train)
        record = is_train and bool(self.grad_dict)
        new_aux = {}
        with torch.set_grad_enabled(record):
            env = {}
            for node in self._nodes:
                if node.is_var:
                    src = self.arg_dict.get(node.name)
                    if src is None:
                        src = self.aux_dict[node.name]
                    env[(id(node), 0)] = src._data
                    continue
                kw = dict(node.attrs, is_train=is_train) \
                    if node.op.takes_is_train else node.attrs
                out = node.op.fn(*[env[(id(n), i)] for n, i in node.inputs],
                                 **kw)
                outs = out if isinstance(out, tuple) else (out,)
                for i, t in enumerate(outs):
                    env[(id(node), i)] = t
                if is_train:
                    for (inp, _), nm in zip(node.inputs,
                                            node.op.input_names):
                        for mut, idx in node.op.mutate_inputs:
                            if nm == mut and inp.is_var \
                                    and inp.name in self.aux_dict:
                                new_aux[inp.name] = outs[idx]
            heads = [env[(id(n), i)] for n, i in self._symbol._entries]
        with torch.no_grad():
            for name, t in new_aux.items():
                self.aux_dict[name]._data.copy_(t)
        if record:
            self._heads = heads
        self.outputs = [NDArray(t.detach()) for t in heads]
        return self.outputs

    def backward(self, out_grads=None):
        """Back-propagate the last ``forward(is_train=True)``: each head
        is seeded with ones, or with ``out_grads`` (one per head, None
        for ones), and every argument's gradient is written into
        ``grad_dict`` according to its ``grad_req``.  The recorded graph
        is freed."""
        if self._heads is None:
            raise MXNetError("backward() needs a forward(is_train=True) "
                             "on an executor bound with gradients")
        heads, self._heads = self._heads, None
        if out_grads is None:
            out_grads = [None] * len(heads)
        elif isinstance(out_grads, (NDArray, torch.Tensor)):
            out_grads = [out_grads]
        if len(out_grads) != len(heads):
            raise MXNetError("backward: %d out_grads for %d outputs"
                             % (len(out_grads), len(heads)))
        outs, seeds = [], []
        for h, g in zip(heads, out_grads):
            if not h.requires_grad:
                continue
            if g is None:
                g = torch.ones_like(h)
            else:
                g = (g._data if isinstance(g, NDArray) else g).to(h)
            outs.append(h)
            seeds.append(g)
        names = [n for n in self._arg_names if n in self.grad_dict]
        leaves = [self.arg_dict[n]._data for n in names]
        grads = torch.autograd.grad(outs, leaves, grad_outputs=seeds,
                                    allow_unused=True) if outs \
            else [None] * len(leaves)
        for name, g in zip(names, grads):
            dst = self.grad_dict[name]
            if self._grad_req[name] == "add":
                if g is not None:
                    dst._data.add_(g)
            elif g is None:
                dst._data.zero_()
            else:
                dst._set_data(g)


def _as_tensor(value, shape, name):
    if isinstance(value, NDArray):
        value = value._data
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(_np.ascontiguousarray(value))
    if tuple(value.shape) != tuple(shape):
        raise MXNetError("%s: shape %s does not match the bound %s"
                         % (name, tuple(value.shape), tuple(shape)))
    return value
