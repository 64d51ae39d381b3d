"""Autograd: imperative differentiation.

Counterpart of ``mxnet_tpu/autograd.py`` (reference
python/mxnet/autograd.py).  The JAX package keeps a tape of its own and
replays it under ``jax.vjp``; here torch's autograd is the tape.
``record()`` turns recording on for this thread, and the op dispatch
(``ndarray/dispatch.py``) runs each op under
``torch.set_grad_enabled(is_recording())``, so a recorded op's outputs
carry their graph.  ``is_training()`` is a separate flag (BatchNorm
reads it): ``record()`` sets both by default, ``pause()``,
``train_mode()`` and ``predict_mode()`` set one or both.

``mark_variables`` (``NDArray.attach_grad``) makes each array a leaf (a
detached tensor that requires a gradient) and gives it a gradient
buffer.  ``backward`` differentiates the heads (a head that is not a
scalar is seeded with ones, or with ``out_grads``) with respect to every
marked array alive in the process, and then ``grad_req='write'``
REPLACES each reached array's gradient (torch would accumulate) while
``'add'`` adds to it; an array the heads do not reach keeps its buffer
as it is.  ``grad`` returns the gradients instead (``create_graph=True``
keeps them differentiable), and ``Function`` wraps a user's
``forward``/``backward`` pair as a ``torch.autograd.Function``.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "mark_variables", "backward", "grad", "Function"]


class _State(threading.local):
    def __init__(self):
        super().__init__()
        self.recording = False
        self.training = False


_state = _State()
# every array with an attached gradient, weakly held: the candidate
# leaves of a backward
_MARKED = weakref.WeakSet()
_marked_lock = threading.Lock()


def is_recording():
    return _state.recording


def is_training():
    return _state.training


class _Scope:
    def __init__(self, recording=None, training=None):
        self._rec, self._train = recording, training
        self._saved = None

    def __enter__(self):
        self._saved = (_state.recording, _state.training)
        if self._rec is not None:
            _state.recording = self._rec
        if self._train is not None:
            _state.training = self._train
        return self

    def __exit__(self, *exc):
        _state.recording, _state.training = self._saved


def record(train_mode=True):
    """Record the ops run in this scope (training mode by default)."""
    return _Scope(recording=True, training=train_mode)


def pause(train_mode=False):
    """Stop recording in this scope."""
    return _Scope(recording=False, training=train_mode)


def train_mode():
    return _Scope(training=True)


def predict_mode():
    return _Scope(training=False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each array a leaf of the graph with ``gradients[i]`` as its
    gradient buffer (``grad_req`` 'write', 'add' or 'null')."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be 'write', 'add' or 'null', "
                             "got %r" % (req,))
        if req != "null" and not v._data.is_floating_point():
            raise MXNetError("attach_grad: a %s array cannot take a "
                             "gradient" % v._data.dtype)
        v._data = v._data.detach().requires_grad_(req != "null")
        v._grad = g if req != "null" else None
        v._grad_req = req
        with _marked_lock:
            if req == "null":
                _MARKED.discard(v)
            else:
                _MARKED.add(v)


def _heads(heads):
    from .ndarray.ndarray import NDArray
    return [heads] if isinstance(heads, NDArray) else list(heads)


def _seeds(heads, head_grads):
    from .ndarray.ndarray import NDArray
    if head_grads is None:
        return [torch.ones_like(h._data) for h in heads]
    if isinstance(head_grads, (NDArray, torch.Tensor)):
        head_grads = [head_grads]
    if len(head_grads) != len(heads):
        raise MXNetError("%d head gradients for %d heads"
                         % (len(head_grads), len(heads)))
    return [torch.ones_like(h._data) if g is None else
            (g._data if isinstance(g, NDArray) else g).to(h._data)
            for h, g in zip(heads, head_grads)]


def _differentiate(heads, head_grads, leaves, retain_graph, create_graph):
    outs, seeds = [], []
    for h, s in zip(heads, _seeds(heads, head_grads)):
        if h._data.requires_grad:
            outs.append(h._data)
            seeds.append(s)
    if not outs:
        raise MXNetError("backward: no head was recorded; run the forward "
                         "inside autograd.record()")
    return torch.autograd.grad(outs, [v._data for v in leaves],
                               grad_outputs=seeds,
                               retain_graph=retain_graph,
                               create_graph=create_graph, allow_unused=True)


def backward(heads, out_grads=None, retain_graph=False, train_mode=True):
    """Differentiate ``heads`` and write each marked array's gradient
    into its buffer by its ``grad_req``.  ``train_mode`` is the
    reference's argument; nothing is replayed here, so it changes
    nothing."""
    heads = _heads(heads)
    with _marked_lock:
        leaves = [v for v in _MARKED if v._data.requires_grad
                  and v._data.is_leaf]
    if not leaves:
        raise MXNetError("backward: no array has a gradient attached "
                         "(call attach_grad or mark_variables first)")
    grads = _differentiate(heads, out_grads, leaves, retain_graph, False)
    with torch.no_grad():
        for v, g in zip(leaves, grads):
            if g is None or v._grad is None:
                continue
            g = g.to(v._grad._data.dtype)
            if v._grad_req == "add":
                v._grad._data.add_(g)
            else:
                v._grad._data = g


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` (arrays
    with attached gradients), returned as new arrays and not written
    into the buffers.  ``create_graph=True`` records them, so they can
    be differentiated again."""
    from .ndarray.ndarray import NDArray
    variables = _heads(variables)
    for v in variables:
        if not (v._data.requires_grad and v._data.is_leaf):
            raise MXNetError("grad: every variable needs attach_grad()")
    retain = create_graph if retain_graph is None else retain_graph
    grads = _differentiate(_heads(heads), head_grads, variables, retain,
                           create_graph)
    return [NDArray(torch.zeros_like(v._data) if g is None else g)
            for v, g in zip(variables, grads)]


class Function:
    """A differentiable function of NDArrays written by the user
    (reference autograd.Function): subclass it with ``forward(*inputs)``
    and ``backward(*output_grads)``, both on NDArrays and run without
    recording; ``save_for_backward`` keeps arrays for the backward in
    ``saved_tensors``."""

    def __init__(self):
        self.saved_tensors = ()

    def save_for_backward(self, *args):
        self.saved_tensors = args

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        fn = self

        def as_list(x):
            return [x] if isinstance(x, NDArray) else list(x)

        class _Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *tensors):
                with pause(train_mode=is_training()):
                    outs = fn.forward(*[NDArray(t) for t in tensors])
                ctx.single = isinstance(outs, NDArray)
                return tuple(o._data for o in as_list(outs))

            @staticmethod
            def backward(ctx, *gs):
                with pause():
                    igrads = fn.backward(*[NDArray(g) for g in gs])
                return tuple(g._data for g in as_list(igrads))

        tensors = [x._data for x in inputs]
        if is_recording():
            outs = _Fn.apply(*tensors)
        else:
            with pause(train_mode=is_training()):
                res = fn.forward(*inputs)
            outs = tuple(o._data for o in as_list(res))
        outputs = [NDArray(t) for t in outs]
        return outputs[0] if len(outputs) == 1 else outputs
