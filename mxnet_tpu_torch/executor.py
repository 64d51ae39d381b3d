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

Every argument and auxiliary state is allocated in the type the
symbol infers for it (``Symbol.infer_shape_type``: float32 unless
``type_dict`` or the same-type rule says otherwise, so bf16 data makes
the weights it meets bf16), and each gradient in its argument's type.
float16 binds, for inference and with gradients, over the ops whose
float16 forms are held against the JAX package (``FLOAT16_OPS``: the
serving symbols', the transformer's training graph's and ResNet's in
both layouts, fused or not); a float16 graph with another op raises
before anything is allocated, naming ROADMAP A.6 (hybridized Gluon
blocks take the same check, ``check_float16_graph``).
Auxiliary states (BatchNorm's moving statistics) live in ``aux_dict``,
zeros at bind, and take no gradient.  Ops that declare ``is_train``
are handed the forward's flag; after a train forward, each output an op
declares in ``mutate_inputs`` is copied into its auxiliary state in
place (the JAX package's executor returns the new states instead).

Gradient mirroring (``MXNET_BACKWARD_DO_MIRROR=1``, read once at bind,
the counterpart of the JAX package's ``jax.checkpoint`` of the whole
forward): a train forward runs without recording and keeps only the
walk's inputs, its step seed and the state of any generator it samples
from; ``backward`` runs the forward again, recorded (the same masks,
slopes and samples), and takes the gradients from it.  The outputs and
the auxiliary states are the first walk's, written once.

Memory: the graph walk (:func:`run_graph`, over a :class:`GraphPlan`
made once at bind) drops each intermediate from its environment right
after the last node that reads it, unless it is a head, as the JAX
package's compiled program frees a buffer at its last use.  Without
that, an inference forward would hold every intermediate until it ends
(a full-width prefill of 8 x 1024 tokens held ~16 GB).  In a recorded
forward autograd keeps what the backward needs, whatever the walk
drops.  The hybridized Gluon path runs its traced graph through the
same walk.

Cache arguments (the paged K/V caches) are updated IN PLACE by the ops
that write them, and the outputs that carry the "new" caches are those
same tensors.  That is the counterpart of the JAX package's buffer
donation: no whole-cache copy in or out of a step.  An executor bound
with ``shared_exec`` holds that executor's NDArrays (the same objects)
for every argument and auxiliary state of the same name, shape and
type, so
a prefill executor and a decode-step executor share one copy of the
weights and write into one set of caches.

Donated forward (:meth:`Executor.donate_args`, the counterpart of the
JAX package's compiled, donated inference program): on the card, an
inference forward of an executor with donated arguments runs as one
CUDA graph.  The first such forward warms the walk up
(``cuda_graph.WARMUP`` eager walks on a side stream, each writing the
same bytes: an inference walk writes only what its inputs determine),
captures it once and replays it; every later one copies its feeds in
through pinned staging and replays.  On the CPU the same forward is
the eager walk: the device decides.  ``dispatches`` counts inference
forwards (one program each, as the JAX package counts its jitted
calls), ``captures`` the graphs captured; a capture after the first
(a bound tensor was replaced) is a retrace.  Executors bound with
``shared_exec`` capture into one graph memory pool.
"""
from __future__ import annotations

import numpy as _np
import torch

from . import config as _config
from . import random as _random
from .base import FLOAT16_OPS_LATER, MXNetError, numpy_to_tensor
from .context import current_context
from .cuda_graph import WARMUP, GraphPool, Program, Staging
from .ndarray.ndarray import NDArray

__all__ = ["Executor", "GraphPlan", "run_graph", "check_float16_graph",
           "sampler_state", "recompute_graph"]

_GRAD_REQS = ("write", "add", "null")
# the ops a float16 graph may hold, each with its float16 forward and
# backward held against the JAX package: those of the five serving
# symbols and of the transformer's training graph (models/transformer.py,
# with the loss head and the MLP's activation), and those of ResNet's
# (models/resnet.py in NCHW and NHWC, with symbol/fuse.py's fused op, the
# f16 forms of rows 7 and 10; also the model zoo's ResNets), and Dropout
# (the transformer's, in every type), and Deconvolution, every LeakyReLU
# act and CausalSelfAttention (tests/test_torch_deconvolution.py,
# test_torch_leaky_relu.py, test_torch_causal_attention.py); the float16
# forms of the other ops wait for ROADMAP A.6
FLOAT16_OPS = frozenset((
    "Activation", "BatchNorm", "Cast", "Concat", "Convolution",
    "Deconvolution", "Dropout", "Embedding", "Flatten", "FullyConnected",
    "LayerNorm", "LeakyReLU", "Pooling", "Reshape", "SoftmaxOutput",
    "_FusedBNReluConv", "_contrib_CausalSelfAttention",
    "_contrib_FusedCausalSelfAttention", "_contrib_GatherTimestep",
    "_contrib_PagedChunkPrefillAttention", "_contrib_PagedDecodeAttention",
    "_contrib_PagedPrefillAttention", "_minus_scalar", "_plus_scalar",
    "argmax", "broadcast_add", "broadcast_equal", "broadcast_mul",
    "broadcast_sub", "slice_axis", "take"))


def check_float16_graph(nodes, types, where):
    """A float16 graph runs over FLOAT16_OPS only: when ``types`` (its
    variables' types) hold float16, raises for any node of ``nodes``
    with another op, naming them and ROADMAP A.6, before anything is
    allocated or run.  ``simple_bind`` and hybridized Gluon blocks
    (``gluon/block.py``) call it."""
    if torch.float16 not in types:
        return
    other = sorted({n.op.name for n in nodes
                    if not n.is_var and n.op.name not in FLOAT16_OPS})
    if other:
        raise MXNetError("%s: a float16 graph with %s; %s"
                         % (where, ", ".join(other), FLOAT16_OPS_LATER))


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


class GraphPlan:
    """A symbol's nodes in topological order, its heads, and after each
    node the environment entries (``(id(node), output)``) that no later
    node reads and that are not heads: the walk drops them there.
    ``draws`` says whether an op of the graph draws random numbers (a
    walk then needs a step seed, ``random.StepRandom``), ``samples``
    whether one samples from the device's generator (``ops/
    random_ops.py``: a mirrored recompute replays its state)."""

    def __init__(self, symbol):
        self.nodes = symbol._topo()
        self.draws = any(not n.is_var and n.op.draws(n.attrs)
                         for n in self.nodes)
        self.samples = any(not n.is_var and n.op.name.startswith("_random_")
                           for n in self.nodes)
        self.heads = list(symbol._entries)
        head_keys = {(id(n), i) for n, i in self.heads}
        last = {}
        for pos, node in enumerate(self.nodes):
            for inp, i in node.inputs:
                last[(id(inp), i)] = pos
        self.drop_after = [[] for _ in self.nodes]
        for pos, node in enumerate(self.nodes):
            n_out = 1 if node.is_var else node.op.out_count(node.attrs)
            for i in range(n_out):
                key = (id(node), i)
                if key not in head_keys:
                    self.drop_after[last.get(key, pos)].append(key)


def run_graph(plan, values, is_train, rng=None):
    """Run ``plan``'s nodes on ``values`` (variable name -> tensor), each
    op on the current stream, dropping every entry after its last
    reader.  Ops that declare ``is_train`` get the flag, ops that draw
    (``rng``) the walk's ``random.StepRandom`` ``rng``, ops that make a
    tensor from no input (``device``) the device of ``values``.  Returns the
    head tensors and, for a train walk, ``{variable name: new value}``
    of the variables the ops mutate (``OpDef.mutate_inputs``)."""
    env, new_aux = {}, {}
    device = None
    for pos, node in enumerate(plan.nodes):
        if node.is_var:
            env[(id(node), 0)] = values[node.name]
        else:
            kw = node.attrs
            op = node.op
            if op.takes_is_train or op.takes_rng or op.takes_device:
                kw = dict(kw)
                if op.takes_is_train:
                    kw["is_train"] = is_train
                if op.takes_rng:
                    kw["rng"] = rng
                if op.takes_device:
                    if device is None and values:
                        device = next(iter(values.values())).device
                    kw["device"] = device
            out = node.op.fn(*[env[(id(n), i)] for n, i in node.inputs],
                             **kw)
            outs = out if isinstance(out, tuple) else (out,)
            for i, t in enumerate(outs):
                env[(id(node), i)] = t
            if is_train:
                for (inp, _), nm in zip(node.inputs, node.op.input_names):
                    for mut, idx in node.op.mutate_inputs:
                        if nm == mut and inp.is_var:
                            new_aux[inp.name] = outs[idx]
        for key in plan.drop_after[pos]:
            del env[key]
    return [env[(id(n), i)] for n, i in plan.heads], new_aux


def sampler_state(plan, device):
    """``(generator, state)`` of ``device``'s generator before a walk of
    ``plan`` that samples from it, else None: what
    :func:`recompute_graph` replays."""
    if not plan.samples:
        return None
    gen = _random.generator(device)
    return gen, gen.get_state()


def recompute_graph(plan, values, seed, sampler=None):
    """The recompute of gradient mirroring (``MXNET_BACKWARD_DO_MIRROR``):
    ``plan``'s train walk on ``values`` once more, recorded by autograd,
    from the step seed ``seed`` of the first walk, so every Dropout mask
    and ``rrelu`` slope replays, and with the generator of ``sampler``
    (:func:`sampler_state`) set back to where the first walk started and
    restored after, so no generator advances.  Its new auxiliary values
    are dropped: the first walk wrote them (BatchNorm's moving
    statistics move once a step).  Returns the heads."""
    if sampler is not None:
        gen, start = sampler
        now = gen.get_state()
        gen.set_state(start)
    try:
        rng = _random.StepRandom(seed) if seed is not None else None
        with torch.enable_grad():
            return run_graph(plan, values, True, rng)[0]
    finally:
        if sampler is not None:
            gen.set_state(now)


class Executor:
    def __init__(self, symbol, ctx, grad_req, shapes, shared_exec=None,
                 type_dict=None):
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else current_context()
        dev = self._ctx.torch_device
        self._arg_names = symbol.list_arguments()
        self._grad_req = _normalize_grad_req(grad_req, self._arg_names)
        arg_shapes, arg_types, aux_shapes, aux_types = \
            symbol.infer_shape_type(shapes, type_dict)
        check_float16_graph(symbol._topo(), list(arg_types) + list(aux_types),
                            "simple_bind")
        self._aux_names = symbol.list_auxiliary_states()

        arg_pool = shared_exec.arg_dict if shared_exec is not None else {}
        aux_pool = shared_exec.aux_dict if shared_exec is not None else {}

        def shared(pool, name, shape, dtype):
            nd = pool.get(name)
            return nd if nd is not None and nd.shape == tuple(shape) \
                and nd._data.dtype == dtype else None

        self.aux_dict = {}
        for name, shape, dt in zip(self._aux_names, aux_shapes, aux_types):
            nd = shared(aux_pool, name, shape, dt)
            self.aux_dict[name] = nd if nd is not None else \
                NDArray(torch.zeros(shape, dtype=dt, device=dev))
        self.arg_dict = {}
        self.grad_dict = {}
        grad_pool = shared_exec.grad_dict if shared_exec is not None else {}
        for name, shape, dt in zip(self._arg_names, arg_shapes, arg_types):
            nd = shared(arg_pool, name, shape, dt)
            from_pool = nd is not None
            if nd is None:
                nd = NDArray(torch.zeros(shape, dtype=dt, device=dev))
            if self._grad_req[name] != "null":
                nd._data.requires_grad_(True)
                # a shared argument shares its gradient too (one copy of
                # each for a Module's executors of several batch shapes)
                self.grad_dict[name] = grad_pool[name] \
                    if from_pool and name in grad_pool \
                    else NDArray(torch.zeros_like(nd._data))
            self.arg_dict[name] = nd
        self._plan = GraphPlan(symbol)
        self.outputs = []
        self._heads = None          # the graph-carrying outputs of a train forward
        self._device = dev
        # the donated forward: one graph pool per shared_exec family
        self._graph_pool = shared_exec._graph_pool \
            if shared_exec is not None else GraphPool()
        self._donated_names = ()
        self._program = None        # the captured forward
        self._program_bound = None  # the bound tensors it captured
        self._program_outputs = []  # its static outputs, as NDArrays
        self._staging = {}
        # the donated forward's step seed (graphs with an op that draws)
        self._seed = torch.zeros((), dtype=torch.int64, device=dev) \
            if self._plan.draws else None
        self.dispatches = 0         # inference forwards
        self.captures = 0           # graphs captured
        # MXNET_BACKWARD_DO_MIRROR at bind: a train forward keeps only
        # the walk's inputs, seed and sampler state (_recompute), and
        # backward walks again; a later change of the variable affects
        # later binds only
        self._mirror = _config.backward_do_mirror()
        self._recompute = None

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
        names, each cast to its bound type by ``copy_`` (f32 parameters
        into a bf16 binding are rounded once, to nearest even, as the
        JAX package's ``astype``)."""
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
        """Copy each fed input into its bound tensor, cast to the bound
        type by ``copy_`` (index inputs bind f32, so block ids and
        positions stay exact)."""
        for name, value in feeds.items():
            dst = self.arg_dict.get(name)
            if dst is None:
                raise MXNetError("forward: unknown input %s" % name)
            with torch.no_grad():
                dst._data.copy_(_as_tensor(value, dst.shape, name))

    def donate_args(self, names):
        """Run every later inference forward as one captured CUDA graph
        (on the card) that updates the named arguments in place: the
        counterpart of the JAX package's donated forward, whose
        signature this keeps.  The named arguments are the state a
        forward writes (the decode engine's K/V caches) or the inputs it
        consumes; the caller keeps nothing of theirs across a forward.

        CONTRACT: the outputs of a donated forward are the graph's
        static tensors, valid until the next forward of this executor or
        of one that shares its graph pool (bound with ``shared_exec``);
        read or copy them before that.  (The JAX package's donated
        NDArrays hold deleted buffers instead; the port updates the
        caches where they live, so they stay valid.)  Copy new values
        INTO bound tensors (``copy_params_from``): a replaced bound
        tensor makes the next forward capture again, a retrace.  Train
        forwards stay eager.  Raises ``MXNetError`` on an unknown name;
        an empty sequence turns donation off.  Returns True."""
        names = tuple(names)
        for n in names:
            if n not in self.arg_dict:
                raise MXNetError("donate_args: unknown argument '%s'" % n)
        # the captured walk does not depend on the names: a graph already
        # captured serves again when donation comes back on
        self._donated_names = names
        return True

    @property
    def retraces(self):
        """Captures after the first: each one a bound tensor replaced
        under a captured forward."""
        return max(self.captures - 1, 0)

    def captured_launches(self, by_dtype=False):
        """The kernel launches recorded in the captured forward, by
        kernel (``by_dtype``: by ``"name:dtype"``); one replay runs
        exactly these.  Empty before a capture."""
        prog = self._program
        if prog is None:
            return {}
        return dict(prog.captured_by_dtype if by_dtype else prog.captured)

    def _symbol_label(self):
        outs = self._symbol.list_outputs()
        return ", ".join(outs[:3]) + (", ..." if len(outs) > 3 else "")

    def _forward_donated(self, feeds):
        """Stage ``feeds`` and replay the captured forward, capturing it
        first when there is none or a bound tensor was replaced."""
        for name, value in feeds.items():
            dst = self.arg_dict.get(name)
            if dst is None:
                raise MXNetError("forward: unknown input %s" % name)
            stage = self._staging.get(name)
            if stage is None or stage.target is not dst._data:
                stage = self._staging[name] = Staging(dst._data)
            with torch.no_grad():
                stage.put(_as_tensor(value, dst.shape, name))
        self._heads = self._recompute = None
        if self._seed is not None:
            _random.next_seed(self._device, out=self._seed)
        bound = tuple(id(nd._data) for nd in self.arg_dict.values()) \
            + tuple(id(nd._data) for nd in self.aux_dict.values())
        if self._program is not None and bound == self._program_bound:
            self._program.replay()
            self.outputs = list(self._program_outputs)
            return self.outputs
        # the old graph, if any, lives until the new one is captured: a
        # capture into a pool needs a live graph of it (cuda_graph.py)

        # closes over the dicts, not the executor: no reference cycle
        # holds a dropped executor's tensors and graph
        args, auxs, plan, seed = self.arg_dict, self.aux_dict, self._plan, \
            self._seed

        def body():
            values = {n: nd._data for n, nd in auxs.items()}
            values.update((n, nd._data) for n, nd in args.items())
            rng = _random.StepRandom(seed) if seed is not None else None
            with torch.no_grad():
                return run_graph(plan, values, False, rng)[0]

        prog = Program(body, self._device,
                       "donated forward of (%s)" % self._symbol_label(),
                       "donate_args(()) keeps the eager walk",
                       pool=self._graph_pool)
        for _ in range(WARMUP):
            prog.warm_up()
        outs = prog.capture()
        self.captures += 1
        self._program, self._program_bound = prog, bound
        self._program_outputs = [NDArray(t) for t in outs]
        self.outputs = list(self._program_outputs)
        return self.outputs

    def forward(self, is_train=False, **feeds):
        """Copy ``feeds`` into the bound inputs and run the graph.
        Returns the outputs as NDArrays (also kept in ``outputs``).
        With ``is_train`` the graph is recorded for :meth:`backward`.
        An inference forward of an executor with donated arguments
        replays its captured graph on the card (:meth:`donate_args`)."""
        is_train = bool(is_train)
        if not is_train:
            self.dispatches += 1
            if self._donated_names and self._device.type == "cuda":
                return self._forward_donated(feeds)
        self._feed(feeds)
        self._heads = self._recompute = None
        record = is_train and bool(self.grad_dict)
        values = {n: nd._data for n, nd in self.aux_dict.items()}
        values.update((n, nd._data) for n, nd in self.arg_dict.items())
        seed = _random.next_seed(self._device) if self._plan.draws else None
        rng = _random.StepRandom(seed) if seed is not None else None
        mirror = record and self._mirror
        sampler = sampler_state(self._plan, self._device) if mirror else None
        with torch.set_grad_enabled(record and not mirror):
            heads, new_aux = run_graph(self._plan, values, is_train, rng)
        with torch.no_grad():
            for name, t in new_aux.items():
                if name in self.aux_dict:
                    self.aux_dict[name]._data.copy_(t)
        if mirror:
            self._recompute = (values, seed, sampler)
        elif record:
            self._heads = heads
        self.outputs = [NDArray(t.detach()) for t in heads]
        return self.outputs

    def backward(self, out_grads=None):
        """Back-propagate the last ``forward(is_train=True)``: each head
        is seeded with ones, or with ``out_grads`` (one per head, None
        for ones), and every argument's gradient is written into
        ``grad_dict`` according to its ``grad_req``.  The recorded graph
        is freed."""
        if self._recompute is not None:
            # mirrored: the forward again, recorded, from the same inputs,
            # seed and sampler state
            values, seed, sampler = self._recompute
            self._recompute = None
            self._heads = recompute_graph(self._plan, values, seed, sampler)
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
        value = numpy_to_tensor(_np.asarray(value))
    if tuple(value.shape) != tuple(shape):
        raise MXNetError("%s: shape %s does not match the bound %s"
                         % (name, tuple(value.shape), tuple(shape)))
    return value
