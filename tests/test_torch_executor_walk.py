"""PyTorch port: the executor's graph walk frees each intermediate after
its last reader (``executor.GraphPlan``/``run_graph``).

The prefill and training executors of a small transformer give the
same outputs, bit for bit, as a walk that keeps every entry to the end
(the walk before the change, written out here), and, in an inference
forward, no intermediate outlives its last reader: each op is wrapped
to hold weak references to what it returns, and at every later node
the outputs whose last reader has run must be gone.
"""
import weakref

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.executor import GraphPlan, run_graph
from mxnet_tpu_torch.models import transformer

CFG = dict(num_classes=50, num_layers=2, d_model=16, num_heads=2, seq_len=48)
GEO = dict(block_size=4, num_blocks=16)


def _keep_all_walk(symbol, values, is_train):
    """The executor's walk as it was: every entry kept to the end."""
    env = {}
    for node in symbol._topo():
        if node.is_var:
            env[(id(node), 0)] = values[node.name]
            continue
        kw = dict(node.attrs, is_train=is_train) \
            if node.op.takes_is_train else node.attrs
        out = node.op.fn(*[env[(id(n), i)] for n, i in node.inputs], **kw)
        for i, t in enumerate(out if isinstance(out, tuple) else (out,)):
            env[(id(node), i)] = t
    return [env[(id(n), i)] for n, i in symbol._entries]


def _fill(exe, rng, skip):
    for name, nd in exe.arg_dict.items():
        if name not in skip and not name.endswith("_cache"):
            nd[:] = (rng.randn(*nd.shape) * 0.1).astype(np.float32)


def _prefill_exe():
    sym = transformer.get_prefill_symbol(prefill_len=16, **GEO, **CFG)
    shapes = dict(data=(2, 16), prompt_len=(2,), block_table=(2, 12))
    exe = sym.simple_bind(ctx=mx.cpu(), grad_req="null", **shapes)
    rng = np.random.RandomState(0)
    _fill(exe, rng, shapes)
    feeds = dict(data=rng.randint(0, 50, (2, 16)).astype(np.float32),
                 prompt_len=np.array([16, 9], np.float32),
                 block_table=np.arange(24).reshape(2, 12).astype(np.float32))
    return sym, exe, feeds


def _values(exe):
    vals = {n: nd._data for n, nd in exe.aux_dict.items()}
    vals.update((n, nd._data) for n, nd in exe.arg_dict.items())
    return vals


def test_prefill_outputs_unchanged_and_nothing_outlives_its_reader():
    sym, exe, feeds = _prefill_exe()
    exe._feed(feeds)
    caches = {n: nd._data.clone() for n, nd in exe.arg_dict.items()
              if n.endswith("_cache")}
    with torch.no_grad():
        ref = [t.clone() for t in _keep_all_walk(sym, _values(exe), False)]
    for n, t in caches.items():
        exe.arg_dict[n]._data.copy_(t)
    # a plan whose ops record weak references to their outputs
    plan = GraphPlan(sym)
    last_reader, pos_of = {}, {}
    for pos, node in enumerate(plan.nodes):
        pos_of[id(node)] = pos
        for inp, i in node.inputs:
            last_reader[(id(inp), i)] = pos
    heads = {(id(n), i) for n, i in plan.heads}
    inputs = {id(t) for t in _values(exe).values()}
    born = []                # (key, weakref, position of the last reader)
    checked = [0]

    class _Watch:
        def __init__(self, node):
            self._op, self._node = node.op, node

        def __getattr__(self, name):
            return getattr(self._op, name)

        def fn(self, *args, **kw):
            pos = pos_of[id(self._node)]
            for key, ref_, last in born:
                if last < pos and key not in heads:
                    assert ref_() is None, "entry %s outlived its last " \
                        "reader (node %d, now %d)" % (key, last, pos)
                    checked[0] += 1
            out = self._op.fn(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            for i, t in enumerate(outs):
                key = (id(self._node), i)
                if id(t) not in inputs and key in last_reader:
                    born.append((key, weakref.ref(t), last_reader[key]))
            return out

    saved = [(n, n.op) for n in plan.nodes if not n.is_var]
    try:
        for node, _ in saved:
            node.op = _Watch(node)
        with torch.no_grad():
            got, _ = run_graph(plan, _values(exe), False)
    finally:
        for node, op in saved:
            node.op = op
    assert checked[0] > 100
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # and through Executor.forward
    for n, t in caches.items():
        exe.arg_dict[n]._data.copy_(t)
    outs = exe.forward(is_train=False, **feeds)
    assert torch.equal(outs[0]._data, ref[0])


def test_train_outputs_and_gradients_unchanged():
    """Both walks run at one intra-op thread, so the CPU's matrix
    products and reductions split their sums the same way in each: the
    comparison is bit for bit, and a thread count that changed between
    the two walks (other processes loading the cores) would move the
    last bits of a sum without any difference between the walks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check_train_walks()
    finally:
        torch.set_num_threads(threads)


def _check_train_walks():
    sym = transformer.get_symbol(**CFG)
    shapes = dict(data=(2, CFG["seq_len"]), softmax_label=(2 * CFG["seq_len"],))
    exe = sym.simple_bind(ctx=mx.cpu(), grad_req="write", **shapes)
    rng = np.random.RandomState(1)
    _fill(exe, rng, shapes)
    feeds = dict(data=rng.randint(0, 50, shapes["data"]).astype(np.float32),
                 softmax_label=rng.randint(0, 50, shapes["softmax_label"])
                 .astype(np.float32))
    out = exe.forward(is_train=True, **feeds)[0]._data.clone()
    exe.backward()
    grads = {n: g._data.clone() for n, g in exe.grad_dict.items()}
    values = _values(exe)
    with torch.enable_grad():
        (ref,) = _keep_all_walk(sym, values, True)
        leaves = [values[n] for n in grads]
        ref_grads = torch.autograd.grad([ref], leaves,
                                        [torch.ones_like(ref)],
                                        allow_unused=True)
    assert torch.equal(out, ref.detach())
    for (name, g), r in zip(grads.items(), ref_grads):
        if r is None:
            assert not g.any(), name
        else:
            assert torch.equal(g, r), name


@pytest.mark.parametrize("n_outputs_read", [0, 1])
def test_plan_drops_unread_outputs_at_their_node(n_outputs_read):
    """An output nobody reads (BatchNorm's statistics) is dropped right
    after its node; a head is never dropped."""
    data = mx.sym.Variable("data")
    bn = mx.sym.BatchNorm(data, name="bn", output_mean_var=True)
    out = mx.sym.Group([bn[0]] if n_outputs_read == 0 else [bn[0], bn[1]])
    plan = GraphPlan(out)
    node = [n for n in plan.nodes if not n.is_var][0]
    pos = plan.nodes.index(node)
    dropped = {k for k in plan.drop_after[pos] if k[0] == id(node)}
    kept = {(id(node), 0)} | ({(id(node), 1)} if n_outputs_read else set())
    assert dropped == {(id(node), i) for i in range(5)} - kept
