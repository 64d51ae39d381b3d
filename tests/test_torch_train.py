"""PyTorch port: the training slice against the JAX package.

The tiny transformer of tests/test_layout_and_bn.py (vocab 61, 2 layers,
d 32, 4 heads, seq 12, batch 4) goes through both packages on the CPU
from the same numpy weights and data: the symbol, the executor's
gradients, the optimizers, the data iterator, the metrics and
``Module.fit`` as a whole, then a trained model served by both
packages' decode engines.  The JAX side runs LayerNorm through its
Pallas kernels in interpret mode; the port's kernels take their plain
versions on CPU tensors.  Tolerances are stated per test.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.decode import DecodeEngine as JaxEngine
from mxnet_tpu.models import transformer as jtransformer

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.decode import DecodeEngine
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.weights import convert_params, export_params, param_shapes

CFG = dict(num_classes=61, num_layers=2, d_model=32, num_heads=4, seq_len=12)
B, S = 4, 12
SHAPES = dict(data=(B, S), softmax_label=(B * S,))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The tensors here are tiny and gain nothing from many intra-op
    threads; two keep this file off the cores that timing-sensitive
    tests running beside it in other workers measure."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("MXNET_PAGED_ATTN_IMPL", "pallas")
    monkeypatch.setenv("MXNET_LN_IMPL", "pallas")


@pytest.fixture(scope="module")
def params():
    rng = np.random.RandomState(41)
    out = {}
    for n, s in param_shapes(CFG).items():
        a = (rng.randn(*s) * 0.1).astype(np.float32)
        out[n] = a + 1 if n.endswith("_gamma") else a
    return out


def _tokens(rng, n):
    """n sequences of random tokens and their next-token targets."""
    x = rng.randint(0, CFG["num_classes"], (n, S)).astype(np.float32)
    return x, np.roll(x, -1, axis=1)


class _FlatLabels:
    """An NDArrayIter whose (B, S) label batches are flattened to the
    (B * S,) targets that SoftmaxOutput over the (B * S, vocab) logits
    takes.  ``pkg`` is either package; ``flat`` flattens one label
    NDArray of it."""

    def __init__(self, it, pkg, flat):
        self.it, self.pkg, self.flat = it, pkg, flat

    @property
    def provide_data(self):
        return self.it.provide_data

    @property
    def provide_label(self):
        return [self.pkg.io.DataDesc(d.name, (int(np.prod(d.shape)),))
                for d in self.it.provide_label]

    def __iter__(self):
        return self

    def __next__(self):
        b = next(self.it)
        return self.pkg.io.DataBatch(data=b.data,
                                     label=[self.flat(x) for x in b.label],
                                     pad=b.pad)

    def reset(self):
        self.it.reset()


def _port_flat(x):
    return mx.nd.NDArray(x._data.reshape(-1))


def _jax_flat(x):
    return x.reshape((-1,))


# ----------------------------------------------------------------------
# symbol
# ----------------------------------------------------------------------
def test_symbol_matches_jax():
    """Same arguments in the same order, same inferred shapes, same
    outputs and the same variable attributes (``init=``, declared
    shapes)."""
    jsym = jtransformer.get_symbol(**CFG)
    sym = transformer.get_symbol(**CFG)
    assert sym.list_arguments() == jsym.list_arguments()
    assert sym.list_outputs() == jsym.list_outputs()
    assert sym.list_auxiliary_states() == jsym.list_auxiliary_states() == []
    ja, jo, _ = jsym.infer_shape(**SHAPES)
    a, o, _ = sym.infer_shape(**SHAPES)
    assert [tuple(s) for s in a] == [tuple(s) for s in ja]
    assert [tuple(s) for s in o] == [tuple(s) for s in jo]
    jattrs = {n: v for n, v in jsym.attr_dict().items()
              if n in jsym.list_arguments()}
    assert sym.attr_dict() == jattrs
    assert sum("__init__" in v for v in jattrs.values()) == \
        4 * CFG["num_layers"]          # the four biases of each layer


def test_param_shapes_serve_the_training_symbol():
    """The mixed decode step and the training symbol bind one parameter
    set: ``param_shapes`` is both."""
    sym = transformer.get_symbol(**CFG)
    shapes, _, _ = sym.infer_shape(**SHAPES)
    train = {n: tuple(s) for n, s in zip(sym.list_arguments(), shapes)
             if n not in SHAPES}
    assert train == {n: tuple(s) for n, s in param_shapes(CFG).items()}


@pytest.mark.parametrize("bad,match", [
    (dict(moe_experts=4), "MoE"), (dict(tensor_parallel="mp"), "multi-GPU"),
    (dict(dtype="float64"), "float64")])
def test_get_symbol_raises_for_later_slices(bad, match):
    with pytest.raises(mx.MXNetError, match=match):
        transformer.get_symbol(**CFG, **bad)


def test_variable_attributes_and_sharding():
    v = mx.sym.Variable("w", lr_mult=0.5, init=mx.init.Xavier(), __foo__=1)
    attrs = v.attr_dict()["w"]
    jv = jmx.sym.Variable("w", lr_mult=0.5, init=jmx.init.Xavier(),
                          __foo__=1)
    assert attrs == jv.attr_dict()["w"]
    with pytest.raises(mx.MXNetError, match="multi-GPU"):
        mx.sym.Variable("w", __sharding__="('mp', None)")


# ----------------------------------------------------------------------
# executor
# ----------------------------------------------------------------------
def test_executor_gradients_match_jax(pallas, params):
    """Every parameter's gradient after one forward/backward of the
    training symbol equals the JAX executor's (rtol 1e-4 / atol 1e-6:
    the gradients sum over 48 tokens in another order); the outputs
    agree at the f32 bound.  grad_req 'add' accumulates a second
    backward."""
    rng = np.random.RandomState(43)
    x, y = _tokens(rng, B)
    feeds = dict(data=x, softmax_label=y.reshape(-1))
    req = {n: "write" for n in params}

    jexe = jtransformer.get_symbol(**CFG).simple_bind(
        ctx=jmx.cpu(), grad_req=req, **SHAPES)
    jexe.copy_params_from({k: jmx.nd.array(v) for k, v in params.items()})
    jout = jexe.forward(is_train=True, **feeds)[0].asnumpy()
    jexe.backward()

    exe = transformer.get_symbol(**CFG).simple_bind(
        ctx=mx.cpu(), grad_req=req, **SHAPES)
    exe.copy_params_from(params)
    out = exe.forward(is_train=True, **feeds)[0].asnumpy()
    exe.backward()
    np.testing.assert_allclose(out, jout, rtol=2e-5, atol=1e-6)
    assert sorted(exe.grad_dict) == sorted(params)
    for name in params:
        np.testing.assert_allclose(exe.grad_dict[name].asnumpy(),
                                   jexe.grad_dict[name].asnumpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)

    add = transformer.get_symbol(**CFG).simple_bind(
        ctx=mx.cpu(), grad_req={n: "add" for n in params}, **SHAPES)
    add.copy_params_from(params)
    for _ in range(2):
        add.forward(is_train=True, **feeds)
        add.backward()
    for name in params:
        np.testing.assert_allclose(add.grad_dict[name].asnumpy(),
                                   2 * exe.grad_dict[name].asnumpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_executor_backward_needs_a_train_forward(params):
    exe = transformer.get_symbol(**CFG).simple_bind(
        ctx=mx.cpu(), grad_req="write", **SHAPES)
    exe.forward(is_train=False, data=np.zeros((B, S), np.float32))
    with pytest.raises(mx.MXNetError, match="is_train=True"):
        exe.backward()
    with pytest.raises(mx.MXNetError, match="grad_req"):
        transformer.get_symbol(**CFG).simple_bind(ctx=mx.cpu(),
                                                  grad_req="sum", **SHAPES)


# ----------------------------------------------------------------------
# optimizer, iterator, metrics, initializer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("sgd", dict(learning_rate=0.1)),
    ("adam", dict(learning_rate=0.01))])
def test_optimizer_updates_match_jax(name, kw):
    """Three updates of a weight (wd, rescale_grad, clip_gradient, an
    lr_mult from the symbol) and of a bias (wd 0 by name) equal the JAX
    optimizer's at the f32 bound (rtol 2e-5 / atol 1e-6)."""
    rng = np.random.RandomState(47)
    w0 = {"fc_weight": _r(rng, 5, 3), "fc_bias": _r(rng, 5)}
    grads = [{n: _r(rng, *a.shape) * 4 for n, a in w0.items()}
             for _ in range(3)]
    kw = dict(kw, wd=0.01, rescale_grad=0.5, clip_gradient=0.7,
              param_idx2name={0: "fc_weight", 1: "fc_bias"})

    def run(pkg, arr):
        sym = pkg.sym.Group([pkg.sym.Variable("fc_weight", lr_mult=0.5),
                             pkg.sym.Variable("fc_bias")])
        upd = pkg.optimizer.get_updater(
            pkg.optimizer.create(name, sym=sym, **kw))
        ws = [arr(w0["fc_weight"]), arr(w0["fc_bias"])]
        for g in grads:
            for i, n in enumerate(("fc_weight", "fc_bias")):
                upd(i, arr(g[n]), ws[i])
        return [w.asnumpy() for w in ws]

    ref = run(jmx, jmx.nd.array)
    got = run(mx, lambda a: mx.nd.array(a, ctx=mx.cpu()))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, r, rtol=2e-5, atol=1e-6)
        assert not np.allclose(a, w0["fc_weight" if a.ndim == 2
                                     else "fc_bias"])


def _r(rng, *shape):
    return (rng.randn(*shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("last", ["pad", "discard"])
def test_ndarray_iter_matches_jax(last):
    """Shuffled batches over two epochs, with the last partial batch
    padded or dropped: the same data, labels and pads as the JAX
    iterator after numpy.random.seed of the same seed."""
    rng = np.random.RandomState(53)
    x, y = rng.randn(10, 3).astype(np.float32), np.arange(10.0)
    np.random.seed(5)
    jit = jmx.io.NDArrayIter(x, y, batch_size=4, shuffle=True,
                             last_batch_handle=last)
    mx.random.seed(5)
    it = mx.io.NDArrayIter(x, y, batch_size=4, shuffle=True,
                           last_batch_handle=last)
    assert [tuple(d) for d in it.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    for _ in range(2):
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
               for b in it]
        ref = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
               for b in jit]
        assert len(got) == len(ref) == (3 if last == "pad" else 2)
        for (d, l, p), (rd, rl, rp) in zip(got, ref):
            np.testing.assert_array_equal(d, rd)
            np.testing.assert_array_equal(l, rl)
            assert p == rp
        it.reset()
        jit.reset()


@pytest.mark.parametrize("name", ["acc", "ce", "perplexity"])
def test_metrics_match_jax(name):
    rng = np.random.RandomState(59)
    prob = rng.rand(2, 6, 5).astype(np.float32) + 0.05
    prob /= prob.sum(-1, keepdims=True)
    label = rng.randint(0, 5, (2, 6)).astype(np.float32)
    jm, m = jmx.metric.create(name), mx.metric.create(name)
    for i in range(2):
        jm.update([jmx.nd.array(label[i])], [jmx.nd.array(prob[i])])
        m.update([mx.nd.array(label[i], ctx=mx.cpu())],
                 [mx.nd.array(prob[i], ctx=mx.cpu())])
    assert m.get()[0] == jm.get()[0]
    np.testing.assert_allclose(m.get()[1], jm.get()[1], rtol=1e-6)


def test_initializer_dispatch_and_seed():
    """Module.init_params with Xavier: ``init=Zero()`` biases are zero,
    LayerNorm gammas one and betas zero, weights within the Xavier
    bound of their fans; the same seed gives the same weights."""
    def init(seed):
        mx.random.seed(seed)
        mod = mx.Module(transformer.get_symbol(**CFG), context=mx.cpu())
        mod.bind(data_shapes=[("data", (B, S))],
                 label_shapes=[("softmax_label", (B * S,))])
        mod.init_params(mx.init.Xavier(magnitude=3))
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    a, b, c = init(7), init(7), init(8)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["lm_head_weight"], c["lm_head_weight"])
    for name, v in a.items():
        if name.endswith("_bias") or name.endswith("_beta"):
            assert not v.any(), name
        elif name.endswith("_gamma"):
            assert (v == 1).all(), name
        else:
            fan_out, fan_in = v.shape[0], v.shape[1] * int(
                np.prod(v.shape[2:]))
            hw = int(np.prod(v.shape[2:]))
            bound = np.sqrt(3.0 / ((fan_in + fan_out * hw) / 2.0))
            assert np.abs(v).max() <= bound and v.std() > bound / 4, name


# ----------------------------------------------------------------------
# Module
# ----------------------------------------------------------------------
def _fit(pkg, arg_params, seed, flat, ctx, metric, **kw):
    rng = np.random.RandomState(61)
    x, y = _tokens(rng, 3 * B)
    if pkg is mx:
        mx.random.seed(seed)
    else:
        np.random.seed(seed)
    it = _FlatLabels(pkg.io.NDArrayIter(x, y, batch_size=B, shuffle=True),
                     pkg, flat)
    model = jtransformer if pkg is jmx else transformer
    mod = pkg.mod.Module(model.get_symbol(**CFG), context=ctx)
    mod.fit(it, num_epoch=2, optimizer="sgd", eval_metric=metric,
            arg_params=arg_params,
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9,
                              "wd": 1e-3}, **kw)
    return mod


def test_module_fit_matches_jax(pallas, params):
    """Module.fit over 2 epochs of 3 shuffled batches (SGD with
    momentum and wd, perplexity metric) from the same numpy weights ends
    with the same parameters (rtol 1e-4 of each parameter's largest
    value: six steps of sums in another order) and the same last-epoch
    perplexity (rtol 1e-5) as the JAX package's Module.fit."""
    jm = jmx.metric.Perplexity()
    jmod = _fit(jmx, {k: jmx.nd.array(v) for k, v in params.items()}, 3,
                _jax_flat, jmx.cpu(), jm)
    m = mx.metric.Perplexity()
    speed = mx.callback.Speedometer(B, frequent=2, auto_reset=False)
    mod = _fit(mx, {k: mx.nd.array(v, ctx=mx.cpu())
                    for k, v in params.items()}, 3, _port_flat, mx.cpu(), m,
               batch_end_callback=speed)
    ja, _ = jmod.get_params()
    pa, aux = mod.get_params()
    assert aux == {} and sorted(pa) == sorted(params)
    for name in params:
        ref = ja[name].asnumpy()
        got = pa[name].asnumpy()
        assert pa[name].context == mx.cpu()
        assert np.abs(got - params[name]).max() > 1e-4, name
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)
    assert m.get()[0] == jm.get()[0] == "perplexity"
    np.testing.assert_allclose(m.get()[1], jm.get()[1], rtol=1e-5)
    assert mod.score(_FlatLabels(mx.io.NDArrayIter(
        *_tokens(np.random.RandomState(1), B), batch_size=B), mx,
        _port_flat), "perplexity")[0][1] > 1.0


def test_module_without_context_raises_without_gpu(monkeypatch):
    """Module(sym) runs on gpu(0); with no card it raises instead of
    running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.Module(transformer.get_symbol(**CFG))
    mx.Module(transformer.get_symbol(**CFG), context=mx.cpu())


@pytest.mark.parametrize("bad,item", [
    (dict(moe_experts=4), "A.8"), (dict(tensor_parallel="mp"), "A.8"),
    (dict(dtype="float64"), "A.1"), (dict(dtype="int8"), "A.1")])
def test_get_symbol_errors_name_their_roadmap_item(bad, item):
    with pytest.raises(mx.MXNetError) as err:
        transformer.get_symbol(**CFG, **bad)
    assert "ROADMAP %s" % item in str(err.value)
    assert "(ROADMAP)" not in str(err.value)


@pytest.mark.parametrize("arg,item", [
    ("monitor", "A.9"), ("sparse_row_id_fn", "A.6"),
    ("checkpoint_every", "writes a tag every n steps"),
    ("checkpoint_prefix", "alone warns and arms nothing")])
def test_fit_errors_name_their_roadmap_item(arg, item, tmp_path, caplog):
    """Arguments of later slices raise naming their ROADMAP item.  The
    checkpoint arguments (ROADMAP A.7) follow the JAX package's contract
    (mxnet_tpu/module/base_module.py:239-251): ``checkpoint_every``
    writes a tag every n steps under the prefix, a prefix alone warns
    and arms nothing."""
    mod = mx.Module(transformer.get_symbol(**CFG), context=mx.cpu())
    if arg.startswith("checkpoint"):
        prefix = str(tmp_path / "run")
        it = _FlatLabels(mx.io.NDArrayIter(
            *_tokens(np.random.RandomState(2), 2 * B), batch_size=B), mx,
            _port_flat)
        kw = {"checkpoint_prefix": prefix}
        if arg == "checkpoint_every":
            kw["checkpoint_every"] = 1
        with caplog.at_level(logging.WARNING):
            mod.fit(it, num_epoch=1, optimizer="sgd", **kw)
        tags = mx.checkpoint.manifest.list_tags(prefix)
        if arg == "checkpoint_every":
            assert tags == [1, 2]
            assert mx.checkpoint.latest(prefix)["step"] == 2
        else:
            assert tags == [] and "NOT armed" in caplog.text
        return
    it = mx.io.NDArrayIter(*_tokens(np.random.RandomState(2), B),
                           batch_size=B)
    with pytest.raises(mx.MXNetError) as err:
        mod.fit(it, num_epoch=1, **{arg: object()})
    assert "%s=... (ROADMAP %s)" % (arg, item) in str(err.value)
    assert "(ROADMAP)" not in str(err.value)


def test_module_rejects_later_slices(params):
    """Several contexts, monitors and the multi-GPU stores raise.
    Gradient compression is in the port now: the Module hands its
    ``compression_params`` to the kvstore instance at init_optimizer,
    which rejects a type other than 2bit."""
    sym = transformer.get_symbol(**CFG)
    with pytest.raises(mx.MXNetError, match="multi-GPU"):
        mx.Module(sym, context=[mx.cpu(), mx.cpu(1)])
    it = _FlatLabels(mx.io.NDArrayIter(*_tokens(np.random.RandomState(2), B),
                                       batch_size=B), mx, _port_flat)
    one_bit = mx.Module(sym, context=mx.cpu(),
                        compression_params={"type": "1bit"})
    with pytest.raises(mx.MXNetError, match="unsupported compression"):
        one_bit.fit(it, num_epoch=1, kvstore=mx.kv.create("device"),
                    arg_params=params)
    mod = mx.Module(sym, context=mx.cpu())
    with pytest.raises(mx.MXNetError, match="monitor"):
        mod.fit(it, num_epoch=1, monitor=object())
    for kv in ("dist_sync", "tpu", "nccl"):
        with pytest.raises(mx.MXNetError, match="multi-GPU"):
            mod.fit(it, num_epoch=1, kvstore=kv, arg_params=params,
                    force_init=True)


def test_trained_model_serves_in_both_engines(pallas, params):
    """Train the tiny model a few steps in the port, export its
    parameters to numpy, and serve them: the port's DecodeEngine and the
    JAX package's give equal greedy streams, and the JAX executor binds
    the exported names unchanged."""
    mod = _fit(mx, {k: mx.nd.array(v, ctx=mx.cpu())
                    for k, v in params.items()}, 4, _port_flat, mx.cpu(),
               "ce")
    trained = export_params(mod.get_params()[0])
    assert sorted(trained) == sorted(params)
    assert all(v.dtype == np.float32 for v in trained.values())
    geo = dict(capacity=2, block_size=4, num_blocks=16, chunk_tokens=8)
    prompts = [[3, 14, 15, 9, 2], [26, 5, 35]]
    streams = []
    for engine, p, kw in ((JaxEngine, trained, {}),
                          (DecodeEngine, convert_params(trained, mx.cpu(),
                                                        CFG),
                           dict(ctx=mx.cpu()))):
        eng = engine(p, CFG, **geo, **kw)
        try:
            hs = [eng.submit(pr, max_new_tokens=5) for pr in prompts]
            streams.append([h.result(timeout=120) for h in hs])
        finally:
            eng.stop()
    assert streams[0] == streams[1]
    assert all(len(s) == 5 for s in streams[1])
    jexe = jtransformer.get_symbol(**CFG).simple_bind(
        ctx=jmx.cpu(), grad_req="null", **SHAPES)
    jexe.copy_params_from({k: jmx.nd.array(v) for k, v in trained.items()})
