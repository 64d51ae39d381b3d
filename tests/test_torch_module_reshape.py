"""PyTorch port: Module.reshape, input gradients and SequentialModule
against the JAX package on the CPU.

A batch whose shape differs from the bound one re-binds in
``Module.forward`` and ``fit`` (reference module.py:291, :423): the
group of the new shapes shares the first group's parameters, gradients
and auxiliary states, and the fused fit step keeps one program per
batch shape (on the card one captured graph each, none captured again
when a shape returns; here the bodies run eagerly and
``fused_fit.TRACE_COUNT`` counts them).  Training across 8 -> 4 -> 8
matches the JAX package's at rtol 1e-4 of each parameter's largest
value (the tolerance of tests/test_torch_train.py's fit).

The JAX package's ``Module.reshape`` writes its host copy of the
parameters into the shared arrays (mxnet_tpu/module/module.py:298-301),
and during ``fit`` that copy is the last one synced (at first, the
initial weights): each re-bind reverts the training so far.  The port
keeps the trained weights, as MXNet's reshape does; the JAX side here
syncs its copy after every batch (``get_params``), which takes the
revert out of the comparison (ROADMAP C).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.models import transformer as jtransformer

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.module import fused_fit
from mxnet_tpu_torch.weights import param_shapes

CFG = dict(num_classes=61, num_layers=2, d_model=32, num_heads=4, seq_len=12)
S = 12


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("MXNET_FIT_FUSED", "MXNET_FIT_SYNC_EVERY",
              "MXNET_SENTINEL_NUMERICS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXNET_LN_IMPL", "pallas")


@pytest.fixture(scope="module")
def params():
    rng = np.random.RandomState(41)
    out = {}
    for n, s in param_shapes(CFG).items():
        a = (rng.randn(*s) * 0.1).astype(np.float32)
        out[n] = a + 1 if n.endswith("_gamma") else a
    return out


class _Batches:
    """A fixed list of (data, label) batches of several sizes; the
    labels flattened to the (B * S,) targets of the LM's softmax."""

    def __init__(self, pkg, batches):
        self.pkg, self.batches, self.i = pkg, batches, 0

    def _arr(self, a):
        return self.pkg.nd.array(a) if self.pkg is jmx \
            else mx.nd.array(a, ctx=mx.cpu())

    @property
    def provide_data(self):
        return [self.pkg.io.DataDesc("data", self.batches[0][0].shape)]

    @property
    def provide_label(self):
        return [self.pkg.io.DataDesc("softmax_label",
                                     self.batches[0][1].shape)]

    def __iter__(self):
        return self

    def __next__(self):
        if self.i == len(self.batches):
            raise StopIteration
        x, y = self.batches[self.i]
        self.i += 1
        return self.pkg.io.DataBatch(data=[self._arr(x)],
                                     label=[self._arr(y)], pad=0)

    def reset(self):
        self.i = 0


def _token_batches(sizes, seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for b in sizes:
        x = rng.randint(0, CFG["num_classes"], (b, S)).astype(np.float32)
        out.append((x, np.roll(x, -1, axis=1).reshape(-1)))
    return out


def _fit(pkg, params, batches, fused=True, opt="sgd"):
    model = jtransformer if pkg is jmx else transformer
    ctx = jmx.cpu() if pkg is jmx else mx.cpu()
    mod = pkg.mod.Module(model.get_symbol(**CFG), context=ctx)
    mod._fused_fit_enabled = fused
    arr = jmx.nd.array if pkg is jmx else \
        (lambda a: mx.nd.array(a, ctx=mx.cpu()))
    metric = pkg.metric.Perplexity()
    # the JAX module's host copy synced after each batch: its re-bind
    # then writes the trained weights back instead of the initial ones
    sync = (lambda _: mod.get_params()) if pkg is jmx else None
    mod.fit(_Batches(pkg, batches), num_epoch=1, optimizer=opt,
            eval_metric=metric, batch_end_callback=sync,
            arg_params={k: arr(v) for k, v in params.items()},
            optimizer_params={"learning_rate": 0.3, "momentum": 0.9,
                              "wd": 1e-3} if opt == "sgd"
            else {"learning_rate": 0.01})
    return mod, metric


@pytest.mark.parametrize("opt", ["sgd", "lamb"])
def test_fit_across_8_4_8_matches_jax(params, opt):
    """Module.fit over batches of 8, 4 and 8 sequences (then 4 and 8
    again): the port's fused and eager steps end with the JAX package's
    parameters and perplexity; the fused step built one program per
    shape and none on return, the groups share every parameter and
    gradient, and the optimizer's state carried over."""
    batches = _token_batches([8, 4, 8, 4, 8])
    jmod, jm = _fit(jmx, params, batches, fused=False, opt=opt)
    ref, _ = jmod.get_params()
    before = fused_fit.TRACE_COUNT
    mod, m = _fit(mx, params, batches, opt=opt)
    assert fused_fit.TRACE_COUNT - before == 2
    assert len(mod._fused_fit._programs) == 2 and mod._fused_fit.launches == 5
    eager, _ = _fit(mx, params, batches, fused=False, opt=opt)
    groups = list(mod._exec_groups.values())
    assert len(groups) == 2
    a, b = (g._exec for g in groups)
    for name in params:
        assert a.arg_dict[name] is b.arg_dict[name]
        assert a.grad_dict[name] is b.grad_dict[name]
    got, _ = mod.get_params()
    got_eager, _ = eager.get_params()
    for name in params:
        r, a, e = (x[name].asnumpy() for x in (ref, got, got_eager))
        if name.endswith("qkv_bias") and opt != "sgd":
            # the key third's gradient is zero up to rounding, which an
            # Adam-like update turns into full steps: left out
            d = CFG["d_model"]
            r, a, e = (np.concatenate([x[:d], x[2 * d:]]) for x in (r, a, e))
        tol = dict(rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=name)
        np.testing.assert_allclose(a, r, **tol)
        np.testing.assert_allclose(e, r, **tol)
        assert np.abs(got[name].asnumpy() - params[name]).max() > 1e-5
    np.testing.assert_allclose(m.get()[1], jm.get()[1], rtol=1e-5)


def test_forward_rebinds_and_returns_to_the_bound_shape(params):
    """An inference forward of another batch size re-binds (outputs of
    its shape, equal to the JAX package's), and a batch of the bound
    shape goes back to the first group, allocating nothing new."""
    outs = {}
    for pkg in (jmx, mx):
        model = jtransformer if pkg is jmx else transformer
        ctx = jmx.cpu() if pkg is jmx else mx.cpu()
        arr = jmx.nd.array if pkg is jmx else \
            (lambda a: mx.nd.array(a, ctx=mx.cpu()))
        mod = pkg.mod.Module(model.get_symbol(**CFG), context=ctx)
        mod.bind(data_shapes=[("data", (4, S))],
                 label_shapes=[("softmax_label", (4 * S,))],
                 for_training=False)
        mod.init_params(arg_params={k: arr(v) for k, v in params.items()})
        x, y = _token_batches([2])[0]
        mod.forward(pkg.io.DataBatch(data=[arr(x)], label=[arr(y)]),
                    is_train=False)
        outs[pkg] = mod.get_outputs()[0].asnumpy()
        assert mod.data_shapes[0].shape == (2, S)
    np.testing.assert_allclose(outs[mx], outs[jmx], rtol=1e-5, atol=1e-6)
    two = mod._exec_group
    (four,) = [g for g in mod._exec_groups.values() if g is not two]
    for group, (x, y) in ((four, _token_batches([4])[0]),
                          (two, _token_batches([2])[0])):
        mod.forward(mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                                    label=[mx.nd.array(y, ctx=mx.cpu())]))
        assert mod._exec_group is group
    assert len(mod._exec_groups) == 2


def _mlp(pkg, name="fc"):
    data = pkg.sym.Variable("data")
    h = pkg.sym.Activation(pkg.sym.FullyConnected(data, num_hidden=8,
                                                  name=name + "1"),
                           act_type="tanh")
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        h, num_hidden=3, name=name + "2"), name="softmax")


def test_input_grads_match_jax():
    """``bind(inputs_need_grad=True)``: ``get_input_grads`` after a
    train forward/backward equals the JAX package's (rtol 1e-5), and the
    module trains on the eager pair (no fused program)."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, 6).astype(np.float32)
    y = np.array([0, 2, 1, 2], np.float32)
    w = {"fc1_weight": rng.randn(8, 6).astype(np.float32) * 0.3,
         "fc1_bias": rng.randn(8).astype(np.float32) * 0.1,
         "fc2_weight": rng.randn(3, 8).astype(np.float32) * 0.3,
         "fc2_bias": rng.randn(3).astype(np.float32) * 0.1}
    grads = {}
    for pkg in (jmx, mx):
        ctx = jmx.cpu() if pkg is jmx else mx.cpu()
        arr = jmx.nd.array if pkg is jmx else \
            (lambda a: mx.nd.array(a, ctx=mx.cpu()))
        mod = pkg.mod.Module(_mlp(pkg), context=ctx)
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)],
                 inputs_need_grad=True)
        mod.init_params(arg_params={k: arr(v) for k, v in w.items()})
        mod.init_optimizer(optimizer="sgd")
        batch = pkg.io.DataBatch(data=[arr(x)], label=[arr(y)])
        mod.forward(batch, is_train=True)
        mod.backward()
        grads[pkg] = mod.get_input_grads()[0].asnumpy()
        if pkg is mx:
            before = fused_fit.TRACE_COUNT
            assert mod.fit_step(batch) is False
            assert fused_fit.TRACE_COUNT == before
            assert mod._get_fused_fit() is None
    assert np.abs(grads[mx]).max() > 0
    np.testing.assert_allclose(grads[mx], grads[jmx], rtol=1e-5, atol=1e-7)
    with pytest.raises(mx.MXNetError, match="inputs_need_grad"):
        m = mx.mod.Module(_mlp(mx), context=mx.cpu())
        m.bind(data_shapes=[("data", x.shape)])
        m.init_params()
        m.get_input_grads()


def _sequential(pkg, train):
    net1 = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=8,
                                  name="fc1")
    net2 = pkg.sym.SoftmaxOutput(
        pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=4,
                               name="fc2"), name="softmax")
    ctx = jmx.cpu() if pkg is jmx else mx.cpu()
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(net1, label_names=[], context=ctx))
    seq.add(pkg.mod.Module(net2, context=ctx), take_labels=True,
            auto_wiring=True)
    seq.bind(data_shapes=[("data", (4, 6))],
             label_shapes=[("softmax_label", (4,))], for_training=train)
    return seq


def test_sequential_module():
    """The reference's test (tests/test_module.py::test_sequential_module):
    two chained modules with auto wiring give (4, 4) outputs."""
    seq = _sequential(mx, False)
    seq.init_params(mx.initializer.Xavier())
    batch = mx.io.DataBatch(data=[mx.nd.ones((4, 6), ctx=mx.cpu())],
                            label=[mx.nd.zeros((4,), ctx=mx.cpu())])
    seq.forward(batch, is_train=False)
    assert seq.get_outputs()[0].shape == (4, 4)
    assert seq.output_shapes[0][1] == (4, 4)


def test_sequential_module_trains_like_jax():
    """Three forward/backward/update rounds of the chain (SGD with
    momentum): the first stage's parameters move by the gradients the
    second stage's input gradients carry, and every parameter matches
    the JAX package's chain at rtol 1e-5; an unknown parameter name
    raises."""
    rng = np.random.RandomState(8)
    w = {"fc1_weight": rng.randn(8, 6), "fc1_bias": rng.randn(8),
         "fc2_weight": rng.randn(4, 8), "fc2_bias": rng.randn(4)}
    w = {k: (v * 0.3).astype(np.float32) for k, v in w.items()}
    x = rng.randn(4, 6).astype(np.float32)
    y = np.array([0, 3, 1, 2], np.float32)
    out = {}
    for pkg in (jmx, mx):
        arr = jmx.nd.array if pkg is jmx else \
            (lambda a: mx.nd.array(a, ctx=mx.cpu()))
        seq = _sequential(pkg, True)
        seq.init_params(arg_params={k: arr(v) for k, v in w.items()})
        seq.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.5, "momentum": 0.9})
        batch = pkg.io.DataBatch(data=[arr(x)], label=[arr(y)])
        for _ in range(3):
            seq.forward(batch, is_train=True)
            seq.backward()
            seq.update()
        out[pkg] = {k: v.asnumpy() for k, v in seq.get_params()[0].items()}
    for k in w:
        assert np.abs(out[mx][k] - w[k]).max() > 1e-3, k
        np.testing.assert_allclose(out[mx][k], out[jmx][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    seq = _sequential(mx, True)
    with pytest.raises(mx.MXNetError, match="unknown to every"):
        seq.init_params(arg_params={"nope": mx.nd.zeros((1,),
                                                        ctx=mx.cpu())},
                        allow_missing=True)
