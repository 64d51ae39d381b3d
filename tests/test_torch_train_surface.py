"""PyTorch port: the training surface of LM training against the JAX
package on the CPU: the metrics, initializers and callbacks beyond the
first slices', and the small LM with Dropout through ``Module.fit``
(fused and eager) and ``TrainStep``.

Metrics equal the JAX package's values (rtol 1e-6); initializers with
no randomness equal its values, random ones hold their property
(Orthogonal: ``W W^T = scale^2 I``; MSRAPrelu: the standard deviation
of its fan rule).  With ``dropout=0.1`` the LM trains to finite values,
``mx.random.seed`` repeats a run bit for bit, and the fused and eager
steps draw the same masks from the same step seeds, so they agree bit
for bit (SGD); with ``dropout=0`` the symbol has no Dropout node and
training is exactly the undropped LM's.
"""
import json
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.module import fused_fit
from mxnet_tpu_torch.weights import param_shapes

CFG = dict(num_classes=61, num_layers=2, d_model=64, num_heads=4, seq_len=12)
B, S = 4, 12


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("MXNET_FIT_FUSED", "MXNET_FIT_SYNC_EVERY",
              "MXNET_SENTINEL_NUMERICS"):
        monkeypatch.delenv(k, raising=False)


def _arr(pkg, a):
    return jmx.nd.array(a) if pkg is jmx else mx.nd.array(a, ctx=mx.cpu())


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------
def _cases():
    rng = np.random.RandomState(59)
    prob = rng.rand(2, 6, 5).astype(np.float32) + 0.05
    prob /= prob.sum(-1, keepdims=True)
    label = rng.randint(0, 5, (2, 6)).astype(np.float32)
    binary = rng.randint(0, 2, (2, 6)).astype(np.float32)
    two = rng.rand(2, 6, 2).astype(np.float32)
    reg = rng.randn(2, 6).astype(np.float32)
    reg_pred = reg + rng.randn(2, 6).astype(np.float32) * 0.3
    losses = rng.rand(2, 6).astype(np.float32)
    return {
        "top_k_accuracy": (dict(top_k=3), label, prob),
        "f1": ({}, binary, two),
        "mcc": ({}, binary, two),
        "mcc_micro": (dict(average="micro"), binary, two),
        "mae": ({}, reg, reg_pred),
        "mse": ({}, reg, reg_pred),
        "rmse": ({}, reg, reg_pred),
        "nll_loss": ({}, label, prob),
        "pearsonr": ({}, reg, reg_pred),
        "loss": ({}, label, losses),
        "torch": ({}, label, losses),
        "caffe": ({}, label, losses),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_metrics_match_jax(name):
    """Two batches through both packages: same name, same value."""
    kw, label, pred = _cases()[name]
    key = "mcc" if name == "mcc_micro" else name
    jm, m = jmx.metric.create(key, **kw), mx.metric.create(key, **kw)
    for i in range(2):
        jm.update([_arr(jmx, label[i])], [_arr(jmx, pred[i])])
        m.update([_arr(mx, label[i])], [_arr(mx, pred[i])])
    assert m.get()[0] == jm.get()[0]
    np.testing.assert_allclose(m.get()[1], jm.get()[1], rtol=1e-6)


def test_topk_device_form_and_custom_metrics():
    """TopKAccuracy's device reduction (what the fused step folds in)
    gives its host value; a callable and ``mx.metric.np`` make custom
    metrics with the JAX package's names and values."""
    kw, label, pred = _cases()["top_k_accuracy"]
    m = mx.metric.TopKAccuracy(**kw)
    s, n = m.device_fn()([torch.from_numpy(label[0])],
                         [torch.from_numpy(pred[0])])
    m.update([_arr(mx, label[0])], [_arr(mx, pred[0])])
    assert float(s) / n == m.get()[1]
    assert m.device_sig() == ("top_k_accuracy", 3)

    def feval(lab, p):
        return float(np.abs(lab - p.argmax(-1)).sum()), lab.size
    for make in (lambda pkg: pkg.metric.create(feval),
                 lambda pkg: pkg.metric.np(feval, name="dist")):
        jm, pm = make(jmx), make(mx)
        for i in range(2):
            jm.update([_arr(jmx, label[i])], [_arr(jmx, pred[i])])
            pm.update([_arr(mx, label[i])], [_arr(mx, pred[i])])
        assert pm.get() == jm.get()


# ----------------------------------------------------------------------
# initializers
# ----------------------------------------------------------------------
def _fill(pkg, init, name, shape):
    a = pkg.nd.zeros(shape) if pkg is jmx else mx.nd.zeros(shape,
                                                            ctx=mx.cpu())
    init(pkg.init.InitDesc(name), a)
    return a.asnumpy()


def test_deterministic_initializers_match_jax():
    """Bilinear, Load (by name and by ``arg:`` key, default for the
    rest) and Mixed (first matching pattern) give the JAX package's
    values."""
    shape = (2, 3, 4, 5)
    for pkg_init in (lambda pkg: pkg.init.Bilinear(),):
        np.testing.assert_array_equal(
            _fill(mx, pkg_init(mx), "up_weight", shape),
            _fill(jmx, pkg_init(jmx), "up_weight", shape))
    src = np.arange(6, dtype=np.float32).reshape(2, 3)
    for pkg in (jmx, mx):
        load = pkg.init.Load({"arg:fc1_weight": _arr(pkg, src)},
                             default_init=pkg.init.Constant(0.5))
        np.testing.assert_array_equal(
            _fill(pkg, load, "fc1_weight", (2, 3)), src)
        np.testing.assert_array_equal(
            _fill(pkg, load, "fc2_weight", (3,)), np.full(3, 0.5))
        mixed = pkg.init.Mixed(["fc1.*", ".*"],
                               [pkg.init.Constant(2.0), pkg.init.One()])
        np.testing.assert_array_equal(_fill(pkg, mixed, "fc1_weight", (3,)),
                                      np.full(3, 2.0))
        np.testing.assert_array_equal(_fill(pkg, mixed, "fc2_weight",
                                            (2, 2)), np.ones((2, 2)))
    with pytest.raises(mx.MXNetError, match="no init value"):
        _fill(mx, mx.init.Load({}), "w", (2,))


@pytest.mark.parametrize("shape,rand", [((6, 10), "uniform"),
                                        ((4, 3, 2, 2), "normal"),
                                        ((12, 5), "uniform")])
def test_orthogonal_is_orthogonal(shape, rand):
    """``Orthogonal``: the weight flattened to (out, in) has orthogonal
    rows (out <= in) or columns (out > in) of norm ``scale``; registered
    by name, repeatable under ``mx.random.seed``."""
    mx.random.seed(3)
    w = _fill(mx, mx.init.create("orthogonal", scale=1.5, rand_type=rand),
              "q_weight", shape).reshape(shape[0], -1).astype(np.float64)
    gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    np.testing.assert_allclose(gram, 2.25 * np.eye(len(gram)), atol=1e-5)
    mx.random.seed(3)
    again = _fill(mx, mx.init.Orthogonal(scale=1.5, rand_type=rand),
                  "q_weight", shape).reshape(shape[0], -1)
    np.testing.assert_array_equal(again, w.astype(np.float32))


def test_msra_prelu_draws_its_fan_rule():
    """MSRAPrelu is Xavier with gaussian draws and magnitude 2 / (1 +
    slope^2): the draw's standard deviation within 3% of sqrt(magnitude
    / fan), the JAX package's attributes."""
    for factor, fan in (("in", 300), ("out", 200), ("avg", 250)):
        init = mx.init.MSRAPrelu(factor_type=factor, slope=0.5)
        j = jmx.init.MSRAPrelu(factor_type=factor, slope=0.5)
        assert (init.rnd_type, init.magnitude) == (j.rnd_type, j.magnitude)
        w = _fill(mx, init, "c_weight", (200, 300))
        want = (2.0 / 1.25 / fan) ** 0.5
        assert abs(w.std() / want - 1) < 0.03


# ----------------------------------------------------------------------
# callbacks
# ----------------------------------------------------------------------
def test_callbacks_log_the_jax_lines(caplog):
    """ProgressBar, log_train_metric (every 2 batches, with and without
    ``auto_reset``) and LogValidationMetricsCallback write the JAX
    package's log lines."""
    lines = {}
    for pkg in (jmx, mx):
        metric = pkg.metric.create("mse")
        metric.update([_arr(pkg, np.ones((3, 2), np.float32))],
                      [_arr(pkg, np.zeros((3, 2), np.float32))])
        caplog.clear()
        with caplog.at_level(logging.INFO):
            bar = pkg.callback.ProgressBar(total=4, length=10)
            log = pkg.callback.log_train_metric(2)
            reset = pkg.callback.log_train_metric(1, auto_reset=True)
            for nb in range(4):
                p = pkg.model.BatchEndParam(epoch=1, nbatch=nb,
                                            eval_metric=metric, locals=None)
                bar(p)
                log(p)
            pkg.callback.LogValidationMetricsCallback()(p)
            reset(p)
            reset(p)
        lines[pkg] = [r.getMessage() for r in caplog.records]
    assert lines[mx] == lines[jmx]
    assert any("Train-mse=1.000000" in s for s in lines[mx])
    assert any("Validation-mse" in s for s in lines[mx])


# ----------------------------------------------------------------------
# the LM with Dropout
# ----------------------------------------------------------------------
def _params(seed=41):
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in param_shapes(CFG).items():
        a = (rng.randn(*s) * 0.1).astype(np.float32)
        out[n] = a + 1 if n.endswith("_gamma") else a
    return out


class _Flat:
    """NDArrayIter batches with the (B, S) labels flattened."""

    def __init__(self, it):
        self.it = it

    @property
    def provide_data(self):
        return self.it.provide_data

    @property
    def provide_label(self):
        return [mx.io.DataDesc(d.name, (int(np.prod(d.shape)),))
                for d in self.it.provide_label]

    def __iter__(self):
        return self

    def __next__(self):
        b = next(self.it)
        return mx.io.DataBatch(data=b.data, label=[
            mx.nd.NDArray(x._data.reshape(-1)) for x in b.label], pad=b.pad)

    def reset(self):
        self.it.reset()


def _lm_fit(dropout, fused, seed=3, opt="sgd", metric="perplexity",
            lr_scheduler=None, **fit_kw):
    rng = np.random.RandomState(61)
    x = rng.randint(0, CFG["num_classes"], (3 * B, S)).astype(np.float32)
    y = np.roll(x, -1, axis=1)
    mx.random.seed(seed)
    it = _Flat(mx.io.NDArrayIter(x, y, batch_size=B, shuffle=True))
    mod = mx.Module(transformer.get_symbol(**CFG, dropout=dropout),
                    context=mx.cpu())
    mod._fused_fit_enabled = fused
    params = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in _params().items()}
    kw = {"learning_rate": 0.3, "momentum": 0.9, "wd": 1e-3} \
        if opt == "sgd" else {"learning_rate": 0.01, "wd": 0.01}
    if lr_scheduler is not None:
        kw["lr_scheduler"] = lr_scheduler
    mod.fit(it, num_epoch=2, optimizer=opt, optimizer_params=kw,
            eval_metric=metric, arg_params=params, **fit_kw)
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, mod


def test_lm_dropout_fit_fused_equals_eager_and_repeats():
    """dropout 0.1, SGD: fused and eager runs from the same seed end bit
    for bit equal (the same step seeds give the same masks), finite; a
    rerun repeats them; another seed draws other masks; every fused
    step ran its program (one per shape)."""
    before = fused_fit.TRACE_COUNT
    fused, mod = _lm_fit(0.1, True)
    assert fused_fit.TRACE_COUNT - before == 1
    assert mod._fused_fit.launches == 6
    eager, _ = _lm_fit(0.1, False)
    again, _ = _lm_fit(0.1, True)
    other, _ = _lm_fit(0.1, True, seed=4)
    for name, w in fused.items():
        assert np.isfinite(w).all(), name
        np.testing.assert_array_equal(w, eager[name], err_msg=name)
        np.testing.assert_array_equal(w, again[name], err_msg=name)
    assert any(not np.array_equal(w, other[n]) for n, w in fused.items())


def test_lm_dropout_zero_is_the_undropped_lm():
    """``dropout=0`` builds the undropped graph (no Dropout node), and
    its fit equals the undropped LM's bit for bit; the dropped LM's
    differs."""
    def ops(s):
        return [n["op"] for n in json.loads(s.tojson())["nodes"]]
    sym = transformer.get_symbol(**CFG, dropout=0.0)
    assert "Dropout" not in ops(sym)
    assert ops(sym) == ops(transformer.get_symbol(**CFG))
    zero, _ = _lm_fit(0.0, True)
    plain, _ = _lm_fit(0, True)
    dropped, _ = _lm_fit(0.1, True)
    for name, w in zero.items():
        np.testing.assert_array_equal(w, plain[name], err_msg=name)
    assert any(not np.array_equal(w, dropped[n]) for n, w in zero.items())


def test_lm_dropout_lamb_warmup_cosine_fit(caplog):
    """The chip phase's configuration at a small size: LAMB with wd,
    ``WarmupScheduler(CosineScheduler)``, perplexity and top-5 accuracy,
    ``log_train_metric(1)``, through the fused step and the eager pair:
    finite, the two within rtol 1e-4 of each parameter's largest value
    (LAMB's trust ratio: device norms in the fused kind, host norms in
    the eager update), and the log's lines carry both metrics."""
    def run(fused):
        sched = mx.lr_scheduler.WarmupScheduler(
            mx.lr_scheduler.CosineScheduler(max_update=6, base_lr=0.01), 2)
        metric = mx.metric.create(["perplexity", mx.metric.TopKAccuracy(5)])
        with caplog.at_level(logging.INFO):
            return _lm_fit(0.1, fused, opt="lamb", metric=metric,
                           lr_scheduler=sched,
                           batch_end_callback=mx.callback.log_train_metric(
                               1))[0], metric
    caplog.clear()
    fused, metric = run(True)
    assert any("Train-top_k_accuracy_5=" in r.getMessage()
               for r in caplog.records)
    eager, _ = run(False)
    for name, w in fused.items():
        assert np.isfinite(w).all(), name
        np.testing.assert_allclose(w, eager[name], rtol=0,
                                   atol=1e-4 * np.abs(eager[name]).max(),
                                   err_msg=name)
    names = [n for n, _ in metric.get_name_value()]
    assert names == ["perplexity", "top_k_accuracy_5"]


def test_trainstep_nadam_with_dropout():
    """``TrainStep`` with Nadam (through its fused kind, extras staged
    each step) on the dropout LM: finite, repeatable under
    ``mx.random.seed``; at ``dropout=0`` it tracks the Module's eager
    Nadam updates of the same batches within rtol 1e-4 of each
    parameter's largest value.  The key third of each ``qkv_bias`` is
    left out: its gradient is zero up to rounding (softmax does not see
    a shift of every score in a row), and Nadam turns that rounding into
    steps of full size, as every Adam-like update does."""
    rng = np.random.RandomState(7)
    batches = []
    for _ in range(3):
        x = rng.randint(0, CFG["num_classes"], (B, S)).astype(np.float32)
        batches.append({"data": x,
                        "softmax_label": np.roll(x, -1, 1).reshape(-1)})

    def trainstep(dropout, seed=5):
        mx.random.seed(seed)
        opt = mx.optimizer.create("nadam", learning_rate=0.01, wd=0.01,
                                  rescale_grad=1.0 / B)
        ts = mx.parallel.TrainStep(
            transformer.get_symbol(**CFG, dropout=dropout), opt,
            data_shapes={"data": (B, S)},
            label_shapes={"softmax_label": (B * S,)}, ctx=mx.cpu())
        ts.init_params(mx.init.Xavier(), arg_params=_params())
        for b in batches:
            outs = ts.step(b)
            assert torch.isfinite(outs[0]).all()
        return {n: t.numpy().copy() for n, t in ts.params.items()}

    a, b = trainstep(0.1), trainstep(0.1)
    for n in a:
        assert np.isfinite(a[n]).all()
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)
    plain = trainstep(0.0)
    mod = mx.Module(transformer.get_symbol(**CFG), context=mx.cpu())
    mod._fused_fit_enabled = False
    mod.bind(data_shapes=[("data", (B, S))],
             label_shapes=[("softmax_label", (B * S,))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in _params().items()})
    mod.init_optimizer(optimizer="nadam", optimizer_params={
        "learning_rate": 0.01, "wd": 0.01})
    for bt in batches:
        mod.fit_step(mx.io.DataBatch(
            data=[mx.nd.array(bt["data"], ctx=mx.cpu())],
            label=[mx.nd.array(bt["softmax_label"], ctx=mx.cpu())]))
    ref = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    d = CFG["d_model"]
    for n, w in plain.items():
        if n.endswith("qkv_bias"):
            w, ref[n] = (np.concatenate([a[:d], a[2 * d:]])
                         for a in (w, ref[n]))
        np.testing.assert_allclose(w, ref[n], rtol=0,
                                   atol=1e-4 * np.abs(ref[n]).max(),
                                   err_msg=n)
    assert any(not np.array_equal(w, a[n]) for n, w in plain.items())


@pytest.mark.parametrize("opt", ["lbsgd", "adamax", "nadam", "lamb"])
def test_new_kinds_run_in_the_fused_fit_step(opt):
    """Each new fused kind trains the dropout LM inside the fused step
    (one program, six steps, its extras staged as runtime values) and
    ends within rtol 1e-4 of each parameter's largest value of the
    eager pair from the same seed (the key third of ``qkv_bias`` left
    out, as in the Nadam ``TrainStep`` case)."""
    def run(fused):
        mx.random.seed(3)
        mod = mx.Module(transformer.get_symbol(**CFG, dropout=0.1),
                        context=mx.cpu())
        mod._fused_fit_enabled = fused
        rng = np.random.RandomState(61)
        x = rng.randint(0, CFG["num_classes"], (3 * B, S)).astype(np.float32)
        it = _Flat(mx.io.NDArrayIter(x, np.roll(x, -1, axis=1),
                                     batch_size=B))
        mod.fit(it, num_epoch=2, optimizer=opt,
                optimizer_params={"learning_rate": 0.01, "wd": 0.01},
                arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                            for k, v in _params().items()})
        return mod
    before = fused_fit.TRACE_COUNT
    fused = run(True)
    assert fused_fit.TRACE_COUNT - before == 1
    assert fused._fused_fit.launches == 6
    assert fused._optimizer._fused_fit_sig()[0] == opt
    eager = run(False)
    assert eager._fused_fit is None
    d = CFG["d_model"]
    got, ref = (m.get_params()[0] for m in (fused, eager))
    for n in ref:
        a, r = got[n].asnumpy(), ref[n].asnumpy()
        assert np.isfinite(a).all(), n
        if n.endswith("qkv_bias"):
            a, r = (np.concatenate([v[:d], v[2 * d:]]) for v in (a, r))
        np.testing.assert_allclose(a, r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=n)
