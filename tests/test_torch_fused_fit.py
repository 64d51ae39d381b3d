"""PyTorch port: the single-launch fused fit step
(``mxnet_tpu_torch/module/fused_fit.py``) and the fused optimizer update
(``fused_update.py``), against the JAX package's and against the
port's own eager pair.

On the CPU the fused step runs its body eagerly (the card captures it
as one CUDA graph per batch shape; ``chip_smoke.py``'s fit_fused phase
drives that).  The same numpy weights and batches go through the JAX
package's fused step and the port's fused and eager steps.  Weights
agree within rtol 2e-5 / atol 1e-6 (the JAX package's own bound for its
fused-vs-eager parity: gradients from two programs differ in their
last bits); the port's fused and eager steps run the same ops on the
CPU and agree to the bit.  A 2-bit step compares discretization-aware
against the JAX package, as its own test does: the quantizer is a
threshold compare, so a last-bit gradient difference may flip an
element by a whole threshold step.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import fused_update as jfused
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.module import fused_fit as jfused_fit

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import fused_update, metric as metric_mod
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.module import fused_fit

_RTOL = 2e-5
_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _fused_on(monkeypatch):
    monkeypatch.delenv("MXNET_FIT_FUSED", raising=False)
    monkeypatch.delenv("MXNET_FIT_SYNC_EVERY", raising=False)
    monkeypatch.delenv("MXNET_SENTINEL_NUMERICS", raising=False)


def _mlp(pkg):
    sym = pkg.sym
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = sym.Activation(net, act_type="relu")
    return sym.SoftmaxOutput(sym.FullyConnected(net, num_hidden=4,
                                                name="fc2"), name="softmax")


def _data(n=96, d=6, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32) * 0.1
    y = rng.randint(0, classes, n)
    for i in range(n):
        X[i, y[i]] += 1.0
    return X, y.astype(np.float32)


def _init_params(seed=42):
    r = np.random.RandomState(seed)
    return {"fc1_weight": r.normal(0, 0.1, (8, 6)).astype(np.float32),
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": r.normal(0, 0.1, (4, 8)).astype(np.float32),
            "fc2_bias": np.zeros(4, np.float32)}


def _arr(pkg, a):
    return pkg.nd.array(a) if pkg is jmx else mx.nd.array(a, ctx=mx.cpu())


def _make_mod(fused, pkg=mx, kvstore=None, compress=None, optimizer="sgd",
              opt_params=None, batch=16, fixed=None):
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu(),
                         fixed_param_names=fixed,
                         compression_params=({"type": "2bit",
                                              "threshold": compress}
                                             if compress else None))
    mod._fused_fit_enabled = fused
    mod.bind(data_shapes=[("data", (batch, 6))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(arg_params={k: _arr(pkg, v)
                                for k, v in _init_params().items()},
                    aux_params={})
    mod.init_optimizer(
        kvstore=pkg.kv.create(kvstore) if kvstore else "local",
        optimizer=optimizer,
        optimizer_params=opt_params or {"learning_rate": 0.1,
                                        "momentum": 0.9, "wd": 1e-4})
    return mod


def _batches(pkg, n_steps=5, batch=16, seed=0):
    X, y = _data(seed=seed)
    return [pkg.io.DataBatch(data=[_arr(pkg, X[i * batch:(i + 1) * batch])],
                             label=[_arr(pkg, y[i * batch:(i + 1) * batch])])
            for i in range(n_steps)]


def _run(mod, pkg=mx, metric=None, n_steps=5):
    for b in _batches(pkg, n_steps):
        mod.fit_step(b, metric)
        if metric is not None:
            mod.update_metric(metric, b.label)
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _assert_params_close(a, b, rtol=_RTOL, atol=_ATOL):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _assert_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_2bit_close(a, b, lr, threshold, steps):
    """Every element within the flip bound lr * threshold * steps * 10
    (momentum's powers sum under 10), and the median |difference| at
    the dense bound: a lost or doubled residual moves most elements."""
    flip = lr * threshold * steps * 10.0
    diffs = []
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=flip, err_msg=k)
        diffs.append(np.abs(a[k] - b[k]).ravel())
    assert np.median(np.concatenate(diffs)) <= 10 * _ATOL


def test_fused_parity_dense_local_updater():
    """No store: the port's fused step against the JAX package's fused
    step and against the port's eager pair."""
    port = _make_mod(True)
    a = _run(port)
    assert port._fused_fit is not None and port._fused_fit.launches == 5
    eager = _make_mod(False)
    b = _run(eager)
    assert eager._fused_fit is None
    ref = _make_mod(True, pkg=jmx)
    c = _run(ref, pkg=jmx)
    assert ref._fused_fit is not None
    _assert_equal(a, b)
    _assert_params_close(a, c)


@pytest.mark.parametrize("compress", [None, 0.005])
def test_fused_parity_dense_and_2bit_kvstore(compress):
    """A device store, dense and 2-bit: the port's fused step against
    its eager pair (to the bit, residuals included) and against the JAX
    package's fused step."""
    mod_f = _make_mod(True, kvstore="device", compress=compress)
    mod_e = _make_mod(False, kvstore="device", compress=compress)
    a, b = _run(mod_f), _run(mod_e)
    assert mod_f._fused_fit.launches == 5 and mod_e._fused_fit is None
    _assert_equal(a, b)
    c = _run(_make_mod(True, pkg=jmx, kvstore="device", compress=compress),
             pkg=jmx)
    if compress is None:
        _assert_params_close(a, c)
        return
    _assert_2bit_close(a, c, lr=0.1, threshold=compress, steps=5)
    mod_f._fused_fit._release()
    if mod_e._kvstore._engine is not None:
        mod_e._kvstore._engine.spill_residuals()
    rf = mod_f._kvstore._compression_residuals
    re = mod_e._kvstore._compression_residuals
    assert sorted(rf) == sorted(re)
    for k in rf:
        np.testing.assert_array_equal(rf[k].asnumpy(), re[k].asnumpy())


def test_one_program_per_batch_shape_with_ragged_batches():
    """Each distinct batch shape builds its program once (on the card,
    one capture); repeats, alternating with a ragged batch, build
    nothing, and rescale_grad is a runtime value."""
    mod = _make_mod(True, kvstore="device")
    m = metric_mod.Accuracy()
    X, y = _data()

    def step(n):
        b = mx.io.DataBatch(data=[mx.nd.array(X[:n], ctx=mx.cpu())],
                            label=[mx.nd.array(y[:n], ctx=mx.cpu())])
        assert mod.fit_step(b, m)

    t0 = fused_fit.TRACE_COUNT
    step(16)
    step(7)
    assert fused_fit.TRACE_COUNT == t0 + 2
    for n in (16, 7, 16, 7, 16):
        step(n)
    mod._optimizer.rescale_grad = 1.0 / 7
    step(16)
    assert fused_fit.TRACE_COUNT == t0 + 2
    assert mod._fused_fit.launches == 8
    assert mod.get_outputs()[0].shape == (16, 4)
    # the ragged steps trained like the JAX package's
    ref = _make_mod(True, pkg=jmx, kvstore="device")
    jm = jmx.metric.Accuracy()
    for n in (16, 7, 16, 7, 16, 7, 16):
        ref.fit_step(jmx.io.DataBatch(data=[jmx.nd.array(X[:n])],
                                      label=[jmx.nd.array(y[:n])]), jm)
    ref._optimizer.rescale_grad = 1.0 / 7
    ref.fit_step(jmx.io.DataBatch(data=[jmx.nd.array(X[:16])],
                                  label=[jmx.nd.array(y[:16])]), jm)
    _assert_params_close({k: v.asnumpy()
                          for k, v in mod.get_params()[0].items()},
                         {k: v.asnumpy()
                          for k, v in ref.get_params()[0].items()})
    assert m.get() == pytest.approx(jm.get())


def test_fallback_routing_non_fusable_configs():
    """Signum (no fused signature) keeps the eager pair and trains; a
    custom updater installed after fused steps routes later batches
    back to the eager path, which runs it."""
    mod = _make_mod(True, optimizer="signum",
                    opt_params={"learning_rate": 0.01})
    before = _init_params()["fc1_weight"]
    after = _run(mod, n_steps=2)
    assert mod._fused_fit is None
    assert not np.allclose(before, after["fc1_weight"])
    mod = _make_mod(True, kvstore="device")
    _run(mod, n_steps=1)
    assert mod._fused_fit is not None
    seen = []
    mod._kvstore.set_updater(lambda key, grad, weight: seen.append(key))
    b = _batches(mx, 1)[0]
    assert not mod._fused_fit.step(b)
    assert mod.fit_step(b) is False
    assert sorted(seen) == sorted(_init_params())


def test_ineligible_and_refused_configurations(monkeypatch):
    """MXNET_FIT_FUSED=0 keeps the eager pair; 'add' gradients are not
    fused; several devices and the numerics sentinels raise naming
    their ROADMAP items."""
    def module(grad_req="write"):
        mod = mx.Module(_mlp(mx), context=mx.cpu())
        mod.bind(data_shapes=[("data", (16, 6))],
                 label_shapes=[("softmax_label", (16,))], grad_req=grad_req)
        mod.init_params()
        mod.init_optimizer()
        return mod

    monkeypatch.setenv("MXNET_FIT_FUSED", "0")
    mod = module()
    assert mod.fit_step(_batches(mx, 1)[0]) is False
    assert mod._fused_fit is None
    monkeypatch.delenv("MXNET_FIT_FUSED")
    assert module().fit_step(_batches(mx, 1)[0]) is True
    assert module("add").fit_step(_batches(mx, 1)[0]) is False
    with pytest.raises(mx.MXNetError, match="ROADMAP A.8"):
        mx.Module(_mlp(mx), context=[mx.cpu(), mx.cpu(1)])
    with pytest.raises(mx.MXNetError, match="ROADMAP A.8"):
        mx.kv.create("dist_sync")
    monkeypatch.setenv("MXNET_SENTINEL_NUMERICS", "1")
    with pytest.raises(mx.MXNetError, match="ROADMAP A.9"):
        _make_mod(True).fit_step(_batches(mx, 1)[0])


def test_hyperparam_mutation_switches_program():
    """A changed hyperparameter in the optimizer's signature takes
    effect on the fused path with one new program, as on the eager
    path."""
    mod = _make_mod(True, kvstore="device")
    eager = _make_mod(False, kvstore="device")
    b = _batches(mx, 1)[0]
    assert mod.fit_step(b)
    eager.fit_step(b)
    t0 = fused_fit.TRACE_COUNT
    mod._optimizer.momentum = 0.0
    eager._optimizer.momentum = 0.0
    for _ in range(2):
        assert mod.fit_step(b)
        eager.fit_step(b)
    assert fused_fit.TRACE_COUNT == t0 + 1
    _assert_equal({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
                  {k: v.asnumpy() for k, v in eager.get_params()[0].items()})


def test_monitor_falls_back_per_batch():
    """A monitor routes batches to the eager path without losing 2-bit
    residual state: fused, eager, fused equals the pure eager run."""
    mod = _make_mod(True, kvstore="device", compress=0.005)
    ref = _make_mod(False, kvstore="device", compress=0.005)
    for i, b in enumerate(_batches(mx, 5)):
        if i == 2:
            mod._monitor_installed = True
        if i == 4:
            mod._monitor_installed = False
        assert mod.fit_step(b) == (i not in (2, 3))
        ref.fit_step(b)
    _assert_equal({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
                  {k: v.asnumpy() for k, v in ref.get_params()[0].items()})


@pytest.mark.parametrize("name", ["acc", "ce", "perplexity"])
def test_metric_device_accumulation_matches_host(name):
    """A metric accumulated by the fused step equals the eager twin's
    host accumulation on the same batches, and the fused loop reads
    nothing back between get() calls."""
    mod_f = _make_mod(True, kvstore="device")
    mod_e = _make_mod(False, kvstore="device")
    m_f, m_e = metric_mod.create(name), metric_mod.create(name)
    h0 = metric_mod.HOST_SYNCS.value
    _run(mod_f, metric=m_f)
    assert metric_mod.HOST_SYNCS.value == h0
    _run(mod_e, metric=m_e)
    assert metric_mod.HOST_SYNCS.value >= h0 + 5
    h1 = metric_mod.HOST_SYNCS.value
    (nf, vf), (ne, ve) = m_f.get(), m_e.get()
    assert metric_mod.HOST_SYNCS.value == h1 + 1
    assert nf == ne
    assert vf == pytest.approx(ve, rel=1e-6)
    m_f.reset()
    assert m_f._dev_sum is None and np.isnan(m_f.get()[1])


def test_keys_align_with_frozen_params():
    """Frozen parameters keep their index slots in the local updater's
    keys, so fused and eager runs make the same state keys and
    weights."""
    def train(fused):
        mod = _make_mod(fused, fixed=["fc1_weight"],
                        opt_params={"learning_rate": 0.1, "momentum": 0.9})
        out = _run(mod, n_steps=3)
        assert (mod._fused_fit is not None) == fused
        return out, sorted(mod._updater.states)
    (a, keys_f), (b, keys_e) = train(True), train(False)
    assert keys_f == keys_e == [1, 2, 3]
    _assert_equal(a, b)
    np.testing.assert_array_equal(a["fc1_weight"],
                                  _init_params()["fc1_weight"])


def test_optimizer_state_interchange(tmp_path):
    """States written by fused steps load into an eager module and the
    reverse, and both continue exactly as one module would."""
    fname = str(tmp_path / "fused.states")
    mod = _make_mod(True, kvstore="device", optimizer="adam",
                    opt_params={"learning_rate": 0.01, "wd": 1e-4})
    batches = _batches(mx, 5)
    for b in batches[:3]:
        mod.fit_step(b)
    mod.save_optimizer_states(fname)
    ref = _make_mod(False, kvstore="device", optimizer="adam",
                    opt_params={"learning_rate": 0.01, "wd": 1e-4})
    for b in batches[:3]:
        ref.fit_step(b)
    eager = _make_mod(False, kvstore="device", optimizer="adam",
                      opt_params={"learning_rate": 0.01, "wd": 1e-4})
    eager.set_params(*mod.get_params())
    for name, v in mod.get_params()[0].items():
        eager._kvstore._store[name][:] = v.asnumpy()
    eager.load_optimizer_states(fname)
    eager._optimizer._index_update_count = dict(
        mod._optimizer._index_update_count)
    eager._optimizer.num_update = mod._optimizer.num_update
    for m in (eager, ref, mod):
        m.fit_step(batches[3])
    mod.save_optimizer_states(fname)
    ref_states = mod._kvstore._updater.states
    back = _make_mod(True, kvstore="device", optimizer="adam",
                     opt_params={"learning_rate": 0.01, "wd": 1e-4})
    back.load_optimizer_states(fname)
    assert sorted(back._kvstore._updater.states) == sorted(ref_states)
    for m in (eager, ref, mod):
        m.fit_step(batches[4])
    want = {k: v.asnumpy() for k, v in ref.get_params()[0].items()}
    _assert_equal({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
                  want)
    _assert_equal({k: v.asnumpy() for k, v in eager.get_params()[0].items()},
                  want)


def test_fit_sync_every_env(monkeypatch):
    """MXNET_FIT_SYNC_EVERY bounds the host's lead without changing
    results; Module.fit takes the fused path."""
    X, y = _data()
    outs = []
    for every in ("2", "0"):
        monkeypatch.setenv("MXNET_FIT_SYNC_EVERY", every)
        mx.random.seed(3)
        it = mx.io.NDArrayIter(X, y, batch_size=16)
        mod = mx.Module(_mlp(mx), context=mx.cpu())
        mod.fit(it, num_epoch=4, optimizer="sgd",
                optimizer_params={"learning_rate": 0.2, "momentum": 0.9},
                initializer=mx.init.Xavier())
        it.reset()
        assert mod.score(it, "acc")[0][1] > 0.9
        assert mod._fused_fit is not None and mod._fused_fit.launches == 24
        outs.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    _assert_equal(*outs)


def _resnet8(pkg):
    return (jresnet if pkg is jmx else resnet).get_symbol(
        num_classes=10, num_layers=8, image_shape=(3, 28, 28))


def test_resnet_fit_fused_matches_jax():
    """ResNet-8 (BatchNorm, auxiliary states) through Module.fit with a
    device store on both packages' fused paths, from the same numpy
    weights and moving statistics: parameters and moving statistics
    within 1e-4 of each one's largest value after 2 epochs of 3 batches
    (sums in another order through six BatchNorm steps), accuracy
    equal."""
    from mxnet_tpu_torch.weights import symbol_shapes
    sym = resnet.get_symbol(num_classes=10, num_layers=8,
                            image_shape=(3, 28, 28))
    args, auxs = symbol_shapes(sym, data=(4, 3, 28, 28),
                               softmax_label=(4,))
    rng = np.random.RandomState(5)
    np_args = {n: (rng.randn(*s) * np.sqrt(2.0 / max(1, np.prod(s[1:])))
                   ).astype(np.float32) if n.endswith("_weight")
               else (1 + 0.1 * rng.randn(*s)).astype(np.float32)
               if n.endswith("_gamma") else
               (0.1 * rng.randn(*s)).astype(np.float32)
               for n, s in args.items()
               if n not in ("data", "softmax_label")}
    np_aux = {n: (0.1 * rng.randn(*s)).astype(np.float32)
              if n.endswith("_mean")
              else (1 + 0.1 * np.abs(rng.randn(*s))).astype(np.float32)
              for n, s in auxs.items()}
    x = rng.uniform(-1, 1, (12, 3, 28, 28)).astype(np.float32)
    y = rng.randint(0, 10, 12).astype(np.float32)
    res = []
    for pkg in (jmx, mx):
        mod = pkg.mod.Module(_resnet8(pkg), context=pkg.cpu())
        metric = pkg.metric.create("acc")
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=4), num_epoch=2,
                kvstore=pkg.kv.create("device"), optimizer="sgd",
                eval_metric=metric,
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                                  "wd": 1e-4},
                arg_params={k: _arr(pkg, v) for k, v in np_args.items()},
                aux_params={k: _arr(pkg, v) for k, v in np_aux.items()})
        assert mod._fused_fit is not None and mod._fused_fit.launches == 6
        a, b = mod.get_params()
        res.append(({k: v.asnumpy() for k, v in a.items()},
                    {k: v.asnumpy() for k, v in b.items()}, metric.get()))
    (ja, jx, jm), (pa, px, pm) = res
    for ref, got in ((ja, pa), (jx, px)):
        assert sorted(ref) == sorted(got)
        for name in ref:
            np.testing.assert_allclose(got[name], ref[name], rtol=0,
                                       atol=1e-4 * np.abs(ref[name]).max(),
                                       err_msg=name)
    assert pm == pytest.approx(jm)


# ----------------------------------------------------------------------
# fused_update kinds against mxnet_tpu/fused_update.py
# ----------------------------------------------------------------------
_OPTS = [
    ("sgd", {"momentum": 0.9, "clip_gradient": 0.5}),
    ("sgd", {"momentum": 0.0}),
    ("adam", {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6,
              "clip_gradient": 1.0}),
    ("adagrad", {"eps": 1e-6}),
    ("rmsprop", {"gamma1": 0.8, "epsilon": 1e-6, "clip_weights": 0.3}),
    ("rmsprop", {"gamma1": 0.9, "gamma2": 0.8, "epsilon": 1e-6,
                 "centered": True, "clip_weights": 0.3}),
]


@pytest.mark.parametrize("name,kw", _OPTS)
def test_fused_update_kinds_match_jax(name, kw):
    """Each kind's bulk update from the same numpy weights, gradients
    and states (three keys, wd on two of them) against the JAX
    package's: the signatures are equal and every new weight and state
    leaf agrees within rtol 2e-5 / atol 1e-6."""
    import jax.numpy as jnp
    port_opt = mx.optimizer.create(name, learning_rate=0.05, wd=1e-3, **kw)
    jax_opt = jmx.optimizer.create(name, learning_rate=0.05, wd=1e-3, **kw)
    sig = port_opt._fused_sig()
    assert sig == jax_opt._fused_sig() and fused_update.supported(sig)
    rng = np.random.RandomState(11)
    shapes = [(4, 5), (7,), (3, 2, 2)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [rng.randn(*s).astype(np.float32) for s in shapes]
    states = []
    for w in ws:
        st = port_opt.create_state(0, mx.nd.array(w, ctx=mx.cpu()))
        leaves, tpl = fused_update.flatten_state(st)
        vals = [np.abs(rng.randn(*w.shape)).astype(np.float32)
                for _ in leaves]
        states.append((tpl, vals))
    lr = np.float32([0.05, 0.02, 0.01])
    wd = np.float32([1e-3, 0.0, 2e-3])
    got_w, got_s = fused_update.bulk_apply(sig)(
        [torch.from_numpy(w) for w in ws], [torch.from_numpy(g) for g in gs],
        [fused_update.unflatten(t, [torch.from_numpy(v) for v in vals])
         for t, vals in states],
        {"lr": torch.from_numpy(lr), "wd": torch.from_numpy(wd),
         "rescale": torch.tensor(0.5), "use_wd": True})
    ref_w, ref_s = jfused.bulk_apply(sig)(
        [jnp.asarray(w) for w in ws], [jnp.asarray(g) for g in gs],
        [jfused.unflatten(t, [jnp.asarray(v) for v in vals])
         for t, vals in states],
        {"lr": jnp.asarray(lr), "wd": jnp.asarray(wd),
         "rescale": jnp.float32(0.5), "use_wd": True})
    for a, b in zip(got_w, ref_w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=_RTOL,
                                   atol=_ATOL)
    for a, b in zip(got_s, ref_s):
        la, lb = fused_update.flatten_state(a)[0], jfused.flatten_state(b)[0]
        assert len(la) == len(lb)
        for x, z in zip(la, lb):
            np.testing.assert_allclose(x.numpy(), np.asarray(z), rtol=_RTOL,
                                       atol=_ATOL)


def test_signum_has_no_fused_signature_and_state_round_trip():
    assert mx.optimizer.Signum()._fused_fit_sig() is None
    assert jmx.optimizer.Signum()._fused_fit_sig() is None
    st = ((torch.zeros(2), None), torch.ones(3))
    leaves, tpl = fused_update.flatten_state(st)
    assert tpl == jfused.flatten_state(
        ((np.zeros(2), None), np.ones(3)))[1]
    back = fused_update.unflatten(tpl, leaves)
    assert back[0][1] is None and back[1] is leaves[1]
    assert jfused_fit.FusedFitStep and fused_fit.FusedFitStep
