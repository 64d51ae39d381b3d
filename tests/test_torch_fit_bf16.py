"""PyTorch port: bf16 training under ``multi_precision`` through the
``Updater``, the kvstore (eager and bucketed, dense and 2-bit), the
fused fit step with its ``DynamicLossScaler``, ``Module.fit`` and the
Gluon ``Trainer``, against the JAX package on the CPU.

The same numpy weights, gradients and batches (drawn from seeds) go
through both packages.  Tolerances (the JAX package's own, from
tests/test_fused_optimizers.py:36-43, where both see the same
gradients):

* f32 weights 5e-6; bf16 weights 1e-2, one bf16 ulp (a master moving
  across a rounding boundary moves its weight by one ulp);
* f32 masters rtol 2e-5 / atol 1e-6 wherever both packages update from
  the same gradient values: the ``Updater``, the kvstore against the
  JAX package's eager per-key stream (which reduces bf16 device streams
  in bf16, as the port does; the JAX package's jitted bucket program
  skips that rounding on XLA's CPU backend, so against it the weights
  are held at the bf16 pin);
* 2-bit residuals bit for bit (adds and exact-constant selects only).

End to end through ``Module.fit`` and Gluon each package computes its
own bf16 gradients, and they differ in the last bf16 bit where XLA's
CPU backend and PyTorch round a bf16 reduction differently (a bias
gradient's batch sum; ``test_one_step_bf16_gradients``): there the bf16
weights are held within one ulp and the masters' moves within relative
L2 2^-6 of the JAX package's (two bf16 ulps of the gradient), while the
port's fused and eager steps agree to the bit.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import fused_update as jfused
from mxnet_tpu.models import transformer as jtransformer

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import fused_update
from mxnet_tpu_torch.base import NameManager
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.weights import (convert_symbol_params,
                                     convert_updater_states,
                                     export_updater_states,
                                     gluon_params_from_numpy, param_shapes)
from mxnet_tpu.base import NameManager as JNameManager

_F32_TOL = dict(rtol=5e-6, atol=5e-6)
_BF16_TOL = dict(rtol=1e-2, atol=1e-2)
_MASTER_TOL = dict(rtol=2e-5, atol=1e-6)
_MOVE_L2 = 2.0 ** -6

OPTIMIZERS = {
    "sgd": dict(learning_rate=0.05, momentum=0.9, wd=1e-4),
    "adam": dict(learning_rate=0.01, wd=1e-4),
    "adagrad": dict(learning_rate=0.05),
    "rmsprop": dict(learning_rate=0.01, centered=True),
}
_ENV = ("MXNET_FIT_FUSED", "MXNET_FIT_SYNC_EVERY", "MXNET_SENTINEL_NUMERICS",
        "MXNET_LOSS_SCALE", "MXNET_LOSS_SCALE_INIT",
        "MXNET_LOSS_SCALE_GROWTH_INTERVAL", "MXNET_KVSTORE_FUSED",
        "MXNET_KVSTORE_BIGARRAY_BOUND")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)


def _arr(pkg, a, dtype="float32"):
    x = jmx.nd.array(a) if pkg is jmx else mx.nd.array(a, ctx=mx.cpu())
    return x if dtype == "float32" else x.astype(dtype)


def _np(x):
    return x.astype("float32").asnumpy()


def _bf16(a):
    """``a`` rounded to bf16 values, as f32 (exact in both packages)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _masters(states):
    """``{key: f32 master}`` of an Updater's multi-precision states (the
    ``(inner, weight32)`` tuples; SGD's f32 weights hold a bare
    momentum)."""
    return {k: _np(st[1]) for k, st in states.items()
            if isinstance(st, tuple)}


def _move_l2(got, ref, start):
    """Relative L2 of ``got - ref`` over ``ref``'s move from ``start``,
    over every key."""
    diff = sum(float(np.square(got[k].astype(np.float64) - ref[k]).sum())
               for k in ref)
    move = sum(float(np.square(ref[k].astype(np.float64) - start[k]).sum())
               for k in ref)
    return (diff / move) ** 0.5


# ----------------------------------------------------------------------
# the Updater
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updater_bf16_master_matches_jax(name):
    """Both packages' Updaters over bf16 weights under multi_precision,
    the same bf16 gradients: the states nest as ``(inner, weight32)``
    with an f32 master, masters agree at the f32 bound and weights
    within one bf16 ulp.  After the first step the JAX updater's states
    and weights are carried into a fresh port updater
    (``weights.convert_updater_states``), which then steps like the
    JAX one; the states survive ``get_states``/``set_states``."""
    rng = np.random.RandomState(3)
    shapes = [(6, 5), (7,), (2, 3, 4)]
    start = [_bf16(rng.randn(*s)) for s in shapes]
    grads = [[_bf16(rng.randn(*s)) for s in shapes] for _ in range(3)]

    def updater(pkg):
        opt = pkg.optimizer.create(name, rescale_grad=0.5,
                                   multi_precision=True, **OPTIMIZERS[name])
        return pkg.optimizer.get_updater(opt), \
            [_arr(pkg, w, "bfloat16") for w in start]

    def step(pkg, upd, ws, t):
        for i, g in enumerate(grads[t]):
            upd(i, _arr(pkg, g, "bfloat16"), ws[i])

    (pu, pw), (ju, jw) = updater(mx), updater(jmx)
    step(mx, pu, pw, 0)
    step(jmx, ju, jw, 0)
    cu, _ = updater(mx)
    cu.states = convert_updater_states(export_updater_states(ju.states),
                                       mx.cpu())
    cu.optimizer._index_update_count = dict(
        ju.optimizer._index_update_count)
    cw = [mx.nd.array(_np(w), ctx=mx.cpu()).astype("bfloat16") for w in jw]
    for t in (1, 2):
        for pkg, upd, ws in ((mx, pu, pw), (jmx, ju, jw), (mx, cu, cw)):
            step(pkg, upd, ws, t)
    for i in range(len(shapes)):
        assert fused_update.state_template(pu.states[i]) \
            == jfused.state_template(ju.states[i])
        assert pu.states[i][1]._data.dtype == torch.float32
        assert pw[i]._data.dtype == torch.bfloat16
        for u in (pu, cu):
            np.testing.assert_allclose(_np(u.states[i][1]),
                                       _np(ju.states[i][1]), **_MASTER_TOL)
        for w in (pw[i], cw[i]):
            np.testing.assert_allclose(_np(w), _np(jw[i]), **_BF16_TOL)
            # the weight is its master rounded to bf16
        assert torch.equal(pw[i]._data, pu.states[i][1]._data.bfloat16())
    back, _ = updater(mx)
    back.set_states(pu.get_states())
    for i in range(len(shapes)):
        got, want = (fused_update.flatten_state(u.states[i])
                     for u in (back, pu))
        assert got[1] == want[1]
        for a, b in zip(got[0], want[0]):
            assert a._data.dtype == b._data.dtype
            assert torch.equal(a._data, b._data)


# ----------------------------------------------------------------------
# the kvstore: eager and bucketed, dense and 2-bit
# ----------------------------------------------------------------------
SHAPES = [(32, 16), (64,), (3, 3, 4, 4), (7,)]
KEYS = ["p%d" % i for i in range(len(SHAPES))]


def _kv(pkg, bucketed, name, compress=None, mp=False):
    kv = pkg.kv.create("device")
    kv.set_bucketing(bucketed)
    if compress is not None:
        kv.set_gradient_compression({"type": "2bit", "threshold": compress})
    kv.set_optimizer(pkg.optimizer.create(
        name, rescale_grad=0.5, multi_precision=mp, **OPTIMIZERS[name]))
    return kv


def _run_kv(pkg, kv, dtype, n_steps=3, n_dev=2):
    """Init, then push the same gradient streams (two per key) in both
    packages; the pulled weights as f32 numpy."""
    rng = np.random.RandomState(0)
    for k, s in zip(KEYS, SHAPES):
        kv.init(k, _arr(pkg, rng.normal(0, 1, s).astype(np.float32), dtype))
    r = np.random.RandomState(1)
    for _ in range(n_steps):
        kv.push(KEYS, [[_arr(pkg, r.normal(0, 1, s).astype(np.float32),
                             dtype) for _ in range(n_dev)] for s in SHAPES])
    outs = [_arr(pkg, np.zeros(s, np.float32), dtype) for s in SHAPES]
    kv.pull(KEYS, out=outs)
    return [_np(o) for o in outs]


@pytest.mark.parametrize("compress", [None, 0.05], ids=["dense", "2bit"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_kvstore_matrix_bucketed_eager_and_jax(name, dtype, compress):
    """Each optimizer x {f32, bf16 with a master} x {dense, 2-bit}: the
    port's bucketed store against its eager one and both against the
    JAX package's bucketed and eager stores.  Weights at the f32 or bf16
    bound; under multi_precision the masters at the f32 bound against
    the port's other path and the JAX package's eager stream."""
    mp = dtype == "bfloat16"
    tol = _BF16_TOL if mp else _F32_TOL
    stores, weights = {}, {}
    for label, pkg, bucketed in (("port", mx, True), ("port_eager", mx, False),
                                 ("jax", jmx, True),
                                 ("jax_eager", jmx, False)):
        stores[label] = _kv(pkg, bucketed, name, compress, mp)
        weights[label] = _run_kv(pkg, stores[label], dtype)
    port = stores["port"]
    assert port._engine.stats["flushes"] > 0 and not port._warned
    for label in ("port_eager", "jax", "jax_eager"):
        for a, b in zip(weights["port"], weights[label]):
            np.testing.assert_allclose(a, b, err_msg=label, **tol)
    if mp:
        got = _masters(port._updater.states)
        for label in ("port_eager", "jax_eager"):
            want = _masters(stores[label]._updater.states)
            assert sorted(got) == sorted(want)
            for k in got:
                np.testing.assert_allclose(got[k], want[k], err_msg=label,
                                           **_MASTER_TOL)
        assert all(port._store[k]._data.dtype == torch.bfloat16
                   for k in KEYS)


def test_2bit_residuals_bit_identical_on_f32_master_view():
    """bf16 gradients under multi-precision Adam with 2-bit compression:
    the residuals live on the f32 master-gradient view and agree bit for
    bit across the port's bucketed and eager stores and the JAX
    package's two, and are not all zero."""
    res = {}
    for label, pkg, bucketed in (("port", mx, True), ("port_eager", mx, False),
                                 ("jax", jmx, True),
                                 ("jax_eager", jmx, False)):
        kv = _kv(pkg, bucketed, "adam", 0.05, True)
        _run_kv(pkg, kv, "bfloat16")
        kv._sync_engine()
        res[label] = {k: r for k, r in kv._compression_residuals.items()}
    assert sorted(res["port"]) == sorted(res["jax"]) \
        == sorted(res["port_eager"])
    for label in ("port_eager", "jax", "jax_eager"):
        for k, r in res["port"].items():
            assert r._data.dtype == torch.float32
            np.testing.assert_array_equal(r.asnumpy(), res[label][k].asnumpy(),
                                          err_msg="%s %s" % (label, k))
    assert any(np.abs(r.asnumpy()).sum() > 0 for r in res["port"].values())


def test_bucket_boundaries_match_jax(monkeypatch):
    """A key set mixing bf16 and f32 values under a small byte cap: each
    key counted at its own item size and a new bucket at a change of
    type, so the port's 2-bit buckets are the JAX package's."""
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "1536")
    shapes = [(16, 16), (100,), (8, 8), (300,), (12, 12), (5,), (40, 10)]
    dtypes = ["bfloat16", "float32", "bfloat16", "bfloat16", "float32",
              "float32", "bfloat16"]
    keys = ["k%d" % i for i in range(len(shapes))]
    plans = {}
    for pkg in (mx, jmx):
        kv = _kv(pkg, True, "sgd", 0.05, True)
        rng = np.random.RandomState(4)
        for k, s, dt in zip(keys, shapes, dtypes):
            kv.init(k, _arr(pkg, rng.randn(*s).astype(np.float32), dt))
        kv.push(keys, [_arr(pkg, rng.randn(*s).astype(np.float32), dt)
                       for s, dt in zip(shapes, dtypes)],
                priority=[-i for i in range(len(keys))])
        plans[pkg] = sorted(kv._engine._flat_res)
    assert plans[mx] == plans[jmx]
    assert len(plans[mx]) >= 4


def test_float16_keeps_its_slug_and_raises():
    """float16 no longer has a slug of its own or raises: since float16
    training (ROADMAP A.1) an f16 value under an optimizer is bucketed
    like a bf16 one, through its f32 master-gradient view, and updated
    through an f32 master (tests/test_torch_fit_f16.py)."""
    kv = _kv(mx, True, "sgd", mp=True)
    w = _arr(mx, np.ones(4, np.float32), "float16")
    kv.init("h", w)
    eng = kv._get_engine()
    assert eng.ineligible_reason("h", [w], eng._updater_mode()) is None
    kv.push("h", w)
    kv._sync_engine()
    assert eng.stats["flushes"] > 0
    assert kv._updater.states["h"][1]._data.dtype == torch.float32


# ----------------------------------------------------------------------
# Module.fit: fused and eager, against the JAX package
# ----------------------------------------------------------------------
def _mlp(pkg):
    """tests/test_fused_optimizers.py's ``_mlp(low_precision=True)``."""
    sym = pkg.sym
    data = sym.Cast(sym.Variable("data"), dtype="bfloat16")
    net = sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = sym.Cast(net, dtype="float32")
    return sym.SoftmaxOutput(net, name="softmax")


LM = dict(num_classes=61, num_layers=2, d_model=32, num_heads=4, seq_len=12,
          dtype="bfloat16")


def _lm(pkg):
    return (jtransformer if pkg is jmx else transformer).get_symbol(**LM)


def _mlp_case():
    rng = np.random.RandomState(42)
    params = {"fc1_weight": _bf16(rng.normal(0, 0.3, (8, 6))),
              "fc1_bias": np.zeros(8, np.float32),
              "fc2_weight": _bf16(rng.normal(0, 0.3, (4, 8))),
              "fc2_bias": np.zeros(4, np.float32)}
    r = np.random.RandomState(0)
    batches = [(r.rand(16, 6).astype(np.float32),
                r.randint(0, 4, 16).astype(np.float32)) for _ in range(5)]
    return _mlp, params, batches, (16, 6), (16,)


def _lm_case():
    rng = np.random.RandomState(41)
    params = {}
    for n, s in param_shapes({k: v for k, v in LM.items()
                              if k != "dtype"}).items():
        a = (rng.randn(*s) * 0.1).astype(np.float32)
        params[n] = _bf16(a + 1 if n.endswith("_gamma") else a)
    r = np.random.RandomState(3)
    batches = []
    for _ in range(4):
        x = r.randint(0, LM["num_classes"], (4, 12)).astype(np.float32)
        batches.append((x, np.roll(x, -1, axis=1).reshape(-1)))
    return _lm, params, batches, (4, 12), (48,)


def _module(pkg, symf, params, data_shape, label_shape, fused, kvstore=None,
            compress=None, optimizer_params=None):
    mod = pkg.mod.Module(symf(pkg), context=pkg.cpu(), compression_params=(
        {"type": "2bit", "threshold": compress} if compress else None))
    mod._fused_fit_enabled = fused
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", label_shape)])
    mod.init_params(arg_params={k: _arr(pkg, v) for k, v in params.items()},
                    aux_params={})
    mod.init_optimizer(
        kvstore=pkg.kv.create(kvstore) if kvstore else "local",
        optimizer="sgd", optimizer_params=optimizer_params or {
            "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
            "multi_precision": True})
    return mod


def _steps(pkg, mod, batches):
    for x, y in batches:
        mod.fit_step(pkg.io.DataBatch(data=[_arr(pkg, x)],
                                      label=[_arr(pkg, y)]))


def _state(mod):
    upd = mod._kvstore._updater if mod._update_on_kvstore else mod._updater
    names = mod._param_names
    masters = {names[k] if isinstance(k, int) else k: v
               for k, v in _masters(upd.states).items()}
    return {k: _np(v) for k, v in mod.get_params()[0].items()}, masters


@pytest.mark.parametrize("case,kvstore,compress", [
    ("mlp", None, None), ("mlp", "device", 0.05), ("lm", None, None)],
    ids=["mlp", "mlp-2bit-device", "lm"])
def test_module_fit_bf16_fused_eager_and_jax(case, kvstore, compress):
    """bf16 ``Module.fit`` steps, fused and eager, against the JAX
    package's fused step from the same weights and batches: the port's
    two paths agree to the bit (weights, masters and, with 2-bit, the
    residuals and bucket plan); against the JAX package the bf16
    weights lie within one ulp (2-bit: within the quantizer's flip
    bound) and the masters' moves within relative L2 2^-6.  The fused
    step ran every batch and kept a loss scaler with no skips."""
    symf, params, batches, dshape, lshape = \
        _mlp_case() if case == "mlp" else _lm_case()
    mods = {}
    for label, pkg, fused in (("fused", mx, True), ("eager", mx, False),
                              ("jax", jmx, True)):
        mods[label] = _module(pkg, symf, params, dshape, lshape, fused,
                              kvstore, compress)
        _steps(pkg, mods[label], batches)
    fused_mod = mods["fused"]
    assert fused_mod._fused_fit.launches == len(batches)
    assert mods["eager"]._fused_fit is None
    assert mods["jax"]._fused_fit is not None
    scaler = fused_mod._loss_scaler
    assert scaler is not None and scaler.publish() == 2.0 ** 15
    assert scaler.skips == 0
    (fw, fm), (ew, em), (jw, jm) = (_state(mods[k])
                                    for k in ("fused", "eager", "jax"))
    bf16 = [k for k, v in fused_mod.get_params()[0].items()
            if v._data.dtype == torch.bfloat16]
    assert bf16 and sorted(fm) == sorted(bf16) == sorted(jm)
    for k in fw:
        np.testing.assert_array_equal(fw[k], ew[k], err_msg=k)
    for k in fm:
        np.testing.assert_array_equal(fm[k], em[k], err_msg=k)
        assert fm[k].dtype == np.float32
    if compress is None:
        for k in fw:
            np.testing.assert_allclose(fw[k], jw[k], err_msg=k, **_BF16_TOL)
    else:
        flip = 0.1 * compress * len(batches) * 10.0
        for k in fw:
            np.testing.assert_allclose(fw[k], jw[k], rtol=_BF16_TOL["rtol"],
                                       atol=flip, err_msg=k)
    assert _move_l2(fm, jm, params) <= _MOVE_L2
    if compress is not None:
        fit = fused_mod._fused_fit
        eng = mods["eager"]._kvstore._engine
        assert sorted(tuple(n for n, _, _, _ in layout)
                      for layout in fit._buckets) == sorted(eng._flat_res)
        fit._release()
        eng.spill_residuals()
        rf = fused_mod._kvstore._compression_residuals
        re = mods["eager"]._kvstore._compression_residuals
        assert sorted(rf) == sorted(re)
        for k in rf:
            np.testing.assert_array_equal(rf[k].asnumpy(), re[k].asnumpy())


def test_module_carries_jax_state_then_steps_alike():
    """A bf16 MLP trained one step by the JAX package, then carried into
    the port (its bf16 weights through ``convert_symbol_params``, its
    ``(inner, weight32)`` states through ``convert_updater_states``): the
    next steps of both packages keep the masters within the f32 bound of
    each other as long as the gradients agree, and within the move
    bound after."""
    symf, params, batches, dshape, lshape = _mlp_case()
    jmod = _module(jmx, symf, params, dshape, lshape, True)
    _steps(jmx, jmod, batches[:1])
    args = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    assert all(a.dtype.name == "bfloat16" for a in args.values())
    port_args, _ = convert_symbol_params(args, {}, mx.cpu(), symf(mx),
                                         data=dshape, softmax_label=lshape)
    mod = _module(mx, symf, params, dshape, lshape, True)
    mod.set_params(port_args, {})
    mod._updater.states = convert_updater_states(
        export_updater_states(jmod._updater.states), mx.cpu())
    mod._optimizer._index_update_count = dict(
        jmod._optimizer._index_update_count)
    start = _state(mod)
    np.testing.assert_array_equal(
        np.concatenate([v.ravel() for v in start[1].values()]),
        np.concatenate([_np(jmod._updater.states[i][1]).ravel()
                        for i in sorted(jmod._updater.states)]))
    _steps(mx, mod, batches[1:])
    _steps(jmx, jmod, batches[1:])
    (pw, pm), (jw, jm) = _state(mod), _state(jmod)
    for k in pw:
        np.testing.assert_allclose(pw[k], jw[k], err_msg=k, **_BF16_TOL)
    assert _move_l2(pm, jm, start[1]) <= _MOVE_L2


def test_one_step_bf16_gradients():
    """Where the end-to-end gap comes from: one bf16 forward/backward of
    the MLP in both packages gives the weight gradients to the bit; a
    bias gradient is a batch sum of bf16 output gradients, which the
    port rounds once from an f32 sum (PyTorch) and the JAX package
    accumulates row by row in bf16 (XLA's CPU backend): each package's
    bias gradient is exactly that sum of its own output gradient."""
    import ml_dtypes
    symf, params, batches, dshape, lshape = _mlp_case()
    x, y = batches[0]
    grads = {}
    for pkg in (mx, jmx):
        exe = symf(pkg).simple_bind(ctx=pkg.cpu(), grad_req="write",
                                    data=dshape, softmax_label=lshape)
        for k, v in params.items():
            exe.arg_dict[k][:] = _arr(pkg, v)
        exe.arg_dict["data"][:] = _arr(pkg, x)
        exe.arg_dict["softmax_label"][:] = _arr(pkg, y)
        exe.forward(is_train=True)
        exe.backward()
        grads[pkg] = {k: _np(exe.grad_dict[k]) for k in params}
        # fc2's output gradient: the probabilities less the labels' one
        # hot, rounded to bf16 by the Cast's backward
        cot = (_np(exe.outputs[0]) - np.eye(4, dtype=np.float32)[
            y.astype(int)]).astype(ml_dtypes.bfloat16)
        if pkg is mx:
            want = cot.astype(np.float64).sum(0).astype(np.float32)
        else:
            want = np.zeros(4, ml_dtypes.bfloat16)
            for row in cot:
                want = (want.astype(np.float32) + row.astype(np.float32)
                        ).astype(ml_dtypes.bfloat16)
        want = want.astype(ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(grads[pkg]["fc2_bias"], want)
    for k in params:
        if k.endswith("_weight"):
            np.testing.assert_array_equal(grads[mx][k], grads[jmx][k])
    assert not np.array_equal(grads[mx]["fc2_bias"], grads[jmx]["fc2_bias"])


def _bf16_mlp(pkg):
    sym = pkg.sym
    data = sym.Cast(sym.Variable("data"), dtype="bfloat16")
    net = sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=2, name="fc2")
    return sym.SoftmaxOutput(sym.Cast(net, dtype="float32"), name="softmax")


def _bf16_fit(pkg, fused, X, y, shuffle, arg_params=None):
    """Module.fit of ``_bf16_mlp`` for 20 epochs (multi-precision SGD);
    returns the training-set accuracy."""
    kw = {"context": pkg.cpu()}
    mod = pkg.Module(_bf16_mlp(pkg), **kw)
    mod._fused_fit_enabled = fused
    it = pkg.io.NDArrayIter(X, y, batch_size=32, shuffle=shuffle)
    mod.fit(it, num_epoch=20, optimizer="sgd",
            optimizer_params={"learning_rate": 0.3, "momentum": 0.9,
                              "multi_precision": True},
            initializer=pkg.initializer.Xavier(), eval_metric="acc",
            arg_params=arg_params, allow_missing=arg_params is None)
    assert (mod._fused_fit is not None) == fused
    return mod, mod.score(pkg.io.NDArrayIter(X, y, batch_size=32),
                          "acc")[0][1]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_bf16_module_training_converges(fused):
    """tests/test_dtype.py::test_bf16_module_training_converges: bf16
    activations with f32 master weights through multi-precision SGD
    reach accuracy above 0.9, fused and eager.  The port's Xavier draw
    and shuffle read the port's own streams, seeded here (unseeded they
    start from fresh entropy, so the result would depend on the tests
    run before in the process).  Then the port against the JAX package
    from the same numpy initial weights and the same batch order:
    accuracies within one example of the 32-example batch."""
    rng = np.random.RandomState(0)
    X = rng.rand(128, 8).astype(np.float32)
    y = (X[:, :4].sum(axis=1) > X[:, 4:].sum(axis=1)).astype(np.float32)
    mx.random.seed(0)
    mod, acc = _bf16_fit(mx, fused, X, y, shuffle=True)
    assert mod.get_params()[0]["fc1_weight"]._data.dtype == torch.bfloat16
    assert acc > 0.9, acc
    w = np.random.RandomState(1)
    init = {"fc1_weight": w.uniform(-0.6, 0.6, (16, 8)),
            "fc1_bias": np.zeros(16), "fc2_weight": w.uniform(-0.5, 0.5,
                                                              (2, 16)),
            "fc2_bias": np.zeros(2)}
    accs = {}
    for pkg in (mx, jmx):
        _, accs[pkg] = _bf16_fit(pkg, fused, X, y, shuffle=False,
                                 arg_params={k: _arr(pkg, v)
                                             for k, v in init.items()})
    assert abs(accs[mx] - accs[jmx]) <= 1 / 32, accs


# ----------------------------------------------------------------------
# the loss scaler
# ----------------------------------------------------------------------
def _bad_batch(pkg, n=16, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 6).astype(np.float32)
    x[0, 0] = np.inf              # inf logits, NaN gradients
    return pkg.io.DataBatch(data=[_arr(pkg, x)], label=[_arr(
        pkg, rng.randint(0, 4, n).astype(np.float32))])


@pytest.mark.parametrize("kvstore,compress", [(None, None),
                                              ("device", 0.05)],
                         ids=["local", "2bit-device"])
def test_loss_scaler_overflow_skips_update_and_backs_off(kvstore, compress):
    """A non-finite gradient skips the whole update: weights, masters,
    momenta and 2-bit residuals bit-identical through the bad step;
    skips 1 and the scale halved, as in the JAX package's fused step;
    the next finite step applies, and ``_fit_sync`` publishes the
    ``loss_scale`` gauge and ``loss_scale_overflow_skips`` counter."""
    symf, params, batches, dshape, lshape = _mlp_case()
    mods = {pkg: _module(pkg, symf, params, dshape, lshape, True, kvstore,
                         compress, {"learning_rate": 0.05, "momentum": 0.9,
                                    "multi_precision": True})
            for pkg in (mx, jmx)}
    for pkg, mod in mods.items():
        _steps(pkg, mod, batches[:2])
    mod = mods[mx]
    scaler = mod._loss_scaler
    init_scale = scaler.publish()
    upd = mod._kvstore._updater if kvstore else mod._updater

    def snapshot():
        leaves = [leaf._data.clone() for st in upd.states.values()
                  for leaf in fused_update.flatten_state(st)[0]]
        res = [r.clone() for r in mod._fused_fit._res_flat or []]
        return {k: v._data.clone() for k, v in mod.get_params()[0].items()
                }, leaves, res

    before = snapshot()
    skips0 = fused_update.OVERFLOW_SKIPS.value
    for pkg, m in mods.items():
        assert m.fit_step(_bad_batch(pkg))
    after = snapshot()
    for a, b in zip(before, after):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert len(a) == len(b) and all(torch.equal(x, z)
                                            for x, z in zip(a, b))
    if compress is not None:
        assert before[2] and any(r.abs().sum() > 0 for r in before[2])
    mod._fit_sync()
    assert scaler.skips == 1
    assert scaler.scale == init_scale * fused_update.DynamicLossScaler.BACKOFF
    assert fused_update.LOSS_SCALE.value == scaler.scale
    assert fused_update.OVERFLOW_SKIPS.value == skips0 + 1
    jscaler = mods[jmx]._loss_scaler
    jscaler.publish()
    assert (scaler.scale, scaler.skips) == (jscaler.scale, jscaler.skips)
    for pkg, m in mods.items():
        _steps(pkg, m, batches[2:3])
    moved = mod.get_params()[0]
    assert any(not torch.equal(before[0][k], moved[k]._data)
               for k in moved)
    mod._fit_sync()
    assert scaler.skips == 1 and fused_update.OVERFLOW_SKIPS.value \
        == skips0 + 1


def test_loss_scaler_step_fn_growth_backoff_cap_and_static():
    """The in-place bookkeeping against the JAX package's pure step_fn
    over one sequence: growth after ``growth_interval`` finite steps,
    backoff and reset on overflow, the 2^24 cap, a static scaler that
    counts skips and never changes its scale."""
    cases = [dict(init_scale=4.0, growth_interval=2),
             dict(init_scale=2.0 ** 24, growth_interval=1),
             dict(init_scale=128.0, dynamic=False),
             dict(init_scale=1.0, growth_interval=3)]
    seq = [True, True, False, True, True, True, False, False, True]
    for kw in cases:
        s, j = fused_update.DynamicLossScaler(**kw), \
            jfused.DynamicLossScaler(**kw)
        st, jst = s.device_state(), j.device_state()
        for finite in seq:
            st = s.step_fn(finite, st)
            jst = j.step_fn(finite, jst)
            assert (float(st[0]), int(st[1]), int(st[2])) == \
                (float(jst[0]), int(jst[1]), int(jst[2])), (kw, finite)
        assert st[0].dtype == torch.float32 and st[2].dtype == torch.int32
    assert float(fused_update.DynamicLossScaler(init_scale=2.0 ** 24,
                                                growth_interval=1)
                 .step_fn(True, fused_update.DynamicLossScaler(
                     init_scale=2.0 ** 24).device_state())[0]) == 2.0 ** 24


def test_loss_scaler_config_state_round_trip_and_off(monkeypatch):
    """The knobs as the JAX package reads them; ``state_dict`` round
    trips, into the live triple in place; the scaler lives on the module
    across a re-bind; with ``MXNET_LOSS_SCALE=off`` there is no scaler
    and a non-finite step is applied, as in the JAX package."""
    for value, want in (("dynamic", True), ("128", False)):
        monkeypatch.setenv("MXNET_LOSS_SCALE", value)
        monkeypatch.setenv("MXNET_LOSS_SCALE_INIT", "256")
        monkeypatch.setenv("MXNET_LOSS_SCALE_GROWTH_INTERVAL", "7")
        assert fused_update.scaler_config() == jfused.scaler_config()
        s = fused_update.DynamicLossScaler.from_config()
        assert s.dynamic is want and s.growth_interval == 7
    monkeypatch.delenv("MXNET_LOSS_SCALE_INIT")
    monkeypatch.delenv("MXNET_LOSS_SCALE_GROWTH_INTERVAL")
    monkeypatch.setenv("MXNET_LOSS_SCALE", "dynamic")
    s = fused_update.DynamicLossScaler(init_scale=64.0, growth_interval=5)
    live = s.device_state()
    s.step_fn(False, live)
    d = s.state_dict()
    assert d == {"scale": 32.0, "good": 0, "skips": 1, "dynamic": True,
                 "growth_interval": 5}
    t = fused_update.DynamicLossScaler.from_state(d)
    assert t.state_dict() == d
    s.load_state_dict(dict(d, scale=8.0, skips=3))
    assert s.device_state() is live and float(live[0]) == 8.0 \
        and int(live[2]) == 3
    symf, params, batches, dshape, lshape = _mlp_case()
    mod = _module(mx, symf, params, dshape, lshape, True)
    _steps(mx, mod, batches[:1])
    scaler = mod._loss_scaler
    mod.bind(data_shapes=[("data", dshape)],
             label_shapes=[("softmax_label", lshape)], force_rebind=True)
    mod.init_params(arg_params={k: _arr(mx, v) for k, v in params.items()},
                    aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "multi_precision": True}, force_init=True)
    _steps(mx, mod, batches[1:2])
    assert mod._loss_scaler is scaler
    monkeypatch.setenv("MXNET_LOSS_SCALE", "off")
    for pkg in (mx, jmx):
        m = _module(pkg, symf, params, dshape, lshape, True)
        _steps(pkg, m, batches[:1])
        assert m._loss_scaler is None and m._fused_fit is not None
        assert m.fit_step(_bad_batch(pkg))
        w = _np(m.get_params()[0]["fc1_weight"])
        assert not np.isfinite(w).all()


# ----------------------------------------------------------------------
# Gluon
# ----------------------------------------------------------------------
def _gluon_net(pkg):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=6),
                pkg.gluon.nn.Dense(4, in_units=8))
    return net


@pytest.mark.parametrize("update_on_kvstore", [True, False],
                         ids=["on_kvstore", "on_params"])
def test_gluon_trainer_bf16_matches_jax(update_on_kvstore):
    """``net.cast('bfloat16')`` and a Trainer with ``multi_precision``,
    the update on the store or on the parameters, against the JAX
    package's Gluon from the same weights and batches: weights bf16
    within one ulp, the masters' moves within relative L2 2^-6, the
    masters f32.  The nets are cast before ``initialize``: the JAX
    package's ``Parameter.cast`` keeps an initialized array's type
    (``NDArray._set_data`` casts back), the port's converts it."""
    rng = np.random.RandomState(7)
    start = {"0_weight": _bf16(rng.normal(0, 0.3, (8, 6))),
             "0_bias": np.zeros(8, np.float32),
             "1_weight": _bf16(rng.normal(0, 0.3, (4, 8))),
             "1_bias": np.zeros(4, np.float32)}
    r = np.random.RandomState(1)
    batches = [(r.rand(8, 6).astype(np.float32),
                r.randint(0, 4, 8).astype(np.float32)) for _ in range(4)]
    out = {}
    for pkg, scope in ((mx, NameManager), (jmx, JNameManager)):
        with scope():
            net = _gluon_net(pkg)
        net.cast("bfloat16")
        net.initialize(ctx=pkg.cpu())
        prefix = net.prefix + "dense"
        values = {prefix + k: start[k] for k in start}
        if pkg is mx:
            gluon_params_from_numpy(net, values)
        else:
            for k, p in net.collect_params().items():
                p.set_data(jmx.nd.array(values[k]))
        assert all(str(p.data().dtype).endswith("bfloat16")
                   for p in net.collect_params().values())
        trainer = pkg.gluon.Trainer(
            net.collect_params(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9,
             "multi_precision": True},
            kvstore="device", update_on_kvstore=update_on_kvstore)
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        for x, y in batches:
            with pkg.autograd.record():
                logits = pkg.nd.Cast(net(_arr(pkg, x, "bfloat16")),
                                     dtype="float32")
                loss = loss_fn(logits, _arr(pkg, y))
            loss.backward()
            trainer.step(x.shape[0])
        upd = trainer._kvstore._updater if update_on_kvstore \
            else trainer._updaters[0]
        names = [p.name for p in trainer._params]
        out[pkg] = ({k[len(prefix):]: _np(p.data())
                     for k, p in net.collect_params().items()},
                    {names[k][len(prefix):]: v
                     for k, v in _masters(upd.states).items()},
                    net)
    (pw, pm, pnet), (jw, jm, _) = out[mx], out[jmx]
    assert all(p.data()._data.dtype == torch.bfloat16
               for p in pnet.collect_params().values())
    assert sorted(pm) == sorted(jm) == sorted(start)
    for k in pw:
        np.testing.assert_allclose(pw[k], jw[k], err_msg=k, **_BF16_TOL)
        assert pm[k].dtype == np.float32
    assert _move_l2(pm, jm, start) <= _MOVE_L2
