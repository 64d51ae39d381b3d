"""PyTorch port: float16 training (ROADMAP A.1) under ``multi_precision``
through the ``Updater``, the kvstore (eager and bucketed, dense and
2-bit), the fused fit step with its ``DynamicLossScaler``,
``Module.fit``, ``TrainStep`` and the Gluon ``Trainer``, against the JAX
package on the CPU; and the plain f16 forms of row 4 (LayerNorm
backward) and row 8's backward against the JAX package's.

The same numpy weights, gradients and batches (drawn from seeds) go
through both packages; the JAX side runs its Pallas kernels in
interpret mode (``MXNET_LN_IMPL=pallas`` for the Module cases).  Bounds,
from f16's 11-bit significand (10 fraction bits):

* f16 weights within one f16 ulp of the value (``_F16_TOL``: rtol
  2^-10, atol 2^-24, the smallest subnormal) wherever both packages
  update from the same gradient values: a master moving across a
  rounding boundary moves its weight by one ulp;
* f32 masters rtol 2e-5 / atol 1e-6 there (the ``Updater``, the kvstore
  against the JAX package's eager per-key stream, which reduces f16
  device streams in f16 as the port does); 2-bit residuals bit for bit;
* end to end through ``Module.fit``, ``TrainStep`` and Gluon each
  package computes its own f16 gradients: the masters' moves (and the
  LM's f32 embeddings') within relative L2 ``_MOVE_L2`` = 2^-6 of the
  JAX package's, bf16's bound (never looser), and the f16 weights within
  one f16 ulp at their array's scale (``_scale_ulp_close``: an element
  far below the array's largest moves by more of its own ulps for the
  same gap).  A bias gradient is a batch sum that XLA's CPU backend
  accumulates in f16 and PyTorch in f32.  The LM's attention carries a
  deliberate difference besides: the reference's f16 attention runs on
  XLA with f16 einsums (``mxnet_tpu/ops/nn.py:796-800``), rounding the
  scores to f16 in the forward and dP in its autodiff backward, where
  the port keeps both f32 and rounds P and dS only (the flash kernels'
  rounding points).  Every activation after the first attention moves
  by about 2^-10 from it, and so every gradient: ``test_lm_attention_gap``
  holds the one-step gap within 2^-8, which the 2^-6 move bound covers;
* the port's fused and eager steps agree to the bit where neither can
  skip (the eager path has no loss scaler, as in the reference, and
  ``MXNET_LOSS_SCALE=off`` gives the fused step none).  Neither package
  scales the loss: the scaler is the overflow check's bookkeeping, so a
  step skips only where the f16 gradients themselves pass 65504
  (``test_loss_scaler_f16_overflow_skips_and_backs_off``).

Row 4 and row 8's plain f16 versions: LayerNorm's dx, dgamma and dbeta
within one f16 ulp of the Pallas ``_ln_backward``'s (both round f32
results once); the attention gradients within relative L2 2^-8 of
``jax.vjp`` through the reference's f16 ``CausalSelfAttention``
(``FLASH_L2``, test_torch_serve_f16.py's bound for the forward, for the
score rounding described above) and each element within 2^-6 of the
array's largest magnitude (bf16's elementwise bound).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import fused_update as jfused
from mxnet_tpu.base import NameManager as JNameManager
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu.pallas.layernorm import _ln_backward as jax_ln_backward
from mxnet_tpu.parallel.trainer import TrainStep as JTrainStep

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint, fused_update
from mxnet_tpu_torch.base import NameManager
from mxnet_tpu_torch.kernels import (PLAIN_CALLS, flash_attention,
                                     layernorm_bwd_plain, reset_counts)
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.weights import gluon_params_from_numpy, param_shapes
from test_torch_fit_bf16 import (_ENV, KEYS, OPTIMIZERS, _arr, _gluon_net,
                                 _kv, _masters, _module, _move_l2, _np,
                                 _run_kv, _state, _steps)

F16 = torch.float16
_F16_TOL = dict(rtol=2.0 ** -10, atol=2.0 ** -24)
_MASTER_TOL = dict(rtol=2e-5, atol=1e-6)
_MOVE_L2 = 2.0 ** -6
FLASH_L2 = 2.0 ** -8


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXNET_LN_IMPL", "pallas")


def _f16(a):
    """``a`` rounded to f16 values, as f32 (exact in both packages)."""
    return np.asarray(a, np.float32).astype(np.float16).astype(np.float32)


def _ulp_close(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, err_msg=err_msg, **_F16_TOL)


def _scale_ulp_close(got, want, err_msg=""):
    """Within one f16 ulp at the array's scale: the spacing of f16 at
    ``want``'s largest magnitude (an element much smaller than the
    array's largest moves by more of its own ulps for the same gap)."""
    top = np.float16(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, err_msg=err_msg,
                               atol=float(np.spacing(top)))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ----------------------------------------------------------------------
# the Updater
# ----------------------------------------------------------------------
def _updater_steps(pkg, name, mp, start, grads):
    opt = pkg.optimizer.create(name, rescale_grad=0.5, multi_precision=mp,
                               **OPTIMIZERS[name])
    upd = pkg.optimizer.get_updater(opt)
    ws = [_arr(pkg, w, "float16") for w in start]
    for step in grads:
        for i, g in enumerate(step):
            upd(i, _arr(pkg, g, "float16"), ws[i])
    return upd, ws


def _updater_case(seed=3):
    rng = np.random.RandomState(seed)
    shapes = [(6, 5), (7,), (2, 3, 4)]
    start = [_f16(rng.randn(*s)) for s in shapes]
    grads = [[_f16(rng.randn(*s)) for s in shapes] for _ in range(3)]
    return start, grads


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updater_f16_master_matches_jax(name):
    """Both packages' Updaters over f16 weights under multi_precision,
    the same f16 gradients, 3 steps: the states nest as ``(inner,
    weight32)`` with an f32 master, masters agree at the f32 bound and
    weights within one f16 ulp; the port's weight is its master rounded
    to f16, bit for bit; the states survive ``get_states``/``set_states``."""
    start, grads = _updater_case()
    pu, pw = _updater_steps(mx, name, True, start, grads)
    ju, jw = _updater_steps(jmx, name, True, start, grads)
    for i in range(len(start)):
        assert fused_update.state_template(pu.states[i]) \
            == jfused.state_template(ju.states[i])
        assert pu.states[i][1]._data.dtype == torch.float32
        assert pw[i]._data.dtype == F16
        np.testing.assert_allclose(_np(pu.states[i][1]),
                                   _np(ju.states[i][1]), **_MASTER_TOL)
        _ulp_close(_np(pw[i]), _np(jw[i]))
        assert torch.equal(pw[i]._data, pu.states[i][1]._data.half())
    back = mx.optimizer.get_updater(mx.optimizer.create(
        name, multi_precision=True, **OPTIMIZERS[name]))
    back.set_states(pu.get_states())
    for i in range(len(start)):
        got, want = (fused_update.flatten_state(u.states[i])
                     for u in (back, pu))
        assert got[1] == want[1]
        for a, b in zip(got[0], want[0]):
            assert a._data.dtype == b._data.dtype
            assert torch.equal(a._data, b._data)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updater_f16_without_multi_precision_matches_jax(name):
    """An f16 weight without ``multi_precision`` follows the reference
    (``Optimizer.update_multi_precision``'s else branch): no master, the
    update applied to the f16 weight in place, its states f32 as the
    optimizer's ``create_state`` makes them.  Weights within one f16 ulp
    of the JAX package's; the state templates and leaf types equal."""
    start, grads = _updater_case(seed=5)
    pu, pw = _updater_steps(mx, name, False, start, grads)
    ju, jw = _updater_steps(jmx, name, False, start, grads)
    for i in range(len(start)):
        assert not mx.optimizer.create(name).keeps_master(pw[i])
        assert pw[i]._data.dtype == F16
        assert fused_update.state_template(pu.states[i]) \
            == jfused.state_template(ju.states[i])
        leaves, jleaves = (fused_update.flatten_state(pu.states[i])[0],
                           jfused.flatten_state(ju.states[i])[0])
        assert [str(x._data.dtype).replace("torch.", "") for x in leaves] \
            == [str(x.dtype) for x in jleaves]
        _ulp_close(_np(pw[i]), _np(jw[i]))
        assert not np.array_equal(_np(pw[i]), start[i])


# ----------------------------------------------------------------------
# the kvstore: eager and bucketed, dense and 2-bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("compress", [None, 0.05], ids=["dense", "2bit"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_kvstore_matrix_f16_bucketed_eager_and_jax(name, compress):
    """Each optimizer x {dense, 2-bit} on f16 values with f32 masters:
    the port's bucketed store (f16 values now take the bucketed path
    under an optimizer, through their f32 master-gradient view) against
    its eager one and both against the JAX package's bucketed and eager
    stores.  Weights within one f16 ulp; masters at the f32 bound
    against the port's other path and the JAX package's eager stream
    (its jitted bucket program sums the f16 streams without the f16
    rounding its eager path and the port make)."""
    stores, weights = {}, {}
    for label, pkg, bucketed in (("port", mx, True), ("port_eager", mx, False),
                                 ("jax", jmx, True),
                                 ("jax_eager", jmx, False)):
        stores[label] = _kv(pkg, bucketed, name, compress, True)
        weights[label] = _run_kv(pkg, stores[label], "float16")
    port = stores["port"]
    assert port._engine.stats["flushes"] > 0 and not port._warned
    for label in ("port_eager", "jax", "jax_eager"):
        for a, b in zip(weights["port"], weights[label]):
            _ulp_close(a, b, err_msg=label)
    got = _masters(port._updater.states)
    for label in ("port_eager", "jax_eager"):
        want = _masters(stores[label]._updater.states)
        assert sorted(got) == sorted(want) == sorted(KEYS)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], err_msg=label,
                                       **_MASTER_TOL)
    assert all(port._store[k]._data.dtype == F16 for k in KEYS)


def test_2bit_residuals_bit_identical_on_f16_master_view():
    """f16 gradients under multi-precision Adam with 2-bit compression:
    the residuals live on the f32 master-gradient view (row 6 stays
    f32) and agree bit for bit across the port's bucketed and eager
    stores and the JAX package's two, and are not all zero; the
    bucketed store quantized on the plain version, never on f16."""
    res = {}
    for label, pkg, bucketed in (("port", mx, True), ("port_eager", mx, False),
                                 ("jax", jmx, True),
                                 ("jax_eager", jmx, False)):
        kv = _kv(pkg, bucketed, "adam", 0.05, True)
        if label == "port":
            reset_counts()
        _run_kv(pkg, kv, "float16")
        if label == "port":
            assert PLAIN_CALLS["two_bit_quantize_fused"] > 0
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


def test_f16_push_is_bucketed_and_reduces_in_f16():
    """An f16 push under an optimizer takes the bucketed path (no
    ineligibility reason); with no optimizer it stays eager as a
    non-f32 value, and two f16 streams reduce in f16, as the JAX
    package's eager store reduces them."""
    kv = _kv(mx, True, "sgd", mp=True)
    w = _arr(mx, np.ones(4, np.float32), "float16")
    kv.init("h", w)
    eng = kv._get_engine()
    assert eng.ineligible_reason("h", [w], eng._updater_mode()) is None
    kv.push("h", w)
    plain = {}
    for pkg in (mx, jmx):
        s = pkg.kv.create("device")
        s.init("h", _arr(pkg, np.zeros(3, np.float32), "float16"))
        a = np.array([1.0, 2049.0, 0.1], np.float32)
        b = np.array([2.0 ** -11, 1.0, 0.2], np.float32)
        s.push("h", [_arr(pkg, a, "float16"), _arr(pkg, b, "float16")])
        out = _arr(pkg, np.zeros(3, np.float32), "float16")
        s.pull("h", out=out)
        plain[pkg] = _np(out)
        if pkg is mx:
            eng = s._get_engine()
            assert eng.ineligible_reason("h", [w], eng._updater_mode()) \
                == "non_f32_dtype"
    np.testing.assert_array_equal(plain[mx], plain[jmx])
    np.testing.assert_array_equal(
        plain[mx], (np.float16(1.0) + np.float16(2.0 ** -11),
                    np.float16(2048.0) + np.float16(1.0),
                    np.float16(0.1) + np.float16(0.2)))


# ----------------------------------------------------------------------
# Module.fit: fused and eager, against the JAX package
# ----------------------------------------------------------------------
def _mlp(pkg):
    """tests/test_fused_optimizers.py's ``_mlp(low_precision=True)`` in
    float16."""
    sym = pkg.sym
    data = sym.Cast(sym.Variable("data"), dtype="float16")
    net = sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = sym.Cast(net, dtype="float32")
    return sym.SoftmaxOutput(net, name="softmax")


LM = dict(num_classes=61, num_layers=2, d_model=32, num_heads=4, seq_len=12,
          dtype="float16")


def _lm(pkg):
    return (jtransformer if pkg is jmx else transformer).get_symbol(**LM)


def _mlp_case():
    rng = np.random.RandomState(42)
    params = {"fc1_weight": _f16(rng.normal(0, 0.3, (8, 6))),
              "fc1_bias": np.zeros(8, np.float32),
              "fc2_weight": _f16(rng.normal(0, 0.3, (4, 8))),
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
        params[n] = _f16(a + 1 if n.endswith("_gamma") else a)
    r = np.random.RandomState(3)
    batches = []
    for _ in range(4):
        x = r.randint(0, LM["num_classes"], (4, 12)).astype(np.float32)
        batches.append((x, np.roll(x, -1, axis=1).reshape(-1)))
    return _lm, params, batches, (4, 12), (48,)


def _f16_names(mod):
    return sorted(k for k, v in mod.get_params()[0].items()
                  if v._data.dtype == F16)


@pytest.mark.parametrize("case,kvstore,compress", [
    ("mlp", None, None), ("mlp", "device", 0.05), ("lm", None, None),
    ("lm", "device", None)],
    ids=["mlp", "mlp-2bit-device", "lm", "lm-device"])
def test_module_fit_f16_fused_eager_and_jax(monkeypatch, case, kvstore,
                                            compress):
    """f16 ``Module.fit`` steps against the JAX package's fused step from
    the same weights and batches.  The port's fused step keeps a dynamic
    loss scaler at 2^15 with no skip here, as the JAX package's does;
    the eager step has none.  Against the JAX package the f16 weights
    lie within one ulp at their scale (2-bit: within the quantizer's
    flip bound) and the masters' moves (and the LM's f32 embeddings')
    within relative L2 2^-6.  The fused step with
    ``MXNET_LOSS_SCALE=off`` and the eager step agree to the bit
    (weights, masters and, with 2-bit, the residuals and bucket plan)."""
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
    assert mods["eager"]._loss_scaler is None
    scaler, jscaler = fused_mod._loss_scaler, mods["jax"]._loss_scaler
    assert scaler is not None and scaler.publish() == 2.0 ** 15
    jscaler.publish()
    assert (scaler.scale, scaler.skips) == (jscaler.scale, jscaler.skips) \
        == (2.0 ** 15, 0)
    (fw, fm), (jw, jm) = _state(fused_mod), _state(mods["jax"])
    low = _f16_names(fused_mod)
    assert low and sorted(fm) == low == sorted(jm)
    for k in low:
        if compress is None:
            _scale_ulp_close(fw[k], jw[k], err_msg=k)
        else:
            flip = 0.1 * compress * len(batches) * 10.0
            np.testing.assert_allclose(fw[k], jw[k], rtol=_F16_TOL["rtol"],
                                       atol=flip, err_msg=k)
    assert _move_l2(fm, jm, params) <= _MOVE_L2
    # the LM's f32 weights (its embeddings) with the masters' bound
    f32 = [k for k in fw if k not in low]
    assert (case == "lm") == bool(f32)
    if f32:
        assert _move_l2({k: fw[k] for k in f32}, {k: jw[k] for k in f32},
                        params) <= _MOVE_L2
    # fused without a scaler against eager: bit for bit
    monkeypatch.setenv("MXNET_LOSS_SCALE", "off")
    off = _module(mx, symf, params, dshape, lshape, True, kvstore, compress)
    _steps(mx, off, batches)
    assert off._loss_scaler is None and off._fused_fit.launches == len(batches)
    (ow, om), (ew, em) = _state(off), _state(mods["eager"])
    for k in ow:
        np.testing.assert_array_equal(ow[k], ew[k], err_msg=k)
    for k in om:
        np.testing.assert_array_equal(om[k], em[k], err_msg=k)
        assert om[k].dtype == np.float32
    if compress is not None:
        fit = off._fused_fit
        eng = mods["eager"]._kvstore._engine
        assert sorted(tuple(n for n, _, _, _ in layout)
                      for layout in fit._buckets) == sorted(eng._flat_res)
        fit._release()
        eng.spill_residuals()
        rf = off._kvstore._compression_residuals
        re = mods["eager"]._kvstore._compression_residuals
        assert sorted(rf) == sorted(re)
        for k in rf:
            np.testing.assert_array_equal(rf[k].asnumpy(), re[k].asnumpy())


def _one_step_grads(symf, params, batch, dshape, lshape):
    """One f16 forward/backward in both packages from the same weights
    and batch: ``{pkg: {name: gradient as f32 numpy}}``, and the port's
    gradient types."""
    x, y = batch
    grads, types = {}, {}
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
        if pkg is mx:
            types = {k: exe.grad_dict[k]._data.dtype for k in params}
    return grads, types


def test_lm_attention_gap():
    """What the end-to-end bounds cover.  One f16 forward/backward of the
    MLP (no attention) in both packages gives the weight gradients to
    the bit.  One of the tiny LM gives every gradient within relative
    L2 2^-8 of the JAX package's, not to the bit: the reference's f16
    attention rounds its scores to f16 in the forward (so every
    activation after the first attention moves, by about 2^-10) and dP
    in the backward, where the port keeps both f32.  The masters' move
    bound, 2^-6, holds that gap four times over.  Each gradient takes
    its parameter's type (f16 in the trunk, f32 for the embeddings)."""
    symf, params, batches, dshape, lshape = _mlp_case()
    grads, _ = _one_step_grads(symf, params, batches[0], dshape, lshape)
    for k in params:
        if k.endswith("_weight"):
            np.testing.assert_array_equal(grads[mx][k], grads[jmx][k])
    symf, params, batches, dshape, lshape = _lm_case()
    grads, types = _one_step_grads(symf, params, batches[0], dshape, lshape)
    gaps = {k: _rel_l2(grads[mx][k], grads[jmx][k]) for k in params}
    assert max(gaps.values()) <= FLASH_L2, gaps
    assert min(gaps.values()) > 0, gaps
    assert all(t == (torch.float32 if "embed" in k else F16)
               for k, t in types.items()), types


def _f16_classifier(pkg):
    sym = pkg.sym
    net = sym.Cast(sym.Variable("data"), dtype="float16")
    net = sym.Activation(sym.FullyConnected(net, num_hidden=16, name="fc1"),
                         act_type="relu")
    net = sym.Cast(sym.FullyConnected(net, num_hidden=2, name="fc2"),
                   dtype="float32")
    return sym.SoftmaxOutput(net, name="softmax")


def _f16_fit(pkg, fused, X, y, shuffle, arg_params=None):
    """Module.fit of ``_f16_classifier`` for 20 epochs (multi-precision
    SGD): the module and its training-set accuracy."""
    mod = pkg.Module(_f16_classifier(pkg), context=pkg.cpu())
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
def test_f16_module_training_converges(fused):
    """tests/test_torch_fit_bf16.py's convergence test in f16: f16
    activations with f32 masters through multi-precision SGD reach
    accuracy above 0.9 (Xavier and the shuffle from the port's seeded
    streams), fused with its loss scaler never skipping, and eager.
    From the same numpy initial weights and batch order the port's
    accuracy lies within one example of the 32-example batch of the JAX
    package's."""
    rng = np.random.RandomState(0)
    X = rng.rand(128, 8).astype(np.float32)
    y = (X[:, :4].sum(axis=1) > X[:, 4:].sum(axis=1)).astype(np.float32)
    mx.random.seed(0)
    mod, acc = _f16_fit(mx, fused, X, y, shuffle=True)
    assert mod.get_params()[0]["fc1_weight"]._data.dtype == F16
    assert acc > 0.9, acc
    if fused:
        mod._fit_sync()
        assert mod._loss_scaler.skips == 0
    w = np.random.RandomState(1)
    init = {"fc1_weight": w.uniform(-0.6, 0.6, (16, 8)),
            "fc1_bias": np.zeros(16), "fc2_weight": w.uniform(-0.5, 0.5,
                                                              (2, 16)),
            "fc2_bias": np.zeros(2)}
    accs = {}
    for pkg in (mx, jmx):
        _, accs[pkg] = _f16_fit(pkg, fused, X, y, shuffle=False,
                                arg_params={k: _arr(pkg, v)
                                            for k, v in init.items()})
    assert abs(accs[mx] - accs[jmx]) <= 1 / 32, accs


# ----------------------------------------------------------------------
# the loss scaler with f16 gradients
# ----------------------------------------------------------------------
def _coherent_batch(x_scale, n=16, seed=9):
    """A batch of ``n`` equal rows: every row's gradient adds with the
    same sign, so the f16 weight gradients (batch sums, SoftmaxOutput
    unnormalized) grow with ``x_scale`` while the forward stays finite;
    at 1e4 fc1's weight gradient passes 65504 and rounds to inf in f16,
    where bf16's f32-wide range holds it."""
    rng = np.random.RandomState(seed)
    x = np.repeat(rng.rand(1, 6).astype(np.float32) * x_scale, n, axis=0)
    return x, np.full(n, float(rng.randint(0, 4)), np.float32)


@pytest.mark.parametrize("kvstore,compress", [(None, None),
                                              ("device", 0.05)],
                         ids=["local", "2bit-device"])
def test_loss_scaler_f16_overflow_skips_and_backs_off(kvstore, compress):
    """f16 gradients that overflow: two finite steps, then two batches
    whose f16 weight gradients pass 65504 (``_coherent_batch``), then a
    finite one.  As in the JAX package's fused step, the loss is not
    scaled (the scale is the overflow check's bookkeeping): each
    overflowing step is skipped whole (weights, masters, momenta and
    2-bit residuals bit for bit) and halves the scale, the finite step
    after them applies.  The scale and skip count equal the JAX
    package's after every step, and the f16 weights lie within one ulp
    at their scale of the JAX package's at the end (2-bit: within the
    quantizer's flip bound).  The same batch in f32 has finite
    gradients, fc1's past f16's range."""
    symf, params, batches, dshape, lshape = _mlp_case()
    big = _coherent_batch(1e4)
    plan = [batches[0], batches[1], big, big, batches[2]]
    mods = {pkg: _module(pkg, symf, params, dshape, lshape, True, kvstore,
                         compress)
            for pkg in (mx, jmx)}
    mod = mods[mx]
    upd = mod._kvstore._updater if kvstore else mod._updater

    def snapshot():
        leaves = [leaf._data.clone() for st in upd.states.values()
                  for leaf in fused_update.flatten_state(st)[0]]
        res = [r.clone() for r in mod._fused_fit._res_flat or []]
        return [v._data.clone() for v in mod.get_params()[0].values()] \
            + leaves + res

    history = []
    for i, (x, y) in enumerate(plan):
        before = snapshot() if i else None
        for pkg, m in mods.items():
            assert m.fit_step(pkg.io.DataBatch(data=[_arr(pkg, x)],
                                               label=[_arr(pkg, y)]))
        mod._fit_sync()
        js = mods[jmx]._loss_scaler
        js.publish()
        got = (mod._loss_scaler.scale, mod._loss_scaler.skips)
        assert got == (js.scale, js.skips), (i, got, js.scale, js.skips)
        after = snapshot()
        unchanged = before is not None and len(before) == len(after) and all(
            torch.equal(a, b) for a, b in zip(before, after))
        assert unchanged == (x is big[0]), i
        history.append(got)
    assert history == [(2.0 ** 15, 0), (2.0 ** 15, 0), (2.0 ** 14, 1),
                       (2.0 ** 13, 2), (2.0 ** 13, 2)], history
    low = _f16_names(mod)
    (pw, _), (jw, _) = _state(mod), _state(mods[jmx])
    for k in low:
        assert np.isfinite(pw[k]).all()
        if compress is None:
            _scale_ulp_close(pw[k], jw[k], err_msg=k)
        else:
            np.testing.assert_allclose(pw[k], jw[k], rtol=_F16_TOL["rtol"],
                                       atol=0.1 * compress * len(plan) * 10,
                                       err_msg=k)
    exe = _mlp_f32().simple_bind(ctx=mx.cpu(), grad_req="write",
                                 data=dshape, softmax_label=lshape)
    for k, v in params.items():
        exe.arg_dict[k][:] = _arr(mx, v)
    exe.forward(is_train=True, data=_arr(mx, big[0]),
                softmax_label=_arr(mx, big[1]))
    exe.backward()
    g = {k: exe.grad_dict[k].asnumpy() for k in params}
    assert all(np.isfinite(v).all() for v in g.values())
    assert np.abs(g["fc1_weight"]).max() > 65504


def _mlp_f32():
    sym = mx.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=8, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


# ----------------------------------------------------------------------
# TrainStep
# ----------------------------------------------------------------------
def test_trainstep_f16_multi_precision_matches_jax():
    """``TrainStep`` on the f16 transformer (``dtype`` inferred from the
    symbol, and given as ``'float16'``) with multi-precision SGD, 3
    steps against the JAX package's: finite outputs within relative L2
    2^-6 of the JAX package's; f16 parameters (the embeddings f32) whose
    f32 masters moved within relative L2 2^-6 of the JAX masters' moves;
    each f16 weight its master rounded to f16, bit for bit."""
    _, params, batches, dshape, lshape = _lm_case()
    sym, jsym = _lm(mx), _lm(jmx)
    opt = dict(learning_rate=0.1, momentum=0.9, wd=1e-4, multi_precision=True,
               rescale_grad=1.0 / 48)
    io = dict(data_shapes={"data": dshape},
              label_shapes={"softmax_label": lshape})
    tss = [TrainStep(sym, mx.optimizer.SGD(**opt), ctx=mx.cpu(), **io),
           TrainStep(sym, mx.optimizer.SGD(**opt), ctx=mx.cpu(),
                     dtype="float16", **io)]
    for ts in tss:
        ts.init_params(mx.init.Xavier(), arg_params=params)
    jts = JTrainStep(jsym, jmx.optimizer.SGD(**opt), **io)
    jts.init_params(jmx.init.Xavier(),
                    arg_params={n: jmx.nd.array(a) for n, a in params.items()})
    assert tss[1]._exe.arg_dict["data"]._data.dtype == F16
    for x, y in batches[:3]:
        batch = {"data": x, "softmax_label": y}
        outs = [ts.step(batch)[0] for ts in tss]
        jout = np.asarray(jts.step(batch)[0], np.float32)
        for out in outs:
            assert out.dtype == torch.float32
            assert np.isfinite(out.numpy()).all()
            assert _rel_l2(out.numpy(), jout) < _MOVE_L2
    ts = tss[0]
    low = sorted(n for n, t in ts.params.items() if t.dtype == F16)
    assert low and low == sorted(n for n, t in jts.params.items()
                                 if t.dtype == jnp.float16)
    assert ts.params["tok_embed_weight"].dtype == torch.float32
    moved, jmoved = {}, {}
    for n in low:
        mom, w32 = ts.states[n]
        assert w32.dtype == torch.float32 and mom.dtype == torch.float32
        assert torch.equal(ts.params[n], w32.half()), n
        moved[n] = w32.numpy()
        jmoved[n] = np.asarray(jts.states[n][-1], np.float32)
    assert _move_l2(moved, jmoved, {n: params[n] for n in low}) <= _MOVE_L2


# ----------------------------------------------------------------------
# Gluon
# ----------------------------------------------------------------------
@pytest.mark.parametrize("update_on_kvstore", [True, False],
                         ids=["on_kvstore", "on_params"])
def test_gluon_trainer_f16_matches_jax(update_on_kvstore):
    """``net.cast('float16')`` and a Trainer with ``multi_precision``,
    the update on the store or on the parameters, against the JAX
    package's Gluon from the same weights and batches: weights f16
    within one ulp at their scale (a bias gradient is a batch sum, which
    the JAX package's XLA CPU backend accumulates in f16 and PyTorch in
    f32, as tests/test_torch_fit_bf16.py shows for bf16), the masters
    f32 with their moves within relative L2 2^-6.  The nets are cast before ``initialize``, as in the bf16 test
    (the JAX package's ``Parameter.cast`` keeps an initialized array's
    type)."""
    rng = np.random.RandomState(7)
    start = {"0_weight": _f16(rng.normal(0, 0.3, (8, 6))),
             "0_bias": np.zeros(8, np.float32),
             "1_weight": _f16(rng.normal(0, 0.3, (4, 8))),
             "1_bias": np.zeros(4, np.float32)}
    r = np.random.RandomState(1)
    batches = [(r.rand(8, 6).astype(np.float32),
                r.randint(0, 4, 8).astype(np.float32)) for _ in range(4)]
    out = {}
    for pkg, scope in ((mx, NameManager), (jmx, JNameManager)):
        with scope():
            net = _gluon_net(pkg)
        net.cast("float16")
        net.initialize(ctx=pkg.cpu())
        prefix = net.prefix + "dense"
        values = {prefix + k: start[k] for k in start}
        if pkg is mx:
            gluon_params_from_numpy(net, values)
        else:
            for k, p in net.collect_params().items():
                p.set_data(jmx.nd.array(values[k]))
        assert all(str(p.data().dtype).endswith("float16")
                   for p in net.collect_params().values())
        trainer = pkg.gluon.Trainer(
            net.collect_params(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9,
             "multi_precision": True},
            kvstore="device", update_on_kvstore=update_on_kvstore)
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        for x, y in batches:
            with pkg.autograd.record():
                logits = pkg.nd.Cast(net(_arr(pkg, x, "float16")),
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
    assert all(p.data()._data.dtype == F16
               for p in pnet.collect_params().values())
    assert sorted(pm) == sorted(jm) == sorted(start)
    for k in pw:
        _scale_ulp_close(pw[k], jw[k], err_msg=k)
        assert pm[k].dtype == np.float32
    assert _move_l2(pm, jm, start) <= _MOVE_L2


# ----------------------------------------------------------------------
# checkpoint and resume
# ----------------------------------------------------------------------
@pytest.mark.parametrize("compress", [None, 0.05], ids=["dense", "2bit"])
def test_fused_f16_fit_resumes_bit_for_bit(tmp_path, compress):
    """The full-state capture (``mx.checkpoint``) carries f16 weights,
    f32 masters, momenta, 2-bit residuals and the loss scaler's triple:
    a fused f16 fit checkpointed after 3 steps and resumed in a fresh
    Module ends the next 3 steps bit-equal to the uninterrupted run, its
    weights f16.  An f16 weight's NDArray file is the JAX package's byte
    for byte (the reference's type flag 2) and loads back f16."""
    symf, params, batches, dshape, lshape = _mlp_case()

    def make():
        return _module(mx, symf, params, dshape, lshape, True, "device",
                       compress)

    prefix = str(tmp_path / "ck")
    a = make()
    mgr = checkpoint.CheckpointManager(prefix, module=a, keep=0,
                                       install_preemption=False)
    _steps(mx, a, batches[:3])
    mgr.save(epoch=0, step=3)
    mgr.drain()
    _steps(mx, a, batches[3:] + batches[:1])
    mgr.close()
    want = checkpoint.capture(a)
    b = make()
    man = checkpoint.restore(b, prefix)
    assert man["tag"] == 3
    _steps(mx, b, batches[3:] + batches[:1])
    got = checkpoint.capture(b)
    assert got["args"]["fc1_weight"].dtype == F16
    for part in ("args", "auxs"):
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), k
    for k, st in want["states"].items():
        for x, y in zip(fused_update.flatten_state(got["states"][k])[0],
                        fused_update.flatten_state(st)[0]):
            x = x._data if hasattr(x, "_data") else x
            y = y._data if hasattr(y, "_data") else y
            assert torch.equal(x, y), k
    assert got["extra"]["loss_scaler"] == want["extra"]["loss_scaler"]
    if compress:
        res = want["extra"]["residuals"]
        assert res and any(bool(v.abs().sum()) for v in res.values())
        for k, v in res.items():
            assert torch.equal(got["extra"]["residuals"][k], v), k
    w = b.get_params()[0]["fc1_weight"]
    files = {}
    for pkg, arr in ((mx, w), (jmx, jmx.nd.array(_np(w)).astype("float16"))):
        files[pkg] = str(tmp_path / ("%s.nd" % pkg.__name__))
        pkg.nd.save(files[pkg], {"fc1_weight": arr})
    with open(files[mx], "rb") as f, open(files[jmx], "rb") as g:
        assert f.read() == g.read()
    back = mx.nd.load(files[jmx])["fc1_weight"]
    assert back._data.dtype == F16 and torch.equal(back._data, w._data)


# ----------------------------------------------------------------------
# the plain f16 forms of row 4 and row 8's backward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape,with_res", [((6, 40), False),
                                            ((9, 2048), True),
                                            ((33, 1000), True)])
def test_layernorm_bwd_plain_f16_matches_pallas(shape, with_res):
    """Row 4 on f16 x, gamma and dy with f32 statistics (the f16 training
    LayerNorms): the plain version against the JAX package's Pallas
    ``_ln_backward`` in interpret mode on the same saved values: dx,
    dgamma and dbeta within one f16 ulp of the value (both round an f32
    result once; the JAX package leaves dbeta f32, compared here rounded
    to f16 as the port keeps it in gamma's type)."""
    rng = np.random.RandomState(13)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float16)
    res = rng.randn(*shape).astype(np.float16) if with_res else None
    g = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float16)
    dy = rng.randn(*shape).astype(np.float16)
    xf = x.astype(np.float32) + (res.astype(np.float32) if with_res else 0)
    mean = xf.mean(-1).astype(np.float32)
    rstd = (1 / np.sqrt(((xf - mean[:, None]) ** 2).mean(-1) + 1e-5)) \
        .astype(np.float32)
    saved = (jnp.asarray(x), jnp.asarray(g),
             None if res is None else jnp.asarray(res), jnp.asarray(mean),
             jnp.asarray(rstd))
    jdx, jdg, jdb, _ = jax_ln_backward(1e-5, True, saved, jnp.asarray(dy))
    t = torch.from_numpy
    dx, dg, db = layernorm_bwd_plain(
        t(x), t(g), t(mean), t(rstd), t(dy),
        residual=None if res is None else t(res))
    assert dx.dtype == dg.dtype == db.dtype == F16
    for what, a, r in (("dx", dx, jdx), ("dgamma", dg, jdg),
                       ("dbeta", db, jdb)):
        want = np.asarray(jnp.asarray(r).astype(jnp.float16), np.float32)
        np.testing.assert_allclose(a.float().numpy(), want, rtol=2.0 ** -10,
                                   atol=1e-5, err_msg=what)


def _jax_causal_attention(q, k, v, scale):
    """The reference's causal attention on head-major (B, H, S, D), f16
    in: its op packs qkv and takes the XLA path for f16."""
    B, H, S, D = q.shape
    to_seq = lambda t: t.transpose(0, 2, 1, 3).reshape(B, S, H * D)
    qkv = jnp.concatenate([to_seq(q), to_seq(k), to_seq(v)], axis=-1)
    o = jget_op("_contrib_CausalSelfAttention").fn(qkv, num_heads=H,
                                                   scale=scale)
    return o.reshape(B, S, H, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,H,S,D", [(2, 2, 40, 64), (1, 2, 70, 32),
                                     (1, 2, 17, 36), (1, 1, 130, 80)])
def test_flash_attention_f16_backward_matches_jax(B, H, S, D):
    """Row 8's plain f16 backward (dK/dV and dQ through
    ``FlashAttentionFn``) against ``jax.vjp`` of the reference's f16
    causal attention: within relative L2 ``FLASH_L2`` and each element
    within 2^-6 of the array's largest magnitude (module docstring: the
    reference rounds the scores and dP to f16, the port keeps them
    f32)."""
    rng = np.random.RandomState(S)
    q, k, v, do = ((rng.randn(B, H, S, D) * 0.5).astype(np.float16)
                   for _ in range(4))
    sc = 1.0 / np.sqrt(D)
    ref_o, vjp = jax.vjp(lambda q, k, v: _jax_causal_attention(q, k, v, sc),
                         *(jnp.asarray(a) for a in (q, k, v)))
    ref = (ref_o,) + vjp(jnp.asarray(do))
    reset_counts()
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ins, scale=sc)
    got = (out,) + torch.autograd.grad(out, ins, torch.from_numpy(do))
    for what, a, r in zip(("out", "dq", "dk", "dv"), got, ref):
        assert a.dtype == F16, what
        a, r = a.detach().float().numpy(), np.asarray(r, np.float32)
        np.testing.assert_allclose(a, r, rtol=0,
                                   atol=2.0 ** -6 * float(np.abs(r).max()),
                                   err_msg=what)
        assert _rel_l2(a, r) <= FLASH_L2, what
    assert PLAIN_CALLS["flash_attention_bwd_dkv"] == 1
    assert PLAIN_CALLS["flash_attention_bwd_dq"] == 1


# ----------------------------------------------------------------------
# the entry points that refused float16 before it trained
# ----------------------------------------------------------------------
def _training_symbol_infers_f16():
    sym = _lm(mx)
    types = dict(zip(sym.list_arguments(),
                     sym.infer_type(data="float32")[0]))
    assert all(t == F16 for n, t in types.items() if n.startswith("layer"))
    assert types["tok_embed_weight"] == torch.float32


def _serving_symbol_binds_f16_gradients():
    sym = transformer.get_mixed_step_symbol(
        num_classes=61, num_layers=1, d_model=32, num_heads=4, seq_len=32,
        block_size=4, num_blocks=16, dtype="float16")
    exe = sym.simple_bind(ctx=mx.cpu(), grad_req={
        n: "write" if n.startswith("layer") else "null"
        for n in sym.list_arguments()},
        data=(2, 1), positions=(2, 1), block_table=(2, 8),
        chunk_data=(1, 4), chunk_positions=(1, 4), chunk_start=(1,),
        chunk_len=(1,), chunk_table=(1, 8))
    assert exe.grad_dict and all(g._data.dtype == F16
                                 for g in exe.grad_dict.values())


def _updater_takes_f16():
    upd = mx.optimizer.get_updater(mx.optimizer.SGD(multi_precision=True))
    w = _arr(mx, np.ones(4, np.float32), "float16")
    upd(0, w, w)
    inner, w32 = upd.states[0]
    assert inner is None and w32._data.dtype == torch.float32
    assert w._data.dtype == F16


_NOW_TRAIN = {"transformer_get_symbol": _training_symbol_infers_f16,
              "simple_bind_with_gradients":
              _serving_symbol_binds_f16_gradients,
              "updater": _updater_takes_f16}


@pytest.mark.parametrize("what", sorted(_NOW_TRAIN))
def test_float16_training_entry_points_take_f16(what):
    """The float16 training entry points that raised before float16
    trained (tests/test_torch_serve_f16.py held them raising): the
    training symbol infers f16 weights (f32 embeddings), a bind with
    gradients on f16 arguments allocates f16 gradients, the updater
    takes an f16 weight under multi_precision with an f32 master."""
    _NOW_TRAIN[what]()
