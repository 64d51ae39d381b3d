"""PyTorch port: the twelve optimizers beyond the first slices' five,
their fused kinds and the schedules LM training uses, against the JAX
package on the CPU.

Each new optimizer takes three updates of the same numpy weights and
gradients in both packages (wd, ``rescale_grad``, ``clip_gradient``, an
``lr_mult`` from the symbol, a bias with wd 0 by name): f32 weights and
states at rtol 2e-5 / atol 1e-6; under ``multi_precision`` over bf16
weights the f32 masters at the same bound and each bf16 weight its
master rounded once.  SGLD's noise is patched to the same numpy draws in
both packages (their generators differ).  The fused kinds (LBSGD,
Adamax, Nadam, LAMB) are held against the port's eager updates and the
JAX package's kinds at the same bound, through ``bulk_apply`` and the
bucketed kvstore; their per-step scalars reach the kinds as runtime
values (Nadam's schedule product changes every update).
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import fused_update as jfused

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import fused_update

_TOL = dict(rtol=2e-5, atol=1e-6)
_BF16_TOL = dict(rtol=1e-2, atol=1e-2)

NEW = {
    "nag": dict(learning_rate=0.1, momentum=0.9),
    "signsgd": dict(learning_rate=0.01),
    "sgld": dict(learning_rate=0.01),
    "adadelta": dict(rho=0.8),
    "ftrl": dict(learning_rate=0.1, lamda1=0.02),
    "adamax": dict(learning_rate=0.01),
    "nadam": dict(learning_rate=0.01),
    "ftml": dict(learning_rate=0.01),
    "dcasgd": dict(learning_rate=0.1, momentum=0.9),
    "lbsgd": dict(learning_rate=0.5, momentum=0.9),
    "lamb": dict(learning_rate=0.01),
    "groupadagrad": dict(learning_rate=0.05),
}
FUSED = ("lbsgd", "adamax", "nadam", "lamb")


def _r(rng, *shape):
    return (rng.randn(*shape) * 0.5).astype(np.float32)


@pytest.fixture
def same_noise(monkeypatch):
    """SGLD's N(0, lr) draws from one numpy stream in each package."""
    def stream():
        rng = np.random.RandomState(9)
        while True:
            yield rng.randn

    jgen, pgen = stream(), stream()

    def jax_normal(loc, scale, shape=(), dtype="float32", **kw):
        return jmx.nd.array(next(jgen)(*shape).astype(np.float32) * scale)

    def port_noise(weight, lr):
        z = next(pgen)(*weight.shape).astype(np.float32) * math.sqrt(lr)
        return torch.from_numpy(z).to(weight.dtype)

    monkeypatch.setattr(jmx.optimizer.nd.random, "normal", jax_normal)
    monkeypatch.setattr(mx.optimizer, "_sgld_noise", port_noise)


def _names(name):
    # GroupAdaGrad takes 2-D weights only and no weight decay
    if name == "groupadagrad":
        return {"fc_weight": (5, 3), "emb_weight": (4, 2)}
    return {"fc_weight": (5, 3), "fc_bias": (5,)}


def _updates(pkg, name, w0, grads, dtype="float32", mp=False):
    """Three updates through ``pkg``'s Updater; returns (weights,
    updater)."""
    names = list(w0)
    kw = dict(NEW[name], rescale_grad=0.5, clip_gradient=0.7,
              multi_precision=mp, param_idx2name=dict(enumerate(names)))
    if name != "groupadagrad":
        kw["wd"] = 0.01
    sym = pkg.sym.Group([pkg.sym.Variable(names[0], lr_mult=0.5)]
                        + [pkg.sym.Variable(n) for n in names[1:]])
    upd = pkg.optimizer.get_updater(pkg.optimizer.create(name, sym=sym,
                                                         **kw))

    def arr(a):
        x = jmx.nd.array(a) if pkg is jmx else mx.nd.array(a, ctx=mx.cpu())
        return x if dtype == "float32" else x.astype(dtype)

    ws = [arr(w0[n]) for n in names]
    for g in grads:
        for i, n in enumerate(names):
            upd(i, arr(g[n]), ws[i])
    return ws, upd


def _np(x):
    return x.astype("float32").asnumpy()


def _leaves(state):
    return fused_update.flatten_state(state)[0]


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_optimizers_match_jax_f32(name, same_noise):
    """Three f32 updates: weights and every state leaf at rtol 2e-5 /
    atol 1e-6 of the JAX package's, and the weights moved."""
    rng = np.random.RandomState(47)
    w0 = {n: _r(rng, *s) for n, s in _names(name).items()}
    grads = [{n: _r(rng, *a.shape) * 4 for n, a in w0.items()}
             for _ in range(3)]
    got, pu = _updates(mx, name, w0, grads)
    ref, ju = _updates(jmx, name, w0, grads)
    for a, r, start in zip(got, ref, w0.values()):
        np.testing.assert_allclose(_np(a), _np(r), **_TOL)
        assert not np.allclose(_np(a), start)
    for i in range(len(w0)):
        ours, theirs = _leaves(pu.states[i]), jfused.flatten_state(
            ju.states[i])[0]
        assert len(ours) == len(theirs)
        for a, r in zip(ours, theirs):
            np.testing.assert_allclose(_np(a), _np(r), **_TOL)


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_optimizers_multi_precision_bf16(name, same_noise):
    """bf16 weights under ``multi_precision``: the state is ``(inner,
    weight32)`` in both packages, the masters agree at the f32 bound,
    and each bf16 weight is its master rounded to bf16."""
    rng = np.random.RandomState(5)
    w0 = {n: torch.from_numpy(_r(rng, *s)).bfloat16().float().numpy()
          for n, s in _names(name).items()}
    grads = [{n: torch.from_numpy(_r(rng, *a.shape) * 4).bfloat16().float()
              .numpy() for n, a in w0.items()} for _ in range(3)]
    got, pu = _updates(mx, name, w0, grads, "bfloat16", mp=True)
    ref, ju = _updates(jmx, name, w0, grads, "bfloat16", mp=True)
    for i, (w, r) in enumerate(zip(got, ref)):
        master, jmaster = pu.states[i][1], ju.states[i][1]
        assert master._data.dtype == torch.float32
        np.testing.assert_allclose(_np(master), _np(jmaster), **_TOL)
        assert torch.equal(w._data, master._data.bfloat16())
        np.testing.assert_allclose(_np(w), _np(r), **_BF16_TOL)


def test_registry_has_the_seventeen_optimizers():
    """Every optimizer the reference registers, its ``Test`` fixture
    aside; the eager-only ones carry the reference's waiver."""
    want = sorted(set(jmx.optimizer._OPT_REGISTRY) - {"test"})
    assert sorted(mx.optimizer._OPT_REGISTRY) == want and len(want) == 17
    for key, klass in mx.optimizer._OPT_REGISTRY.items():
        has_kind = klass is not mx.optimizer.GroupAdaGrad and \
            fused_update.supported(klass()._fused_sig())
        assert has_kind != (klass.__name__ in mx.optimizer.FUSED_EAGER_WAIVERS)
        assert set(mx.optimizer.FUSED_EAGER_WAIVERS) <= set(
            jmx.optimizer.FUSED_EAGER_WAIVERS)


def _bulk(pkg, name, ws, gs, sts, opt, keys):
    """One ``bulk_apply`` step of ``opt`` in ``pkg``'s types."""
    lr, wd, extra = opt._fused_runtime(keys)
    sig = opt._fused_sig()
    if pkg is mx:
        return fused_update.bulk_apply(sig)(
            [torch.from_numpy(w) for w in ws],
            [torch.from_numpy(g) for g in gs], sts,
            {"lr": torch.from_numpy(lr), "wd": torch.from_numpy(wd),
             "extra": torch.from_numpy(extra), "rescale": torch.tensor(0.5),
             "use_wd": tuple(bool(v) for v in wd != 0)})
    import jax.numpy as jnp
    return jfused.bulk_apply(sig)(
        [jnp.asarray(w) for w in ws], [jnp.asarray(g) for g in gs], sts,
        {"lr": jnp.asarray(lr), "wd": jnp.asarray(wd),
         "extra": jnp.asarray(extra), "rescale": jnp.float32(0.5),
         "use_wd": True})


@pytest.mark.parametrize("name", FUSED)
def test_fused_kinds_match_eager_and_jax(name):
    """Three keys (wd on two), three steps: the port's fused kind
    through ``bulk_apply`` with its runtime extras against the port's
    eager updates of the same gradients and against the JAX package's
    kind, weights and states at rtol 2e-5 / atol 1e-6; the signatures
    are the JAX package's."""
    import jax.numpy as jnp
    rng = np.random.RandomState(11)
    shapes = [(4, 5), (7,), (3, 2, 2)]
    names = ["a_weight", "b_bias", "c_weight"]
    w0 = [_r(rng, *s) for s in shapes]
    grads = [[_r(rng, *s) * 3 for s in shapes] for _ in range(3)]
    make = dict(NEW[name], wd=1e-2, rescale_grad=0.5,
                param_idx2name=dict(enumerate(names)))
    popt, jopt = mx.optimizer.create(name, **make), \
        jmx.optimizer.create(name, **make)
    eopt = mx.optimizer.create(name, **make)
    assert popt._fused_sig() == jopt._fused_sig()
    upd = mx.optimizer.get_updater(eopt)
    ew = [mx.nd.array(w, ctx=mx.cpu()) for w in w0]
    pw, jw = [w.copy() for w in w0], [w.copy() for w in w0]
    pst = []
    for i, w in enumerate(w0):
        leaves, tpl = fused_update.flatten_state(
            popt.create_state(i, mx.nd.array(w, ctx=mx.cpu())))
        pst.append(fused_update.unflatten(tpl, [x._data for x in leaves]))
    jst = [jfused.unflatten(jfused.state_template(s), [
        jnp.asarray(leaf._data) for leaf in jfused.flatten_state(s)[0]])
        for s in (jopt.create_state(i, jmx.nd.array(w))
                  for i, w in enumerate(w0))]
    keys = list(range(len(w0)))
    for g in grads:
        for i in keys:
            upd(i, mx.nd.array(g[i], ctx=mx.cpu()), ew[i])
        new_w, pst = _bulk(mx, name, pw, g, pst, popt, keys)
        pw = [w.numpy() for w in new_w]
        new_jw, jst = _bulk(jmx, name, jw, g, jst, jopt, keys)
        jw = [np.asarray(w) for w in new_jw]
    for i in keys:
        np.testing.assert_allclose(pw[i], ew[i].asnumpy(), **_TOL)
        np.testing.assert_allclose(pw[i], jw[i], **_TOL)
        for a, e, j in zip(fused_update.flatten_state(pst[i])[0],
                           _leaves(upd.states[i]),
                           jfused.flatten_state(jst[i])[0]):
            np.testing.assert_allclose(a.numpy(), e.asnumpy(), **_TOL)
            np.testing.assert_allclose(a.numpy(), np.asarray(j), **_TOL)
    assert not np.allclose(pw[0], w0[0])


SHAPES = [(32, 16), (64,), (3, 3, 4, 4), (7,)]
KEYS = ["p%d_weight" % i for i in range(len(SHAPES))]


def _kv_run(pkg, name, bucketed, dtype):
    """Init, then three pushes of two streams a key; the pulled weights
    and the store."""
    kv = pkg.kv.create("device")
    kv.set_bucketing(bucketed)
    kv.set_optimizer(pkg.optimizer.create(
        name, rescale_grad=0.5, wd=1e-3, multi_precision=dtype != "float32",
        **NEW[name]))

    def arr(a):
        x = jmx.nd.array(a) if pkg is jmx else mx.nd.array(a, ctx=mx.cpu())
        return x if dtype == "float32" else x.astype(dtype)

    rng = np.random.RandomState(0)
    for k, s in zip(KEYS, SHAPES):
        kv.init(k, arr(rng.normal(0, 1, s).astype(np.float32)))
    r = np.random.RandomState(1)
    for _ in range(3):
        kv.push(KEYS, [[arr(r.normal(0, 1, s).astype(np.float32))
                        for _ in range(2)] for s in SHAPES])
    outs = [arr(np.zeros(s, np.float32)) for s in SHAPES]
    kv.pull(KEYS, out=outs)
    return [_np(o) for o in outs], kv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FUSED)
def test_kvstore_bucketed_kinds_match_eager_and_jax(name, dtype):
    """The bucketed store applies the kind (its extras a device tensor)
    and agrees with the port's eager store and the JAX package's
    bucketed and eager stores: f32 weights at rtol 2e-5 / atol 1e-6, bf16
    weights within a bf16 ulp and their masters at the f32 bound against
    the eager streams."""
    tol = _BF16_TOL if dtype == "bfloat16" else _TOL
    got, port = _kv_run(mx, name, True, dtype)
    assert port._engine.stats["flushes"] > 0 and not port._warned
    for label, pkg, bucketed in (("port_eager", mx, False),
                                 ("jax", jmx, True),
                                 ("jax_eager", jmx, False)):
        ref, store = _kv_run(pkg, name, bucketed, dtype)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, err_msg=label, **tol)
        if dtype == "bfloat16" and label != "jax":
            for k, st in port._updater.states.items():
                np.testing.assert_allclose(
                    _np(st[1]), _np(store._updater.states[k][1]),
                    err_msg=label, **_TOL)


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.lr_scheduler.PolyScheduler(max_update=40, base_lr=0.3,
                                               pwr=2, final_lr=0.01),
    lambda pkg: pkg.lr_scheduler.CosineScheduler(max_update=40, base_lr=0.2,
                                                 final_lr=0.02),
    lambda pkg: pkg.lr_scheduler.WarmupScheduler(
        pkg.lr_scheduler.CosineScheduler(max_update=45, base_lr=0.1), 5,
        warmup_begin_lr=0.001),
    lambda pkg: pkg.lr_scheduler.WarmupScheduler(
        pkg.lr_scheduler.PolyScheduler(max_update=30, base_lr=0.5), 8),
], ids=["poly", "cosine", "warmup_cosine", "warmup_poly"])
def test_schedulers_match_jax_over_50_updates(make):
    """The rate at each of 50 updates equals the JAX package's, and an
    optimizer over the schedule applies it."""
    ours, theirs = make(mx), make(jmx)
    got = [ours(t) for t in range(1, 51)]
    assert got == [theirs(t) for t in range(1, 51)]
    assert len(set(got)) > 10
    opt = mx.optimizer.create("sgd", learning_rate=0.3,
                              lr_scheduler=make(mx))
    w = mx.nd.array(np.ones(3, np.float32), ctx=mx.cpu())
    upd = mx.optimizer.get_updater(opt)
    upd(0, mx.nd.array(np.ones(3, np.float32), ctx=mx.cpu()), w)
    assert opt._get_lr(0) == make(mx)(1)
