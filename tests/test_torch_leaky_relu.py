"""PyTorch port: every LeakyReLU act against the JAX package.

leaky, prelu (with its learned ``gamma``), elu, selu, gelu (erf form)
and rrelu, forward and the input and ``gamma`` gradients against
``jax.vjp`` of the JAX op on the same numpy inputs: f32 at rtol 2e-5 /
atol 1e-6; bf16 and f16 element by element within one ulp of the JAX
result, or, where the two differ by more, no farther from the exact
value (the same act in f64 on the same 16-bit inputs) than the JAX
result is, plus one ulp.  (The JAX package rounds after each step, and
its f16 ``expm1`` is itself an ulp off, which the gradient's
``expm1(x) + 1`` magnifies to tens of ulps; the port computes these
acts in f32 and rounds once.)

rrelu outside training is exact.  In training its slopes come from the
port's counter-based draw (the two packages' random streams differ):
they lie in ``[lower_bound, upper_bound)``, one seed gives one set of
slopes, two steps give two, and the output is ``where(x > 0, x, s *
x)`` for the drawn ``s``, exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.registry import _OpCtxScope
from mxnet_tpu.ops.registry import get_op as jget_op

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import random as mxrandom
from mxnet_tpu_torch.base import torch_dtype
from mxnet_tpu_torch.ops.nn import leaky_relu, rrelu_slopes

DTYPES = ("float32", "bfloat16", "float16")
ACTS = ("leaky", "prelu", "elu", "selu", "gelu", "rrelu")
# (mantissa bits, least normal exponent)
_FMT = {"bfloat16": (7, -126), "float16": (10, -14)}


def _inputs(shape=(4, 5, 6), seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    gamma = rng.rand(shape[1]).astype(np.float32)
    return x, dy, gamma


def _jax(x, dy, gamma, dtype, act, **kw):
    """The JAX op's output and its gradients (data, and gamma for
    prelu), not training."""
    jx = jnp.asarray(x).astype(dtype)
    jct = jnp.asarray(dy).astype(dtype)
    op = jget_op("LeakyReLU").fn
    with _OpCtxScope(False, jax.random.PRNGKey(0)):
        if act == "prelu":
            out, vjp = jax.vjp(lambda a, g: op(a, g, act_type=act, **kw), jx,
                               jnp.asarray(gamma).astype(dtype))
        else:
            out, vjp = jax.vjp(lambda a: op(a, None, act_type=act, **kw), jx)
        grads = vjp(jct)
    return [np.array(jnp.asarray(t).astype(jnp.float32)).astype(np.float64)
            for t in (out,) + tuple(grads)]


def _port(x, dy, gamma, dtype, act, cast=None, **kw):
    """The port's output and gradients on the ``dtype``-rounded inputs,
    computed in ``cast`` (default ``dtype``)."""
    dt = torch_dtype(dtype)
    cast = cast or dt
    tx = torch.from_numpy(x).to(dt).to(cast).requires_grad_()
    tg = torch.from_numpy(gamma).to(dt).to(cast).requires_grad_()
    out = leaky_relu(tx, tg if act == "prelu" else None, act_type=act, **kw)
    leaves = [tx, tg] if act == "prelu" else [tx]
    grads = torch.autograd.grad(out, leaves,
                                torch.from_numpy(dy).to(dt).to(cast))
    assert out.dtype == cast and all(g.dtype == cast for g in grads)
    return [t.detach().double().numpy() for t in (out,) + tuple(grads)]


def _ulp(a, dtype):
    mant, lo = _FMT[dtype]
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** lo)))
    return 2.0 ** (e - mant)


def _hold_16bit(port, ref, exact, dtype, what):
    u = _ulp(np.maximum(np.abs(port), np.abs(ref)), dtype)
    ok = (np.abs(port - ref) <= u) \
        | (np.abs(port - exact) <= np.abs(ref - exact) + u)
    assert ok.all(), "%s: %d elements, e.g. port %s, JAX %s, exact %s" % (
        what, int((~ok).sum()), port[~ok][:3], ref[~ok][:3], exact[~ok][:3])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ACTS)
def test_act_and_gradients_match_jax(act, dtype):
    x, dy, gamma = _inputs()
    kw = dict(slope=0.3) if act in ("leaky", "elu") else {}
    want = _jax(x, dy, gamma, dtype, act, **kw)
    got = _port(x, dy, gamma, dtype, act, **kw)
    assert len(got) == len(want) == (3 if act == "prelu" else 2)
    if dtype == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-6)
        return
    exact = _port(x, dy, gamma, dtype, act, cast=torch.float64, **kw)
    for what, g, w, e in zip(("out", "d_data", "d_gamma"), got, want, exact):
        _hold_16bit(g, w, e, dtype, "%s %s %s" % (act, dtype, what))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rrelu_outside_training_is_exact(dtype):
    """Not training, rrelu's slope is ``(lower + upper) / 2`` in both
    packages, bit for bit."""
    x, dy, gamma = _inputs(seed=1)
    kw = dict(lower_bound=0.1, upper_bound=0.4)
    want = _jax(x, dy, gamma, dtype, "rrelu", **kw)
    got = _port(x, dy, gamma, dtype, "rrelu", **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rrelu_training_draws_from_the_step_seed(dtype):
    """In training each element's slope is drawn from the walk's step
    seed: in range, the same for the same seed and site, new for a new
    seed, and the output is ``where(x > 0, x, s * x)`` exactly."""
    dt = torch_dtype(dtype)
    x = torch.from_numpy(_inputs((8, 16, 32), seed=2)[0]).to(dt)
    lo, hi = 0.125, 0.334

    def draw(seed):
        rng = mxrandom.StepRandom(torch.tensor(seed, dtype=torch.int64))
        out = leaky_relu(x, act_type="rrelu", lower_bound=lo,
                         upper_bound=hi, is_train=True, rng=rng)
        slopes = rrelu_slopes(x, lo, hi, mxrandom.StepRandom(
            torch.tensor(seed, dtype=torch.int64)))
        return out, slopes

    out, s = draw(11)
    out2, s2 = draw(11)
    out3, s3 = draw(12)
    assert s.dtype == dt and s.shape == x.shape
    s32 = mxrandom.uniform(torch.tensor(11), 0, x.shape, lo, hi, "cpu")
    assert float(s32.min()) >= np.float32(lo) and float(s32.max()) < \
        np.float32(hi)
    # the slopes spread over the interval
    assert abs(float(s32.mean()) - (lo + hi) / 2) < 0.01
    assert torch.equal(s, s2) and torch.equal(out, out2)
    assert not torch.equal(s, s3)
    assert torch.equal(out, torch.where(x > 0, x, s * x))


def test_rrelu_gradient_is_the_drawn_slope():
    """The rrelu gradient is 1 above zero and the drawn slope below."""
    x = torch.from_numpy(_inputs((4, 6, 7), seed=3)[0]).requires_grad_()
    seed = torch.tensor(5, dtype=torch.int64)
    out = leaky_relu(x, act_type="rrelu", is_train=True,
                     rng=mxrandom.StepRandom(seed))
    (g,) = torch.autograd.grad(out.sum(), x)
    s = rrelu_slopes(x.detach(), 0.125, 0.334, mxrandom.StepRandom(seed))
    assert torch.equal(g, torch.where(x.detach() > 0, torch.ones_like(s), s))


def test_prelu_symbol_creates_gamma_with_the_reference_shape():
    """``sym.LeakyReLU(act_type='prelu')`` creates ``{name}_gamma`` of
    shape (C,), the JAX package's rule; the other acts take no gamma."""
    import mxnet_tpu as jmx
    for pkg in (mx, jmx):
        d = pkg.sym.Variable("data")
        p = pkg.sym.LeakyReLU(d, act_type="prelu", name="pr")
        assert p.list_arguments() == ["data", "pr_gamma"]
        args, outs, _ = p.infer_shape(data=(2, 5, 3, 3))
        assert [tuple(a) for a in args] == [(2, 5, 3, 3), (5,)]
        assert [tuple(o) for o in outs] == [(2, 5, 3, 3)]
        e = pkg.sym.LeakyReLU(d, act_type="elu", name="el")
        assert e.list_arguments() == ["data"]


def test_rrelu_in_an_executor_replays_under_mirror(monkeypatch):
    """A bound rrelu graph: two train forwards draw two sets of slopes,
    and under MXNET_BACKWARD_DO_MIRROR the recompute replays the
    forward's slopes (the gradients equal the unmirrored ones)."""
    d = mx.sym.Variable("data")
    net = mx.sym.LeakyReLU(mx.sym.FullyConnected(d, num_hidden=8, name="fc"),
                           act_type="rrelu", name="rr")
    x = _inputs((4, 6), seed=4)[0]
    w = np.random.RandomState(5).randn(8, 6).astype(np.float32)

    def run(mirror, seed):
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", mirror)
        exe = net.simple_bind(ctx=mx.cpu(), grad_req="write", data=(4, 6))
        exe.copy_params_from({"fc_weight": w,
                              "fc_bias": np.zeros(8, np.float32)})
        mx.random.seed(seed)
        out = exe.forward(is_train=True, data=x)[0].asnumpy()
        exe.backward(mx.nd.ones((4, 8), ctx=mx.cpu()))
        return out, exe.grad_dict["fc_weight"].asnumpy()

    o1, g1 = run("0", 3)
    o2, g2 = run("1", 3)
    o3, _ = run("0", 4)
    assert np.array_equal(o1, o2) and np.array_equal(g1, g2)
    assert not np.array_equal(o1, o3)
