"""PyTorch port: the Dropout op, its step seeds and its users against
the JAX package.

The two packages' random streams differ (``jax.random`` keys against
the port's counter-based draw from a per-step seed), so the draw is
held to its rule (keep share within binomial bounds, values 0 or the
reference's ``1 / (1 - p)`` rounded in the data's type, the ``axes``
broadcast), and the apply to the JAX package's bits: given the mask the
JAX op drew, the port's output equals the JAX output exactly in f32
and bit for bit in bf16 and f16.  The identity cases (``p = 0``, not
training) are exact.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.ops.registry import _OpCtxScope
from mxnet_tpu.ops.registry import get_op as jget_op

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import random as mxrandom
from mxnet_tpu_torch.base import torch_dtype
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.ops.nn import dropout_apply, dropout_mask, dropout_scale

DTYPES = ("float32", "bfloat16", "float16")
CFG = dict(num_classes=61, num_layers=2, d_model=32, num_heads=4, seq_len=12)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_draw(x, dtype, p, axes=(), key=3):
    """The JAX op's (output, mask) on ``x`` cast to ``dtype``, training."""
    data = jnp.asarray(x).astype(dtype)
    with _OpCtxScope(True, jax.random.PRNGKey(key)):
        out, mask = jget_op("Dropout").fn(data, p=p, axes=axes)
    return out, mask


def _np32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 \
        else t.view(torch.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,axes", [(0.1, ()), (0.5, ()), (0.3, (1,)),
                                    (0.25, (0, 2))])
def test_apply_of_the_jax_mask_is_exact(dtype, p, axes):
    """Given the JAX op's mask, ``dropout_apply`` gives the JAX output
    bit for bit (f32 exactly), and the mask's values are 0 or the
    port's ``dropout_scale`` (1 over ``1 - p`` rounded to the type)."""
    x = _x((6, 7, 5))
    out, mask = _jax_draw(x, dtype, p, axes)
    dt = torch_dtype(dtype)
    tx = torch.from_numpy(x).to(dt)
    tmask = torch.from_numpy(_np32(mask)).to(dt)
    got = dropout_apply(tx, tmask)
    want = torch.from_numpy(_np32(out)).to(dt)
    assert torch.equal(_bits(got), _bits(want))
    values = set(np.unique(_np32(mask)).tolist())
    assert values <= {0.0, dropout_scale(p, dt)}
    assert dropout_scale(p, dt) in values


@pytest.mark.parametrize("dtype", DTYPES)
def test_identity_cases_are_exact(dtype):
    """p = 0 while training, and any p while not training (mode
    'training'), return the data itself in both packages; mode 'always'
    draws outside training."""
    x = _x((4, 9))
    dt = torch_dtype(dtype)
    op = mx.ops.registry.get_op("Dropout").fn
    tx = torch.from_numpy(x).to(dt)
    jx = jnp.asarray(x).astype(dtype)
    for p, train in ((0.0, True), (0.5, False)):
        got, gmask = op(tx, p=p, is_train=train)
        with _OpCtxScope(train, jax.random.PRNGKey(0)):
            want, _ = jget_op("Dropout").fn(jx, p=p)
        assert torch.equal(_bits(got), _bits(torch.from_numpy(
            _np32(want)).to(dt)))
        assert got is tx and torch.equal(gmask, torch.ones_like(tx))
    drawn, _ = op(tx, p=0.5, is_train=False, mode="always")
    assert (drawn == 0).any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_draw_keeps_within_binomial_bounds(dtype, p):
    """The port's draw over 2^18 elements: a keep share within 5 sigma
    of 1 - p, values 0 or the scale, and with ``axes`` one value along
    them."""
    n = 1 << 18
    t = torch.ones(n, dtype=torch_dtype(dtype))
    mask = dropout_mask(t, p)
    share = (mask != 0).double().mean().item()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(share - (1 - p)) < 5 * sigma
    assert set(torch.unique(mask.float()).tolist()) == {
        0.0, dropout_scale(p, t.dtype)}
    t3 = torch.ones(64, 32, 16, dtype=t.dtype)
    m3 = dropout_mask(t3, p, axes=(1,))
    assert m3.shape == (64, 1, 16)
    out = dropout_apply(t3, m3)
    assert torch.equal(out, m3.expand(t3.shape))


def test_keep_mask_is_a_function_of_seed_and_site():
    """The same seed and site give the same bits, another site or seed
    other bits; the seed comes from the device generator, which
    ``mx.random.seed`` repeats."""
    seed = torch.tensor(12345, dtype=torch.int64)
    a = mxrandom.keep_mask(seed, 0, (512,), 0.5, "cpu")
    assert torch.equal(a, mxrandom.keep_mask(seed, 0, (512,), 0.5, "cpu"))
    assert not torch.equal(a, mxrandom.keep_mask(seed, 1, (512,), 0.5,
                                                 "cpu"))
    assert not torch.equal(a, mxrandom.keep_mask(seed + 1, 0, (512,), 0.5,
                                                 "cpu"))
    mx.random.seed(7)
    s1 = [int(mxrandom.next_seed("cpu")) for _ in range(3)]
    mx.random.seed(7)
    assert s1 == [int(mxrandom.next_seed("cpu")) for _ in range(3)]
    assert len(set(s1)) == 3


def test_imperative_dropout_follows_train_mode():
    """``mx.nd.Dropout`` draws under ``train_mode`` (a fresh seed each
    call), is the identity outside it, and its gradient is the mask."""
    x = mx.nd.array(_x((32, 16)), ctx=mx.cpu())
    assert np.array_equal(mx.nd.Dropout(x, p=0.5).asnumpy(), x.asnumpy())
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Dropout(x, p=0.5)
    y.backward()
    mask = y.asnumpy() / x.asnumpy()
    np.testing.assert_allclose(x.grad.asnumpy(), mask, rtol=1e-6)
    assert set(np.round(np.unique(mask), 5)) == {0.0, 2.0}
    with mx.autograd.train_mode():
        a = mx.nd.Dropout(x, p=0.5).asnumpy()
        b = mx.nd.Dropout(x, p=0.5).asnumpy()
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("hybrid", [False, True])
def test_gluon_dropout_matches_jax_outside_training(hybrid):
    """``nn.Dropout`` in a Sequential, both packages: predict-mode
    outputs equal (the identity); under ``record`` the port's keep share
    is within bounds and kept values are ``x / (1 - rate)``."""
    x = _x((64, 32))
    outs = []
    for pkg in (jmx, mx):
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Dropout(0.25))
        net.initialize()
        if hybrid:
            net.hybridize()
        arr = pkg.nd.array(x) if pkg is jmx else pkg.nd.array(x, ctx=mx.cpu())
        outs.append(net(arr).asnumpy())
        if pkg is mx:
            with mx.autograd.record():
                y = net(arr).asnumpy()
            kept = y != 0
            n = kept.size
            assert abs(kept.mean() - 0.75) < 5 * (0.1875 / n) ** 0.5
            np.testing.assert_allclose(y[kept], x[kept] / 0.75, rtol=1e-6)
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_transformer_dropout_sites_match_jax(dtype):
    """``dropout > 0`` adds the reference's Dropout nodes, with its
    names and ``p``, in f32, bf16 and f16; the arguments are
    unchanged."""
    def drops(s):
        nodes = json.loads(s.tojson())["nodes"]
        return sorted((n["name"], n["attrs"]["p"]) for n in nodes
                      if n["op"] == "Dropout")
    sym = transformer.get_symbol(**CFG, dropout=0.1, dtype=dtype)
    jsym = jtransformer.get_symbol(**CFG, dropout=0.1, dtype=dtype)
    assert drops(sym) == drops(jsym)
    assert len(drops(sym)) == 1 + 2 * CFG["num_layers"]
    assert sym.list_arguments() == jsym.list_arguments() \
        == transformer.get_symbol(**CFG).list_arguments()


@pytest.mark.parametrize("dtype", DTYPES)
def test_transformer_with_dropout_trains_in_every_type(dtype):
    """The dropout LM binds with gradients in f32, bf16 and f16, and a
    train forward/backward gives finite gradients and a loss that
    differs from the inference forward's (the masks drew)."""
    sym = transformer.get_symbol(**CFG, dropout=0.1, dtype=dtype)
    exe = sym.simple_bind(mx.cpu(), grad_req="write", data=(2, 12),
                          softmax_label=(24,))
    rng = np.random.RandomState(5)
    for name, arr in exe.arg_dict.items():
        if name not in ("data", "softmax_label"):
            arr[:] = (rng.randn(*arr.shape) * 0.1).astype(np.float32)
    data = rng.randint(0, 61, (2, 12)).astype(np.float32)
    label = np.roll(data, -1, 1).reshape(-1)
    infer = exe.forward(is_train=False, data=data,
                        softmax_label=label)[0].asnumpy()
    train = exe.forward(is_train=True, data=data,
                        softmax_label=label)[0].asnumpy()
    exe.backward()
    assert not np.array_equal(infer, train)
    for name, g in exe.grad_dict.items():
        assert torch.isfinite(g._data.float()).all(), name
