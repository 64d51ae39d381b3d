"""PyTorch port: the fused_band4d kernel's plain version and the
fused-sandwich microbenchmark, against the JAX package's tool.

``tools/fused_sandwich_bench.py`` imports Pallas at the top and calls
``pl.pallas_call`` without interpret mode, so the tool is loaded here
under its own name and its ``pl`` replaced, in this test module only,
by one whose ``pallas_call`` interprets: ``pal4d_band`` then runs its
Pallas kernel on the CPU, at shapes that pick each of its row-band
heights (th = 16, 8 and 1).  Tolerances: f32 rtol 2e-5 / atol 1e-6
(the sums over K run in another order); bf16 within one bf16 ulp of
the larger of the two values (the f32 sums differ in their last bits,
and one rounding to bf16 may then land on the neighbouring value); f16
within one f16 ulp at the output array's scale (its largest magnitude):
a few of the interpreted reference's small f16 outputs land 2 f16 ulps
of their own value from the exact sum, where the port's plain version
lands within one.
"""
import importlib.util
import os
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import fused_band4d, fused_band4d_plain
from mxnet_tpu_torch.tools import fused_sandwich as fs

_TOOL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "fused_sandwich_bench.py")


@pytest.fixture(scope="module")
def fsb():
    spec = importlib.util.spec_from_file_location("_fused_sandwich_bench",
                                                  _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = SimpleNamespace(pallas_call=partial(pl.pallas_call,
                                                 interpret=True),
                             BlockSpec=pl.BlockSpec)
    return mod


def _band_inputs(shape, K, N, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, K).astype(np.float32)
    s = (rng.rand(K) + 0.5).astype(np.float32)
    t = rng.randn(K).astype(np.float32)
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    return x, s, t, w


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    m = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(m)) - 7)


def _f16_ulp(v):
    """One f16 ulp at |v| (11 significant bits; 2^-24 among the
    subnormals)."""
    m = np.maximum(np.abs(v), np.float32(2.0 ** -14))
    return np.exp2(np.floor(np.log2(m)) - 10)


def _th(h, w):
    for cand in (16, 8, 4, 2):
        if h % cand == 0 and cand * w >= 128:
            return cand
    return 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape,K,N,th", [((1, 16, 8), 24, 40, 16),
                                          ((2, 8, 16), 32, 16, 8),
                                          ((2, 28, 28), 16, 36, 1),
                                          ((1, 8, 16), 72, 64, 8)])
def test_plain_matches_pal4d_band(fsb, shape, K, N, th, dtype):
    assert _th(shape[1], shape[2]) == th
    x, s, t, w = _band_inputs(shape, K, N, seed=K * N)
    jdt = getattr(jnp, dtype)
    ref = fsb.pal4d_band(jnp.asarray(x).astype(jdt), jnp.asarray(s),
                         jnp.asarray(t), jnp.asarray(w).astype(jdt))
    ref = np.asarray(ref.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    before = kernels.PLAIN_CALLS["fused_band4d"]
    got = fused_band4d(torch.from_numpy(x).to(tdt), torch.from_numpy(s),
                       torch.from_numpy(t), torch.from_numpy(w).to(tdt))
    assert kernels.PLAIN_CALLS["fused_band4d"] == before + 1
    assert got.dtype == tdt and tuple(got.shape) == shape + (N,)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6)
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(ref))) \
            if dtype == "bfloat16" else _f16_ulp(np.abs(ref).max())
        assert (np.abs(got - ref) <= ulp).all()
        assert (got == ref).mean() > 0.99


def test_strided_inputs_take_no_copy_and_give_the_same_values():
    """A channels_last view of an NCHW tensor (channel stride H*W) and a
    channel slice of a wider tensor go through as they are and give the
    values of the contiguous tensor, bit for bit."""
    x, s, t, w = _band_inputs((2, 6, 5), 12, 20, seed=3)
    ref = fused_band4d_plain(torch.from_numpy(x), torch.from_numpy(s),
                             torch.from_numpy(t), torch.from_numpy(w))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    view = nchw.permute(0, 2, 3, 1)
    assert not view.is_contiguous() and view.stride()[3] == 6 * 5
    wide = torch.zeros(2, 6, 5, 16)
    wide[..., :12] = torch.from_numpy(x)
    sliced = wide[..., :12]
    cl = nchw.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    for xv in (view, sliced, cl):
        got = fused_band4d(xv, torch.from_numpy(s), torch.from_numpy(t),
                           torch.from_numpy(w))
        assert got.is_contiguous()
        assert torch.equal(got, ref)


def test_raises_on_mismatched_dtypes_and_shapes():
    x, s, t, w = (torch.from_numpy(a)
                  for a in _band_inputs((1, 4, 4), 8, 8, seed=5))
    with pytest.raises(mx.MXNetError, match="w has dtype"):
        fused_band4d(x.bfloat16(), s, t, w)
    with pytest.raises(mx.MXNetError, match="expected \\(8, N\\)"):
        fused_band4d(x, s, t, w[:6])
    with pytest.raises(mx.MXNetError, match="4-D"):
        fused_band4d(x[0], s, t, w)
    with pytest.raises(mx.MXNetError, match="scale has dtype"):
        fused_band4d(x, s.double(), t, w)
    with pytest.raises(mx.MXNetError, match="shift has shape"):
        fused_band4d(x, s, t[:4], w)
    with pytest.raises(mx.MXNetError, match="x has dtype"):
        fused_band4d(x.double(), s, t, w.double())
    with pytest.raises(mx.MXNetError, match="share one device"):
        fused_band4d(x, s, t, w.to("meta"))


_SMALL = dict(B=2, H=8, W=8, c=8, C=16)


@pytest.mark.parametrize("arm", list(fs.ARMS))
def test_sandwich_arms_match_jax_net(fsb, arm):
    """Each arm's net, in f32 on the CPU, against the JAX tool's
    ``make_net(xla_band)`` and ``make_net(pal4d_band)`` on the same
    seed-0 inputs: within rtol 1e-5 of the output's largest magnitude
    (two convolutions and two bands, sums in another order)."""
    args = fs.inputs(torch.device("cpu"), torch.float32, **_SMALL)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    with torch.no_grad():
        got = fs.make_net(fs.ARMS[arm])(*fs.arm_args(arm, args)).numpy()
    assert got.shape == (2, 8, 8, 8)
    for band in (fsb.xla_band, fsb.pal4d_band):
        ref = np.asarray(fsb.make_net(band)(*jargs))
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_sandwich_inputs_follow_the_reference_draws(fsb, monkeypatch):
    """``inputs`` draws as the reference's ``main``: its bf16 arrays
    equal the port's bit for bit."""
    for k, v in _SMALL.items():
        monkeypatch.setattr(fsb, {"B": "B", "H": "H", "W": "W_", "c": "c",
                                  "C": "C"}[k], v)
    captured = {}

    def fake_bench(net, args):
        captured.setdefault("args", args)
        return 0.0

    monkeypatch.setattr(fsb, "bench", fake_bench)
    fsb.main()
    port = fs.inputs(torch.device("cpu"), torch.bfloat16, **_SMALL)
    for a, b in zip(captured["args"], port):
        assert np.array_equal(np.asarray(a.astype(jnp.float32)),
                              b.float().numpy())


def test_step_patches_the_carry_and_bench_needs_the_card():
    args = fs.inputs(torch.device("cpu"), torch.float32, **_SMALL)
    x = args[0].clone()
    net = fs.make_net(fs.ARMS["pal4d"])
    with torch.no_grad():
        y = net(x, *args[1:])
        fs.step(net, x, args[1:])
    assert x[0, 0, 0, 0] == (y[0, 0, 0, :8].sum() * 1e-30)
    assert torch.equal(x.flatten()[1:], args[0].flatten()[1:])
    with pytest.raises(mx.MXNetError, match="on the card"):
        fs.bench(net, args)
