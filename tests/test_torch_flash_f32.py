"""PyTorch port: the split-TF32 arithmetic of the f32 attention kernels,
emulated on the CPU.

On the card the f32 forms of the flash kernels (forward, dK/dV, dQ) and
the one-shot prefill run every product on the tensor cores in split TF32
(``mxnet_tpu_torch/csrc/attention_f32.cuh``): each operand x is split
into hi = tf32(x), rounded to nearest with ties away from zero (the
rounding of ``cvt.rna.tf32.f32``), and lo = x - hi, which the tensor
cores read truncated to tf32; a product is lo*hi' + hi*lo' + hi*hi'
summed in f32.  This file emulates that arithmetic in torch (the TF32
rounding by int32 bit arithmetic, as the kernels do it) and shows that
it holds the card's tolerance against the port's plain f32 versions,
rtol 1e-4 / atol 1e-5 (``chip_smoke.py``'s), and that ONE TF32 product
does not: the reason for the split.  The kernels themselves run only on the card
(``chip_smoke.py``'s flash, prefill and head_dim phases); the parity
tests against the JAX package run the plain versions, unchanged.
"""
import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("mxnet_tpu_torch.kernels.flash_attention")
pa = importlib.import_module("mxnet_tpu_torch.kernels.paged_attention")

RTOL, ATOL = 1e-4, 1e-5
SHAPES = [(1, 2, 256, 128), (1, 1, 100, 36)]


def tf32(x):
    """f32 rounded to tf32 (10 mantissa bits), to nearest with ties away
    from zero: add half of the 13 dropped bits' weight to the magnitude
    bits and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncated(x):
    """What the tensor cores read of an f32 passed as tf32: the top 19
    bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, truncated(x - hi)


def mm_split(a, b):
    """a @ b in split TF32: the two cross products and hi * hi', f32."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_one(a, b):
    """a @ b as one TF32 product."""
    return tf32(a) @ tf32(b)


def _scores(q, k, scale, mm):
    S = q.shape[-2]
    s = mm(q, k.transpose(-1, -2)) * scale
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    return s.masked_fill(~causal, float("-inf"))


def forward(q, k, v, scale, mm):
    """(out, lse) of causal attention with every product through mm."""
    s = _scores(q, k, scale, mm)
    lse = torch.logsumexp(s, dim=-1)
    return mm(torch.exp(s - lse.unsqueeze(-1)), v), lse


def backward(q, k, v, do, lse, delta, scale, mm):
    """(dk, dv, dq): the dK/dV and dQ kernels' formulas through mm."""
    p = torch.exp(_scores(q, k, scale, mm) - lse.unsqueeze(-1))
    ds = p * (mm(do, v.transpose(-1, -2)) - delta.unsqueeze(-1)) * scale
    return (mm(ds.transpose(-1, -2), q), mm(p.transpose(-1, -2), do),
            mm(ds, k))


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            for _ in range(4)]


def _held(got, ref):
    return [bool(torch.allclose(a, b, rtol=RTOL, atol=ATOL))
            for a, b in zip(got, ref)]


def _plain(q, k, v, do, scale):
    """The plain versions' (out, lse) and (dk, dv, dq), the backward from
    the plain forward's lse and Dr as on the card."""
    out, lse = fa.flash_attention_fwd_plain(q, k, v, scale=scale)
    delta = (do * out).sum(-1)
    dk, dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                              scale=scale)
    dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                         scale=scale)
    return (out, lse), (dk, dv, dq), delta


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                       # the tf32 after 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0, 0.0],
                     dtype=torch.float32)
    np.testing.assert_array_equal(
        tf32(x).numpy(), np.array([one, -one, 1.0, 3.0, 0.0], np.float32))
    r = torch.from_numpy(np.random.RandomState(3).randn(4096)
                         .astype(np.float32))
    hi, lo = split(r)
    assert bool((truncated(hi) == hi).all())
    assert bool((truncated(lo) == lo).all())
    assert float(((hi - r).abs() / r.abs()).max()) <= 2.0 ** -11
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("shape", SHAPES)
def test_split_tf32_forward_holds_the_card_tolerance(shape):
    q, k, v, do = _inputs(shape, 0)
    sc = 1.0 / shape[-1] ** 0.5
    (out, lse), _, _ = _plain(q, k, v, do, sc)
    assert all(_held(forward(q, k, v, sc, mm_split), (out, lse)))


@pytest.mark.parametrize("shape", SHAPES)
def test_split_tf32_backward_holds_the_card_tolerance(shape):
    q, k, v, do = _inputs(shape, 1)
    sc = 1.0 / shape[-1] ** 0.5
    (_, lse), grads, delta = _plain(q, k, v, do, sc)
    assert all(_held(backward(q, k, v, do, lse, delta, sc, mm_split), grads))


@pytest.mark.parametrize("shape", SHAPES)
def test_one_tf32_product_does_not(shape):
    """The same formulas with a single TF32 product leave the tolerance:
    the forward's output and every gradient fail it."""
    q, k, v, do = _inputs(shape, 0)
    sc = 1.0 / shape[-1] ** 0.5
    (out, lse), grads, delta = _plain(q, k, v, do, sc)
    got = forward(q, k, v, sc, mm_one)
    assert not _held(got[:1], (out,))[0]
    assert not any(_held(backward(q, k, v, do, lse, delta, sc, mm_one),
                         grads))


def test_split_tf32_prefill_holds_the_card_tolerance():
    """The one-shot prefill's attention (``paged_prefill_attend_plain``'s
    formula on seq-major q/k/v) in split TF32 on the served length
    pattern at 2 heads of 128: every one of the S rows within the card
    tolerance of the plain version, which also wrote the caches."""
    B, S, H, D, bs, M = 8, 1024, 2, 128, 16, 64
    lengths = [20, 960, 0, 1024, 513, 77, 300, 641]
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
               for _ in range(3))
    nb = B * M
    kc = torch.zeros(nb, bs, H, D)
    vc = torch.zeros(nb, bs, H, D)
    table = torch.from_numpy(rng.permutation(nb).astype(np.int32)
                             .reshape(B, M))
    lens = torch.tensor(lengths, dtype=torch.int32)
    sc = 1.0 / D ** 0.5
    ref, _, _ = pa.paged_prefill_attend_plain(q, k, v, kc, vc, table, lens,
                                              scale=sc)
    out, _ = forward(*(t.transpose(1, 2) for t in (q, k, v)), sc, mm_split)
    assert _held([out.transpose(1, 2)], [ref]) == [True]
    for b, n in enumerate(lengths):
        j = torch.arange(n)
        rows = table[b, j // bs].long() * bs + j % bs
        assert torch.equal(kc.view(nb * bs, H, D)[rows], k[b, :n])
