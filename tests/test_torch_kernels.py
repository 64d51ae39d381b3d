"""PyTorch port: the kernels' plain versions against the JAX package's
Pallas kernels (and, for causal attention, its XLA reference path).

Each case makes its inputs with a seeded numpy RandomState, runs the JAX
kernel the way the JAX suite runs it on the CPU (Pallas interpret mode,
the default off a TPU) and the port's wrapper on CPU tensors, which
takes the plain PyTorch version, and compares at the JAX suite's own
f32 bound (rtol 2e-5, atol 1e-6).  The geometries are those of
tests/test_pallas.py.  The CUDA kernels themselves are held against the
same plain versions on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu.pallas import (layernorm_fused as jax_layernorm,
                              paged_chunk_prefill_attend as jax_chunk,
                              paged_decode_attend as jax_decode)
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import (LAUNCHES, PLAIN_CALLS, flash_attention,
                                     flash_attention_plain, layernorm,
                                     layernorm_fused, paged_chunk_prefill_attend,
                                     paged_decode_attend, reset_counts)

RTOL, ATOL = 2e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The tensors here are tiny and gain nothing from many intra-op
    threads; two keep this file off the cores that timing-sensitive
    tests running beside it in other workers measure."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape):
    return (rng.randn(*shape) * 0.5).astype(np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ----------------------------------------------------------------------
# paged decode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bs,H,D", [(8, 2, 8), (16, 4, 4)])
def test_decode_matches_pallas(bs, H, D):
    """Ragged positions, an inactive slot (exact zeros in both), a slot
    mid-first-block and one at the table's last row."""
    rng = np.random.RandomState(3)
    nb, M, C = 10, 5, 4
    q = _rand(rng, C, H, D)
    kc = _rand(rng, nb, bs, H, D)
    vc = _rand(rng, nb, bs, H, D)
    table = rng.randint(0, nb, (C, M)).astype(np.int32)
    pos = np.array([bs - 2, 3 * bs + 1, -1, M * bs - 1], np.int32)
    sc = 1.0 / np.sqrt(D)
    ref = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(table),
                                jnp.asarray(pos), scale=sc))
    out = paged_decode_attend(_t(q), _t(kc), _t(vc), _t(table), _t(pos),
                              scale=sc).numpy()
    active = pos >= 0
    np.testing.assert_allclose(out[active], ref[active], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(out[~active], 0.0)
    np.testing.assert_array_equal(ref[~active], 0.0)


def test_decode_bf16_cache_matches_pallas():
    """bf16 caches, f32 queries: both versions widen the same bf16
    values to f32, so the f32 bound holds."""
    rng = np.random.RandomState(4)
    nb, bs, H, D, C, M = 6, 8, 2, 8, 2, 3
    q = _rand(rng, C, H, D)
    kc = jnp.asarray(_rand(rng, nb, bs, H, D)).astype(jnp.bfloat16)
    vc = jnp.asarray(_rand(rng, nb, bs, H, D)).astype(jnp.bfloat16)
    table = rng.randint(0, nb, (C, M)).astype(np.int32)
    pos = np.array([2 * bs, bs - 1], np.int32)
    sc = 1.0 / np.sqrt(D)
    ref = np.asarray(jax_decode(jnp.asarray(q), kc, vc, jnp.asarray(table),
                                jnp.asarray(pos), scale=sc))
    k32 = np.asarray(kc.astype(jnp.float32))
    v32 = np.asarray(vc.astype(jnp.float32))
    out = paged_decode_attend(_t(q), _t(k32, torch.bfloat16),
                              _t(v32, torch.bfloat16), _t(table), _t(pos),
                              scale=sc)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# paged chunked prefill
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bs,S,K", [(8, 19, 8), (4, 13, 8), (8, 30, 16),
                                    (8, 19, 6)])
def test_chunk_prefill_matches_pallas(bs, S, K):
    """A prompt fed K rows at a time over a live cache: outputs of the
    real rows and the whole caches agree after every chunk.  K=6 at
    bs=8 makes chunks straddle block boundaries; the last chunk of each
    case has a ragged length."""
    rng = np.random.RandomState(21)
    B, H, D, nb = 1, 2, 8, 12
    M = -(-S // bs) + 1
    q = _rand(rng, B, S, H, D)
    k = _rand(rng, B, S, H, D)
    v = _rand(rng, B, S, H, D)
    kc = _rand(rng, nb, bs, H, D)
    vc = _rand(rng, nb, bs, H, D)
    table = ((np.arange(M) + 3) % nb).astype(np.int32).reshape(B, M)
    sc = 1.0 / np.sqrt(D)
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    tk, tv = _t(kc), _t(vc)
    st = 0
    while st < S:
        L = min(K, S - st)
        pad = [np.zeros((B, K, H, D), np.float32) for _ in range(3)]
        for p, a in zip(pad, (q, k, v)):
            p[:, :L] = a[:, st:st + L]
        ref, jk, jv = jax_chunk(*(jnp.asarray(p) for p in pad), jk, jv,
                                jnp.asarray(table),
                                jnp.asarray([st], jnp.int32),
                                jnp.asarray([L], jnp.int32), scale=sc)
        out, tk2, tv2 = paged_chunk_prefill_attend(
            *(_t(p) for p in pad), tk, tv, _t(table),
            _t(np.array([st], np.int32)), _t(np.array([L], np.int32)),
            scale=sc)
        assert tk2 is tk and tv2 is tv            # updated in place
        np.testing.assert_allclose(out.numpy()[:, :L],
                                   np.asarray(ref)[:, :L], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        st += L


def test_chunk_prefill_zero_length_is_noop():
    """len == 0 leaves the caches byte-identical in both packages."""
    rng = np.random.RandomState(22)
    B, K, H, D, nb, bs, M = 1, 8, 2, 4, 6, 4, 3
    z = np.zeros((B, K, H, D), np.float32)
    kc = _rand(rng, nb, bs, H, D)
    vc = _rand(rng, nb, bs, H, D)
    table = np.zeros((B, M), np.int32)
    zero = np.array([0], np.int32)
    _, jk, jv = jax_chunk(jnp.asarray(z), jnp.asarray(z), jnp.asarray(z),
                          jnp.asarray(kc), jnp.asarray(vc),
                          jnp.asarray(table), jnp.asarray(zero),
                          jnp.asarray(zero), scale=0.5)
    tk, tv = _t(kc), _t(vc)
    paged_chunk_prefill_attend(_t(z), _t(z), _t(z), tk, tv, _t(table),
                               _t(zero), _t(zero), scale=0.5)
    for got, jax_got, orig in ((tk, jk, kc), (tv, jv, vc)):
        np.testing.assert_array_equal(got.numpy(), orig)
        np.testing.assert_array_equal(np.asarray(jax_got), orig)


# ----------------------------------------------------------------------
# fused LayerNorm
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape,with_res", [((6, 40), False),
                                            ((6, 40), True),
                                            ((2, 3, 130), False),
                                            ((9, 2048), True)])
def test_layernorm_matches_pallas(shape, with_res):
    rng = np.random.RandomState(11)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    res = rng.randn(*shape).astype(np.float32) if with_res else None
    g = rng.randn(shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    ref = jax_layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                        residual=None if res is None else jnp.asarray(res),
                        eps=1e-5)
    got = layernorm_fused(_t(x), _t(g), _t(b),
                          residual=None if res is None else _t(res),
                          eps=1e-5)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("shape,with_res", [((6, 40), False),
                                            ((6, 40), True),
                                            ((3, 5, 130), True),
                                            ((13, 2048), False)])
def test_layernorm_backward_matches_pallas(monkeypatch, shape, with_res):
    """dx, dgamma, dbeta and dres of the port's LayerNormFn (its backward
    is layernorm_bwd_plain on CPU tensors) against jax.vjp of the Pallas
    kernel pair in interpret mode; rows not a multiple of 8, features
    not a multiple of 128.  dgamma/dbeta sum over the rows in another
    order: the f32 bound holds at these row counts."""
    monkeypatch.setenv("MXNET_LN_IMPL", "pallas")
    rng = np.random.RandomState(12)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    res = rng.randn(*shape).astype(np.float32) if with_res else None
    g = rng.randn(shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)

    def f(x, g, b, *r):
        return jax_layernorm(x, g, b, residual=r[0] if r else None,
                             eps=1e-5)[0]

    jargs = [jnp.asarray(a) for a in (x, g, b) + ((res,) if with_res else ())]
    _, vjp = jax.vjp(f, *jargs)
    ref = vjp(jnp.asarray(dy))

    targs = [_t(a).requires_grad_() for a in (x, g, b)
             + ((res,) if with_res else ())]
    reset_counts()
    out = layernorm(*targs[:3], residual=targs[3] if with_res else None,
                    eps=1e-5)[0]
    got = torch.autograd.grad(out, targs, _t(dy))
    assert PLAIN_CALLS["layernorm_fused_bwd"] == 1
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


def _jax_causal_attention(q, k, v, scale):
    """The JAX package's XLA attention path (what ``_use_flash_attention``
    picks off a TPU), through ``_contrib_CausalSelfAttention`` on the
    packed (B, S, 3d) layout; (B, H, S, D) in and out."""
    B, H, S, D = q.shape
    pack = lambda t: t.transpose(0, 2, 1, 3).reshape(B, S, H * D)
    qkv = jnp.concatenate([pack(q), pack(k), pack(v)], axis=-1)
    o = jget_op("_contrib_CausalSelfAttention").fn(qkv, num_heads=H,
                                                   scale=scale)
    return o.reshape(B, S, H, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,H,S,D", [(2, 2, 16, 8), (1, 3, 23, 16),
                                     (2, 1, 65, 4)])
def test_flash_attention_matches_jax(B, H, S, D):
    """Forward and dq/dk/dv of the port's causal attention against
    jax.vjp of the JAX package's XLA path, for both the reference
    (flash_attention_plain, autograd's backward) and FlashAttentionFn,
    whose forward and two backward wrappers take their plain versions
    on CPU tensors; odd S and S past one 64-row tile.  rtol 2e-5 /
    atol 1e-6, the reference's own bound."""
    rng = np.random.RandomState(B * 100 + S)
    q, k, v, do = (_rand(rng, B, H, S, D) for _ in range(4))
    sc = 1.0 / np.sqrt(D)
    ref_o, vjp = jax.vjp(lambda q, k, v: _jax_causal_attention(q, k, v, sc),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = (ref_o,) + vjp(jnp.asarray(do))
    reset_counts()
    for fn in (flash_attention_plain, flash_attention):
        ins = [_t(a).requires_grad_() for a in (q, k, v)]
        out = fn(*ins, scale=sc)
        got = (out,) + torch.autograd.grad(out, ins, _t(do))
        for a, r in zip(got, ref):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(r),
                                       rtol=RTOL, atol=ATOL)
    assert PLAIN_CALLS["flash_attention_fwd"] == 1
    assert PLAIN_CALLS["flash_attention_bwd_dkv"] == 1
    assert PLAIN_CALLS["flash_attention_bwd_dq"] == 1
    assert not any(LAUNCHES.values())


# ----------------------------------------------------------------------
# the device decides the path
# ----------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_versions():
    reset_counts()
    x = torch.ones(2, 8)
    layernorm_fused(x, torch.ones(8), torch.zeros(8))
    assert PLAIN_CALLS["layernorm_fused"] == 1
    assert LAUNCHES["layernorm_fused"] == 0


def test_unsupported_or_mixed_devices_raise():
    x = torch.ones(2, 8, device="meta")
    with pytest.raises(MXNetError, match="no kernel or plain version"):
        layernorm_fused(x, torch.ones(8, device="meta"),
                        torch.zeros(8, device="meta"))
    with pytest.raises(MXNetError, match="share one device"):
        layernorm_fused(torch.ones(2, 8), torch.ones(8, device="meta"),
                        torch.zeros(8))
