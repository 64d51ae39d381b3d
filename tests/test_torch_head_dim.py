"""PyTorch port: attention at head_dim 256 and 512, which the reference
runs and the port's kernels now take (their CUDA forms tile head_dim).

The plain versions of the flash, one-shot prefill, chunked prefill and
decode kernels (the CPU path of each wrapper) are held against the JAX
package's functions at those head_dims: the XLA attention path for
flash (what the JAX package picks off a TPU) through ``jax.vjp``, the
Pallas kernels in interpret mode for the paged ones, as the JAX suite
runs them.  f32 throughout, at the reference's own bound (rtol 2e-5,
atol 1e-6); cache bytes exactly.  Then a one-layer transformer with
d_model 512 and 2 heads (head_dim 256) takes one ``TrainStep`` step in
both packages from the same numpy weights.  The CUDA kernels are held
against these plain versions at the same head_dims on the card by
chip_smoke.py's head_dim phase.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu.pallas import (paged_chunk_prefill_attend as jax_chunk,
                              paged_decode_attend as jax_decode,
                              paged_prefill_attend as jax_prefill)
from mxnet_tpu.parallel.trainer import TrainStep as JTrainStep

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import (LAUNCHES, PLAIN_CALLS, flash_attention,
                                     paged_chunk_prefill_attend,
                                     paged_decode_attend,
                                     paged_prefill_attend, reset_counts)
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.parallel import TrainStep

RTOL, ATOL = 2e-5, 1e-6
HEAD_DIMS = (256, 512)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape):
    return (rng.randn(*shape) * 0.5).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_causal_attention(q, k, v, scale):
    """The JAX package's XLA attention path on (B, H, S, D)."""
    B, H, S, D = q.shape
    pack = lambda t: t.transpose(0, 2, 1, 3).reshape(B, S, H * D)
    qkv = jnp.concatenate([pack(q), pack(k), pack(v)], axis=-1)
    o = jget_op("_contrib_CausalSelfAttention").fn(qkv, num_heads=H,
                                                   scale=scale)
    return o.reshape(B, S, H, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_attention_head_dim_matches_jax(D):
    """FlashAttentionFn's output and dq/dk/dv (the three kernels' plain
    versions) against jax.vjp of the XLA path."""
    rng = np.random.RandomState(D)
    B, H, S = 1, 2, 20
    q, k, v, do = (_rand(rng, B, H, S, D) for _ in range(4))
    sc = 1.0 / np.sqrt(D)
    ref_o, vjp = jax.vjp(lambda q, k, v: _jax_causal_attention(q, k, v, sc),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = (ref_o,) + vjp(jnp.asarray(do))
    reset_counts()
    ins = [_t(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ins, scale=sc)
    got = (out,) + torch.autograd.grad(out, ins, _t(do))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r),
                                   rtol=RTOL, atol=ATOL)
    assert PLAIN_CALLS["flash_attention_bwd_dq"] == 1
    assert not any(LAUNCHES.values())


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_decode_head_dim_matches_pallas(D):
    rng = np.random.RandomState(D + 1)
    nb, bs, M, C, H = 6, 4, 3, 3, 2
    q = _rand(rng, C, H, D)
    kc, vc = _rand(rng, nb, bs, H, D), _rand(rng, nb, bs, H, D)
    table = rng.randint(0, nb, (C, M)).astype(np.int32)
    pos = np.array([2, -1, M * bs - 1], np.int32)
    sc = 1.0 / np.sqrt(D)
    ref = np.asarray(jax_decode(*(jnp.asarray(a) for a in (q, kc, vc, table,
                                                         pos)), scale=sc))
    out = paged_decode_attend(_t(q), _t(kc), _t(vc), _t(table), _t(pos),
                              scale=sc).numpy()
    act = pos >= 0
    np.testing.assert_allclose(out[act], ref[act], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(out[~act], 0.0)


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_chunk_prefill_head_dim_matches_pallas(D):
    """Two chunks of a 7-token prompt over a live cache: the real rows'
    outputs and the whole caches after each chunk."""
    rng = np.random.RandomState(D + 2)
    B, H, K, S, nb, bs = 1, 2, 4, 7, 6, 4
    M = -(-S // bs) + 1
    q, k, v = (_rand(rng, B, S, H, D) for _ in range(3))
    kc, vc = _rand(rng, nb, bs, H, D), _rand(rng, nb, bs, H, D)
    table = ((np.arange(M) + 2) % nb).astype(np.int32).reshape(B, M)
    sc = 1.0 / np.sqrt(D)
    jk, jv, tk, tv = jnp.asarray(kc), jnp.asarray(vc), _t(kc), _t(vc)
    for st in range(0, S, K):
        L = min(K, S - st)
        pad = [np.zeros((B, K, H, D), np.float32) for _ in range(3)]
        for p, a in zip(pad, (q, k, v)):
            p[:, :L] = a[:, st:st + L]
        ref, jk, jv = jax_chunk(*(jnp.asarray(p) for p in pad), jk, jv,
                                jnp.asarray(table),
                                jnp.asarray([st], jnp.int32),
                                jnp.asarray([L], jnp.int32), scale=sc)
        out, _, _ = paged_chunk_prefill_attend(
            *(_t(p) for p in pad), tk, tv, _t(table),
            _t(np.array([st], np.int32)), _t(np.array([L], np.int32)),
            scale=sc)
        np.testing.assert_allclose(out.numpy()[:, :L],
                                   np.asarray(ref)[:, :L], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_prefill_head_dim_matches_pallas(D):
    """Every output row and the caches byte for byte, one row shorter
    than S and one empty."""
    rng = np.random.RandomState(D + 3)
    B, S, H, nb, bs, M = 2, 9, 2, 8, 4, 3
    q, k, v = (_rand(rng, B, S, H, D) for _ in range(3))
    kc, vc = _rand(rng, nb, bs, H, D), _rand(rng, nb, bs, H, D)
    table = np.array([[5, 1, 7], [2, 0, 3]], np.int32)
    L = np.array([7, 0], np.int32)
    sc = 1.0 / np.sqrt(D)
    ref, jk, jv = jax_prefill(*(jnp.asarray(a) for a in (q, k, v, kc, vc,
                                                         table, L)),
                              scale=sc, interpret=True)
    tk, tv = _t(kc), _t(vc)
    out, _, _ = paged_prefill_attend(_t(q), _t(k), _t(v), tk, tv, _t(table),
                                     _t(L), scale=sc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_transformer_head_dim_256_trainstep_matches_jax():
    """A one-layer transformer at d_model 512 with 2 heads (head_dim
    256): outputs, and every parameter after one SGD step with momentum,
    within 1e-4 of each array's largest value (f32 sums in another order
    through the whole step, as tests/test_torch_trainstep.py bounds
    them)."""
    cfg = dict(num_classes=40, num_layers=1, d_model=512, num_heads=2,
               ffn_dim=256, seq_len=8)
    B, S = 2, cfg["seq_len"]
    rng = np.random.RandomState(9)
    sym, jsym = transformer.get_symbol(**cfg), jtransformer.get_symbol(**cfg)
    shapes = dict(data_shapes={"data": (B, S)},
                  label_shapes={"softmax_label": (B * S,)})
    arg_shapes, _, _ = sym.infer_shape(data=(B, S), softmax_label=(B * S,))
    params = {n: (rng.randn(*s) * 0.05).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    x = rng.randint(0, cfg["num_classes"], (B, S)).astype(np.float32)
    y = rng.randint(0, cfg["num_classes"], (B * S,)).astype(np.float32)
    opt = dict(learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / (B * S))
    ts = TrainStep(sym, mx.optimizer.SGD(**opt), ctx=mx.cpu(), **shapes)
    ts.init_params(mx.init.Xavier(), arg_params=params)
    out = ts.step({"data": x, "softmax_label": y})[0].numpy()
    jts = JTrainStep(jsym, jmx.optimizer.SGD(**opt), **shapes)
    jts.init_params(jmx.init.Xavier(), arg_params={
        n: jmx.nd.array(a) for n, a in params.items()})
    jout = np.asarray(jts.step({"data": x, "softmax_label": y})[0])
    np.testing.assert_allclose(out, jout, rtol=0,
                               atol=1e-4 * float(np.abs(jout).max()))
    for n, ref in jts.params.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(ts.params[n].numpy(), ref, rtol=0,
                                   atol=1e-4 * float(np.abs(ref).max()),
                                   err_msg=n)
