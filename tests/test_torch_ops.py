"""PyTorch port: operators and the whole mixed decode step against the
JAX package.

Inputs come from seeded numpy RandomStates and go through both packages
on the CPU: the JAX ops with ``MXNET_PAGED_ATTN_IMPL=pallas`` and
``MXNET_LN_IMPL=pallas`` (the Pallas kernels in interpret mode), the
port's ops on CPU tensors (the kernels' plain versions).  Tolerances are
the JAX suite's f32 bound (rtol 2e-5, atol 1e-6) unless a case says why
it needs more.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.ndarray.ndarray import NDArray as JNDArray
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops.registry import get_op as jget_op

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.ops import nn
from mxnet_tpu_torch.ops.registry import get_op
from mxnet_tpu_torch.weights import param_shapes

RTOL, ATOL = 2e-5, 1e-6
CFG = dict(num_classes=50, num_layers=2, d_model=16, num_heads=2, seq_len=48)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The tensors here are tiny and gain nothing from many intra-op
    threads; two keep this file off the cores that timing-sensitive
    tests running beside it in other workers measure."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("MXNET_PAGED_ATTN_IMPL", "pallas")
    monkeypatch.setenv("MXNET_LN_IMPL", "pallas")


def _rand(rng, *shape):
    return (rng.randn(*shape) * 0.5).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(rng, d):
    return [_rand(rng, 3 * d, d), _rand(rng, 3 * d), _rand(rng, d, d),
            _rand(rng, d)]


def test_paged_decode_op_matches_jax(pallas):
    """Active-slot outputs and the new caches agree; the inactive slot
    (pos < 0) writes nothing (one changed row per active slot)."""
    rng = np.random.RandomState(7)
    C, d, H, nb, bs, M = 3, 16, 2, 24, 4, 6
    D = d // H
    data = _rand(rng, C, 1, d)
    w = _weights(rng, d)
    kc, vc = _rand(rng, nb, bs, H, D), _rand(rng, nb, bs, H, D)
    table = rng.permutation(nb)[:C * M].reshape(C, M).astype(np.float32)
    pos = np.array([[9.0], [21.0], [-1.0]], np.float32)
    ref = jnn.paged_decode_attention(
        *(jnp.asarray(a) for a in [data] + w + [kc, vc, table, pos]),
        num_heads=H)
    tk, tv = _t(kc), _t(vc)
    out = nn.paged_decode_attention(
        *(_t(a) for a in [data] + w), tk, tv, _t(table), _t(pos),
        num_heads=H)
    assert out[1] is tk and out[2] is tv              # in place
    active = pos.reshape(-1) >= 0
    np.testing.assert_allclose(out[0].numpy()[active],
                               np.asarray(ref[0])[active], rtol=RTOL,
                               atol=ATOL)
    for got, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
    changed = (tk.numpy() != kc).any(axis=(2, 3)).sum()
    assert changed == active.sum()


def test_paged_decode_scatter_inactive_slots_write_nothing():
    """The sync-free scatter: with no active slot the caches stay
    byte-identical, and an inactive slot whose default row collides
    with an active slot's row (block 0, offset bs-1) never clobbers
    that write."""
    rng = np.random.RandomState(8)
    C, d, H, nb, bs, M = 3, 16, 2, 8, 4, 2
    D = d // H
    data = _rand(rng, C, 1, d)
    w = [_t(a) for a in _weights(rng, d)]
    kc, vc = _rand(rng, nb, bs, H, D), _rand(rng, nb, bs, H, D)
    table = np.zeros((C, M), np.float32)
    tk, tv = _t(kc), _t(vc)
    nn.paged_decode_attention(_t(data), *w, tk, tv, _t(table),
                              _t(np.full((C, 1), -1.0, np.float32)),
                              num_heads=H)
    np.testing.assert_array_equal(tk.numpy(), kc)
    np.testing.assert_array_equal(tv.numpy(), vc)
    pos = np.array([[-1.0], [bs - 1.0], [-1.0]], np.float32)
    nn.paged_decode_attention(_t(data), *w, tk, tv, _t(table), _t(pos),
                              num_heads=H)
    k_new = (data[1, 0] @ w[0].numpy()[d:2 * d].T + w[1].numpy()[d:2 * d])
    np.testing.assert_allclose(tk.numpy()[0, bs - 1],
                               k_new.reshape(H, D), rtol=RTOL, atol=ATOL)
    changed = (tk.numpy() != kc).any(axis=(2, 3)).sum()
    assert changed == 1


def test_paged_chunk_prefill_op_matches_jax(pallas):
    """A mid-prompt chunk (start 5, mid-block at bs 4) over a live
    cache: real-row outputs and the new caches agree."""
    rng = np.random.RandomState(19)
    B, K, d, H, nb, bs, M = 1, 8, 16, 2, 16, 4, 6
    D = d // H
    data = _rand(rng, B, K, d)
    w = _weights(rng, d)
    kc, vc = _rand(rng, nb, bs, H, D), _rand(rng, nb, bs, H, D)
    table = rng.permutation(nb)[:B * M].reshape(B, M).astype(np.float32)
    start = np.asarray([5.0], np.float32)
    lengths = np.asarray([6.0], np.float32)
    ref = jnn.paged_chunk_prefill_attention(
        *(jnp.asarray(a) for a in [data] + w + [kc, vc, table, start,
                                                lengths]), num_heads=H)
    out = nn.paged_chunk_prefill_attention(
        *(_t(a) for a in [data] + w + [kc, vc, table, start, lengths]),
        num_heads=H)
    np.testing.assert_allclose(out[0].numpy()[:, :6],
                               np.asarray(ref[0])[:, :6], rtol=RTOL,
                               atol=ATOL)
    for got, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


def test_layernorm_op_matches_jax(pallas):
    rng = np.random.RandomState(9)
    x = _rand(rng, 3, 1, 16) * 3
    g, b = _rand(rng, 16), _rand(rng, 16)
    ref = jnn.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = nn.layer_norm(_t(x), _t(g), _t(b))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


_DENSE_CASES = {
    "FullyConnected": (lambda r: [_rand(r, 4, 3, 5), _rand(r, 7, 5),
                                  _rand(r, 7)],
                       dict(num_hidden=7, flatten=False)),
    "FullyConnected_flat": (lambda r: [_rand(r, 4, 3, 5), _rand(r, 7, 15),
                                       _rand(r, 7)],
                            dict(num_hidden=7)),
    "LeakyReLU": (lambda r: [_rand(r, 4, 9) * 4],
                  dict(act_type="gelu_tanh")),
    "Embedding": (lambda r: [np.array([[0, 3, 9, 12]], np.float32),
                             _rand(r, 10, 6)],
                  dict(input_dim=10, output_dim=6)),
    "take": (lambda r: [_rand(r, 12, 5),
                        np.array([[3.0], [-1.0], [15.0]], np.float32)],
             dict()),
    "argmax": (lambda r: [_rand(r, 5, 11)], dict(axis=1)),
    "Reshape": (lambda r: [_rand(r, 4, 1, 6)], dict(shape=(-1, 6))),
    "_contrib_GatherTimestep": (lambda r: [_rand(r, 2, 5, 3),
                                           np.array([4.0, -1.0],
                                                    np.float32)], dict()),
    "broadcast_add": (lambda r: [_rand(r, 3, 1, 4), _rand(r, 1, 2, 4)],
                      dict()),
    "_minus_scalar": (lambda r: [_rand(r, 3)], dict(scalar=1.0)),
}


@pytest.mark.parametrize("case", sorted(_DENSE_CASES))
def test_dense_op_matches_jax(case):
    """The plain ops of the mixed step, op by op, against the JAX
    package's registered functions."""
    make, attrs = _DENSE_CASES[case]
    name = case.replace("_flat", "")
    ins = make(np.random.RandomState(5))
    ref = jget_op(name).fn(*(jnp.asarray(a) for a in ins), **attrs)
    got = get_op(name).fn(*(_t(a) for a in ins), **attrs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


# ----------------------------------------------------------------------
# the whole mixed step
# ----------------------------------------------------------------------
def _mixed_feeds(rng, C, K, M, nb):
    """Two decoding slots, one inactive, and a mid-prompt chunk whose
    blocks are disjoint from the decoding slots' (as the engine keeps
    them)."""
    blocks = rng.permutation(nb)
    table = np.zeros((C, M), np.float32)
    table[0, :3] = blocks[:3]
    table[1, :2] = blocks[3:5]
    ctable = np.zeros((1, M), np.float32)
    ctable[0, :4] = blocks[5:9]
    return dict(
        data=rng.randint(0, 50, (C, 1)).astype(np.float32),
        positions=np.array([[9.0], [5.0], [-1.0]], np.float32),
        block_table=table,
        chunk_data=rng.randint(0, 50, (1, K)).astype(np.float32),
        chunk_positions=np.arange(6, 6 + K, dtype=np.float32)[None],
        chunk_start=np.array([6.0], np.float32),
        chunk_len=np.array([7.0], np.float32),
        chunk_table=ctable)


def test_mixed_step_matches_jax(pallas):
    """Bind get_mixed_step_symbol in both packages from the same numpy
    params and caches, feed the same inputs, and compare every output:
    logits and caches at the f32 bound, greedy tokens equal."""
    rng = np.random.RandomState(13)
    C, K, bs, nb = 3, 8, 4, 16
    M = -(-CFG["seq_len"] // bs)
    params = {n: (rng.randn(*s) * 0.1).astype(np.float32)
              for n, s in param_shapes(CFG).items()}
    D = CFG["d_model"] // CFG["num_heads"]
    caches = {"layer%d_%s_cache" % (i, kv): _rand(rng, nb, bs, 2, D)
              for i in range(CFG["num_layers"]) for kv in "kv"}
    feeds = _mixed_feeds(rng, C, K, M, nb)
    shapes = {k: v.shape for k, v in feeds.items()}

    jsym = jtransformer.get_mixed_step_symbol(block_size=bs, num_blocks=nb,
                                              **CFG)
    jexe = jsym.simple_bind(ctx=jmx.cpu(), grad_req="null", **shapes)
    jexe.copy_params_from({k: JNDArray(v) for k, v in
                           {**params, **caches}.items()}, {},
                          allow_extra_params=True)
    ref = [o.asnumpy() for o in jexe.forward(is_train=False, **feeds)]

    msym = transformer.get_mixed_step_symbol(block_size=bs, num_blocks=nb,
                                             **CFG)
    assert sorted(msym.list_arguments()) == sorted(jsym.list_arguments())
    exe = msym.simple_bind(ctx=mx.cpu(), grad_req="null", **shapes)
    exe.copy_params_from({**params, **caches})
    got = [o.asnumpy() for o in exe.forward(is_train=False, **feeds)]

    assert len(got) == len(ref) == 4 + 2 * CFG["num_layers"]
    active = feeds["positions"].reshape(-1) >= 0
    np.testing.assert_allclose(got[0][active], ref[0][active], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got[1][active], ref[1][active])
    np.testing.assert_allclose(got[2], ref[2], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[3], ref[3])
    for g, r in zip(got[4:], ref[4:]):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# the training slice's ops, values and gradients
# ----------------------------------------------------------------------
def _jax_vjp(fn, ins, ct):
    import jax
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in ins))
    return out, vjp(jnp.asarray(ct))


def _port_vjp(fn, ins, ct, n_diff=None):
    ts = [_t(a).requires_grad_() for a in ins[:n_diff]] + \
        [_t(a) for a in ins[len(ins[:n_diff]):]]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts[:n_diff], _t(ct))


@pytest.mark.parametrize("normalization,use_ignore",
                         [("null", False), ("batch", False),
                          ("valid", False), ("valid", True),
                          ("batch", True)])
def test_softmax_output_matches_jax(normalization, use_ignore):
    """Forward probabilities and the data gradient (the fused softmax +
    cross-entropy gradient, which ignores the incoming one) against the
    JAX op; the labels include the ignore label -1 twice."""
    rng = np.random.RandomState(17)
    data = _rand(rng, 9, 7) * 3
    label = rng.randint(0, 7, 9).astype(np.float32)
    label[[2, 5]] = -1.0
    ct = _rand(rng, 9, 7)                     # ignored by both
    attrs = dict(normalization=normalization, use_ignore=use_ignore,
                 grad_scale=1.5)
    ref, (rd, _) = _jax_vjp(
        lambda d, l: jnn.softmax_output(d, l, **attrs), [data, label], ct)
    got, (gd,) = _port_vjp(
        lambda d, l: nn.softmax_output(d, l, **attrs), [data, label], ct,
        n_diff=1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=RTOL,
                               atol=ATOL)


def test_fused_causal_self_attention_op_matches_jax():
    """The attention sublayer (qkv projection, causal attention through
    the flash wrappers' plain versions, output projection): output and
    the gradients of data and all four weights against jax.vjp of the
    JAX op (its XLA path on the CPU).  The weight gradients are sums
    over the B * S = 22 rows in another order, so their absolute bound
    is 4e-6 (a few f32 ulps of the O(1) terms); values and the data
    gradient hold the f32 bound."""
    rng = np.random.RandomState(23)
    B, S, d, H = 2, 11, 16, 4
    ins = [_rand(rng, B, S, d)] + _weights(rng, d)
    ct = _rand(rng, B, S, d)
    ref, rgrads = _jax_vjp(
        lambda *a: jnn.fused_causal_self_attention(*a, num_heads=H), ins, ct)
    got, grads = _port_vjp(
        lambda *a: nn.fused_causal_self_attention(*a, num_heads=H), ins, ct)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(rgrads[0]),
                               rtol=RTOL, atol=ATOL)
    for a, r in zip(grads[1:], rgrads[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=4e-6)


def test_fused_causal_self_attention_rejects_head_axis():
    rng = np.random.RandomState(1)
    ins = [_t(_rand(rng, 1, 4, 8))] + [_t(a) for a in _weights(rng, 8)]
    with pytest.raises(mx.MXNetError, match="multi-GPU"):
        nn.fused_causal_self_attention(*ins, num_heads=2, head_axis="mp")


def test_layernorm_op_gradients_match_jax(pallas):
    """The LayerNorm op's data, gamma and beta gradients against the
    JAX op routed through its Pallas kernel pair (interpret mode)."""
    rng = np.random.RandomState(29)
    ins = [_rand(rng, 2, 5, 24) * 3, _rand(rng, 24), _rand(rng, 24)]
    ct = _rand(rng, 2, 5, 24)
    ref, rgrads = _jax_vjp(lambda *a: jnn.layer_norm(*a)[0], ins, ct)
    got, grads = _port_vjp(lambda *a: nn.layer_norm(*a)[0], ins, ct)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    for a, r in zip(grads, rgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
