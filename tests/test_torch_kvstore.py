"""PyTorch port: the 2-bit quantizer, the kvstore and its bucketed path
against the JAX package.

Every comparison feeds the same numpy inputs to both packages on the
CPU.  The JAX side runs its Pallas quantizer in interpret mode
(``MXNET_Q2BIT_IMPL=pallas``); the port's quantizer takes its plain
version on CPU tensors.  The compressor path (quantize, error feedback,
in-order stream sums) uses adds and exact-constant selects only, so it
is held bit for bit (``atol = 0``); an SGD update is held at the JAX
suite's ``_ULP_RTOL`` (rtol 5e-7 / atol 5e-7: FMA contraction in the
update is the only source of difference).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.pallas import two_bit_quantize_fused as jax_quantize

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import (LAUNCHES, PLAIN_CALLS, reset_counts,
                                     two_bit_quantize_fused,
                                     two_bit_quantize_plain)

SHAPES = [(64, 32), (128,), (3, 3, 8, 8), (500, 10), (7,), (40, 60)]
CAP = 8192            # bytes: (40, 60) is above it and gets its own bucket
_ULP_RTOL = 5e-7
_ULP_ATOL = 5e-7


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MXNET_Q2BIT_IMPL", "pallas")
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", str(CAP))


def _bits(a):
    """Float32 values as int32 bit patterns (NaN and -0.0 compare)."""
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _edge_values(t):
    t32 = np.float32(t)
    up = np.nextafter(t32, np.float32(np.inf))
    dn = np.nextafter(t32, np.float32(0))
    return np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, t32, -t32, up, -up,
                     dn, -dn], np.float32)


# ----------------------------------------------------------------------
# the quantizer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("t", [0.5, 0.1])
@pytest.mark.parametrize("n", [1, 7, 8193, 300001])
def test_quantizer_matches_pallas_bit_for_bit(n, t):
    """Random residuals and gradients around the threshold: q and the
    new residual equal the JAX Pallas kernel's bit for bit."""
    rng = np.random.RandomState(n)
    r = (rng.randn(n) * t).astype(np.float32)
    g = (rng.randn(n) * t).astype(np.float32)
    ref = jax_quantize(jnp.asarray(r), jnp.asarray(g), t)
    reset_counts()
    got = two_bit_quantize_fused(torch.from_numpy(r), torch.from_numpy(g), t)
    assert PLAIN_CALLS["two_bit_quantize_fused"] == 1
    assert LAUNCHES["two_bit_quantize_fused"] == 0
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


@pytest.mark.parametrize("t", [0.5, 0.1])
def test_quantizer_edge_values_bit_for_bit(t):
    """NaN (q 0, NaN residual), +-inf (q +-t, +-inf residual), -0.0
    (kept), and sums exactly at +-t and one ulp either side, as residual,
    as gradient and as both; the threshold is rounded to f32 first (0.1
    as a double would flip the elements exactly at 0.1f)."""
    v = _edge_values(t)
    z = np.zeros_like(v)
    for r, g in ((z, v), (v, z), (v, v)):
        ref = jax_quantize(jnp.asarray(r), jnp.asarray(g), t)
        got = two_bit_quantize_plain(torch.from_numpy(r),
                                     torch.from_numpy(g), t)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    q, _ = two_bit_quantize_plain(torch.from_numpy(z), torch.from_numpy(v),
                                  t)
    t32 = np.float32(t)
    np.testing.assert_array_equal(
        q.numpy(), [0, t32, -t32, 0, 0, 0, 0, t32, -t32, 0, 0])
    _, nr = two_bit_quantize_plain(torch.from_numpy(v), torch.from_numpy(v),
                                   t)
    nr = nr.numpy()
    assert np.isnan(nr[0]) and nr[3] == 0 and np.signbit(nr[3])


def test_quantizer_empty_and_unaligned_views():
    """Length 0 gives empty outputs (the JAX kernel cannot take it); a
    view at a 4-byte offset gives the bits of the contiguous copy."""
    e = torch.zeros(0)
    q, r = two_bit_quantize_fused(e, e, 0.5)
    assert q.shape == r.shape == (0,)
    rng = np.random.RandomState(2)
    base = torch.from_numpy(rng.randn(2, 1001).astype(np.float32))
    got = two_bit_quantize_fused(base[0, 1:], base[1, 1:], 0.5)
    ref = two_bit_quantize_fused(base[0, 1:].clone(), base[1, 1:].clone(),
                                 0.5)
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ----------------------------------------------------------------------
# the store, against the JAX package's
# ----------------------------------------------------------------------
def _keys():
    return ["p%d" % i for i in range(len(SHAPES))]


def _make_kv(pkg, bucketed, compress=None, optimizer=True):
    kv = pkg.kv.create("device")
    kv.set_bucketing(bucketed)
    if compress is not None:
        kv.set_gradient_compression({"type": "2bit", "threshold": compress})
    if optimizer:
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.05, momentum=0.9,
                                           wd=1e-4, rescale_grad=0.5))
    return kv


def _arr(pkg, a):
    return pkg.nd.array(a) if pkg is jmx else mx.nd.array(a, ctx=mx.cpu())


def _run_steps(pkg, kv, n_steps=4, n_dev=3, seed=1):
    """4 steps of 3 device streams per key, one batched push each, then
    one pull: the pulled values and the store's residuals (per key and
    stream, numpy)."""
    rng = np.random.RandomState(0)
    for k, s in zip(_keys(), SHAPES):
        kv.init(k, _arr(pkg, rng.normal(0, 1, s).astype(np.float32)))
    r = np.random.RandomState(seed)
    for _ in range(n_steps):
        grads = [[_arr(pkg, r.normal(0, 0.3, s).astype(np.float32))
                  for _ in range(n_dev)] for s in SHAPES]
        kv.push(_keys(), grads, priority=[-i for i in range(len(SHAPES))])
    outs = [_arr(pkg, np.zeros(s, np.float32)) for s in SHAPES]
    kv.pull(_keys(), out=outs)
    return [o.asnumpy() for o in outs], _residuals(kv)


def _residuals(kv):
    """{(key, stream): numpy residual}, flat buckets spilled first."""
    if kv._engine is not None:
        kv._engine.spill_residuals()
    return {k: v.asnumpy() for k, v in kv._compression_residuals.items()}


@pytest.mark.parametrize("compress", [None, 0.1])
def test_no_updater_matches_jax_bit_for_bit(compress):
    """Assign mode: the pulled values (the quantized, reduced gradients)
    and every residual equal the JAX device store's, bucketed and eager,
    atol 0."""
    ref, ref_res = _run_steps(jmx, _make_kv(jmx, True, compress, False))
    for bucketed in (True, False):
        got, res = _run_steps(mx, _make_kv(mx, bucketed, compress, False))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        assert sorted(res) == sorted(ref_res)
        for k in ref_res:
            np.testing.assert_array_equal(_bits(res[k]), _bits(ref_res[k]))


@pytest.mark.parametrize("compress", [None, 0.1])
def test_sgd_matches_jax(compress):
    """SGD (momentum 0.9, wd 1e-4, rescale 0.5) through the store: the
    port's bucketed and eager paths give the same bits, and agree with
    the JAX package within _ULP_RTOL; the residuals are bit-identical."""
    ref, ref_res = _run_steps(jmx, _make_kv(jmx, True, compress))
    got, res = _run_steps(mx, _make_kv(mx, True, compress))
    eager, eager_res = _run_steps(mx, _make_kv(mx, False, compress))
    for a, b, c in zip(got, eager, ref):
        np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_allclose(a, c, rtol=_ULP_RTOL, atol=_ULP_ATOL)
    for k in ref_res:
        np.testing.assert_array_equal(_bits(res[k]), _bits(ref_res[k]))
        np.testing.assert_array_equal(_bits(eager_res[k]),
                                      _bits(ref_res[k]))


def test_bucket_plan_and_launches():
    """The streaming flush plans one step's buckets as the JAX engine
    does: a bucket goes out as soon as a cap's worth is pending, packed
    greedily in priority order, and the key above the cap rides alone;
    one quantize call per bucket and stream; the plan, and so the flat
    residuals, stay the same from step to step."""
    kv = _make_kv(mx, True, 0.1)
    jkv = _make_kv(jmx, True, 0.1)
    keys = _keys()
    rng = np.random.RandomState(3)
    for k, s in zip(keys, SHAPES):
        kv.init(k, mx.nd.zeros(s, ctx=mx.cpu()))
        jkv.init(k, jmx.nd.zeros(s))
    reset_counts()
    want = [("p0",), ("p1", "p2"), ("p3",), ("p4",), ("p5",)]
    for step in range(2):
        grads = [[rng.randn(*s).astype(np.float32) for _ in range(3)]
                 for s in SHAPES]
        for pkg, store in ((mx, kv), (jmx, jkv)):
            store.push(keys, [[_arr(pkg, g) for g in gs] for gs in grads],
                       priority=[-i for i in range(len(keys))])
        assert sorted(kv._engine._flat_res) == sorted(jkv._engine._flat_res) \
            == want
        assert kv._engine.last_flush_buckets == \
            jkv._engine.last_flush_buckets
    assert kv._engine.stats["buckets"] == 2 * len(want)
    assert PLAIN_CALLS["two_bit_quantize_fused"] == 3 * 2 * len(want)


def test_residual_survives_bucket_composition_change():
    """Error feedback accumulated in one bucket's flat residual survives
    the keyset changing between steps (spill and reseed), as in the JAX
    package."""
    outs = []
    for pkg in (jmx, mx):
        kv = pkg.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 2.0})
        for k in ("a", "b"):
            kv.init(k, _arr(pkg, np.zeros((4, 4), np.float32)))
        ones = np.ones((4, 4), np.float32)
        kv.push(["a", "b"], [[_arr(pkg, ones * 1.5)]] * 2, priority=[0, 0])
        got = []
        for k in ("a", "b"):
            kv.push(k, _arr(pkg, ones))           # acc 2.5 -> q +2
            out = _arr(pkg, np.zeros((4, 4), np.float32))
            kv.pull(k, out=out)
            got.append(out.asnumpy())
        outs.append(got)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, 2.0)


def test_priority_orders_bucket_dispatch(monkeypatch):
    """Async pushes wait; the sync point packs and dispatches buckets in
    descending priority."""
    kv = _make_kv(mx, True)
    kv.set_async_push(True)
    for k in ("lo", "hi", "mid"):
        kv.init(k, mx.nd.zeros((4, 4), ctx=mx.cpu()))
    kv.push(["lo", "hi", "mid"], [[mx.nd.array(np.ones((4, 4)),
                                                ctx=mx.cpu())]] * 3,
            priority=[-10, 5, 0])
    assert kv._engine.has_pending
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "1")
    kv.pull("hi", out=mx.nd.zeros((4, 4), ctx=mx.cpu()))
    assert kv._engine.last_flush_buckets == [["hi"], ["mid"], ["lo"]]


@pytest.mark.parametrize("cap,want,buckets", [
    ("1024", [["a", "b"], ["c"]], 2), ("256", [["c"]], 3)])
def test_byte_cap_env(monkeypatch, cap, want, buckets):
    """MXNET_KVSTORE_BIGARRAY_BOUND caps bucket bytes (the JAX package's
    knob): two 256-byte keys share a 1 KiB bucket and a 4000-byte key
    gets its own; at 256 bytes each key fills a bucket and goes out as
    it is pushed."""
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", cap)
    kv = _make_kv(mx, True)
    shapes = [(8, 8), (8, 8), (1000,)]
    for k, s in zip("abc", shapes):
        kv.init(k, mx.nd.zeros(s, ctx=mx.cpu()))
    kv.push(list("abc"), [[mx.nd.array(np.ones(s), ctx=mx.cpu())]
                          for s in shapes], priority=[0, 0, 0])
    assert kv._engine.last_flush_buckets == want
    assert kv._engine.stats["buckets"] == buckets


def test_streaming_flush_and_async_snapshot(monkeypatch):
    """A full bucket goes out mid-push and the partial tail waits for
    the sync point; an async push applies the gradient as it was at the
    push, not a later in-place write."""
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "256")
    kv = _make_kv(mx, True, optimizer=False)
    kv.set_async_push(True)
    keys = ["k%d" % i for i in range(5)]
    for k in keys:
        kv.init(k, mx.nd.zeros((4, 4), ctx=mx.cpu()))
    grads = [[mx.nd.array(np.ones((4, 4)), ctx=mx.cpu())] for _ in keys]
    kv.push(keys, grads, priority=[0] * 5)
    assert kv._engine.last_flush_buckets == [keys[:4]]
    assert kv._engine.has_pending
    grads[4][0][:] = 7.0                       # written after the push
    out = mx.nd.zeros((4, 4), ctx=mx.cpu())
    kv.pull("k4", out=out)
    np.testing.assert_array_equal(out.asnumpy(), 1.0)
    assert not kv._engine.has_pending


def test_custom_updater_takes_the_eager_path():
    kv = mx.kv.create("local")
    kv.set_updater(lambda key, recv, stored: stored._data.add_(recv._data))
    kv.init("w", mx.nd.zeros((4, 4), ctx=mx.cpu()))
    kv.push("w", mx.nd.array(np.ones((4, 4)), ctx=mx.cpu()))
    out = mx.nd.zeros((4, 4), ctx=mx.cpu())
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out.asnumpy(), 1.0)
    assert kv._engine.stats["flushes"] == 0


def test_pull_copies_into_the_bound_tensor():
    """A pull writes the stored value into the destination's own tensor
    (a bound parameter keeps its leaf tensor and never aliases the
    store's weight, which the optimizer updates in place)."""
    kv = _make_kv(mx, True)
    kv.init("w", mx.nd.array(np.full((3,), 2.0), ctx=mx.cpu()))
    leaf = torch.zeros(3, requires_grad=True)
    dst = mx.nd.NDArray(leaf)
    kv.pull("w", out=dst)
    assert dst._data is leaf and leaf.requires_grad
    np.testing.assert_array_equal(leaf.detach().numpy(), 2.0)
    assert kv._store["w"]._data.data_ptr() != leaf.data_ptr()


def test_create_and_compression_rejections():
    for name in ("local", "device", "local_allreduce_device"):
        assert mx.kv.create(name).type == name
    for name in ("dist_sync", "dist_async", "tpu", "nccl"):
        with pytest.raises(mx.MXNetError, match="multi-GPU"):
            mx.kv.create(name)
    with pytest.raises(mx.MXNetError, match="unsupported compression"):
        mx.kv.create("device").set_gradient_compression({"type": "1bit"})
    assert mx.parallel.TwoBitCompressor(0.5) == \
        mx.parallel.TwoBitCompressor(0.5) != mx.parallel.TwoBitCompressor(1)
