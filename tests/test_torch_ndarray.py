"""PyTorch port: the imperative NDArray surface and the ``mx.nd`` ops
against the JAX package's ``mx.nd`` on the CPU.

The same numpy inputs go to both packages; results are compared at the
f32 bound of the JAX suite (rtol 2e-5 / atol 1e-6) unless a case says
otherwise, integer results exactly.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

RTOL, ATOL = 2e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _r(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _both(a):
    """(port NDArray on the CPU, JAX NDArray) of numpy ``a``."""
    return mx.nd.array(a, ctx=mx.cpu()), jmx.nd.array(a)


def _same(got, ref, exact=False):
    got, ref = got.asnumpy(), np.asarray(ref.asnumpy())
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# operators
# ----------------------------------------------------------------------
_BINARY = [lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
           lambda a, b: a / b, lambda a, b: a % b, lambda a, b: a ** b,
           lambda a, b: a == b, lambda a, b: a != b, lambda a, b: a > b,
           lambda a, b: a >= b, lambda a, b: a < b, lambda a, b: a <= b]


@pytest.mark.parametrize("shapes", [((2, 3), (2, 3)), ((2, 3), (3,)),
                                    ((2, 1, 3), (4, 1))])
@pytest.mark.parametrize("op", range(len(_BINARY)))
def test_binary_operators_broadcast_like_jax(op, shapes):
    rng = np.random.RandomState(op)
    a = np.abs(_r(rng, *shapes[0])) + 0.5
    b = np.abs(_r(rng, *shapes[1])) + 0.5
    (pa, ja), (pb, jb) = _both(a), _both(b)
    fn = _BINARY[op]
    _same(fn(pa, pb), fn(ja, jb))


@pytest.mark.parametrize("op", range(len(_BINARY)))
def test_scalar_operators_both_sides_like_jax(op):
    a = np.abs(_r(np.random.RandomState(op), 3, 4)) + 0.5
    pa, ja = _both(a)
    fn = _BINARY[op]
    _same(fn(pa, 1.5), fn(ja, 1.5))
    _same(fn(2.0, pa), fn(2.0, ja))
    _same(-pa, -ja)


def test_integer_arithmetic_keeps_type_like_jax():
    """Integer division truncates, a float scalar takes the integer
    type, mod follows the divisor's sign (exact)."""
    a = np.array([[7, -7, 9], [-9, 5, 4]], np.int32)
    b = np.array([2, 3, -4], np.int32)
    (pa, ja), (pb, jb) = _both(a), _both(b)
    for got, ref in ((pa / pb, ja / jb), (pa % pb, ja % jb),
                     (pa + 2.7, ja + 2.7), (pa * 3, ja * 3),
                     (pa > 2, ja > 2)):
        assert str(got.dtype).replace("torch.", "") == str(ref.dtype)
        _same(got, ref, exact=True)


# ----------------------------------------------------------------------
# mx.nd ops
# ----------------------------------------------------------------------
_UNARY = ["abs", "sign", "negative", "square", "sqrt", "rsqrt", "exp",
          "log", "log1p", "expm1", "sin", "cos", "tanh", "sigmoid", "relu",
          "softsign", "floor", "ceil", "round", "trunc", "reciprocal",
          "erf", "gammaln", "isnan", "isfinite"]


@pytest.mark.parametrize("name", _UNARY)
def test_unary_ops_match_jax(name):
    rng = np.random.RandomState(len(name))
    a = _r(rng, 3, 5) * 2
    if name in ("sqrt", "rsqrt", "log", "reciprocal", "gammaln"):
        a = np.abs(a) + 0.3
    pa, ja = _both(a)
    _same(getattr(mx.nd, name)(pa), getattr(jmx.nd, name)(ja))


@pytest.mark.parametrize("name", ["sum", "mean", "max", "min", "prod",
                                  "nansum"])
@pytest.mark.parametrize("kw", [{}, {"axis": 1}, {"axis": (0, 2),
                                                  "keepdims": True},
                                {"axis": 1, "exclude": True}])
def test_reductions_match_jax(name, kw):
    a = _r(np.random.RandomState(3), 2, 3, 4) * 0.5 + 1
    pa, ja = _both(a)
    _same(getattr(mx.nd, name)(pa, **kw), getattr(jmx.nd, name)(ja, **kw))


# (op name, numpy inputs, attributes)
def _op_cases():
    rng = np.random.RandomState(11)
    x = _r(rng, 3, 4, 5)
    img = _r(rng, 2, 3, 5, 6)
    idx = np.array([1, 0, 3], np.float32)
    return [
        ("log_softmax", [x], {"axis": -1}),
        ("log_softmax", [x], {"axis": 1}),
        ("softmax", [x], {"axis": 2}),
        ("pick", [x[:, :, 0], idx], {"axis": -1, "keepdims": True}),
        ("pick", [x[:, :, 0], idx], {"axis": 1}),
        ("where", [(x > 0).astype(np.float32), x, -x], {}),
        ("swapaxes", [x], {"dim1": 0, "dim2": 2}),
        ("transpose", [x], {"axes": (1, 2, 0)}),
        ("transpose", [x], {}),
        ("expand_dims", [x], {"axis": 1}),
        ("squeeze", [x[:, :1]], {"axis": 1}),
        ("Pad", [img], {"mode": "constant", "constant_value": 0.5,
                        "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
        ("Pad", [img], {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 2,
                                                      2, 1)}),
        ("Pad", [img], {"mode": "reflect", "pad_width": (0, 0, 0, 0, 2, 1,
                                                         1, 2)}),
        ("InstanceNorm", [img, _r(rng, 3), _r(rng, 3)], {"eps": 1e-5}),
        ("one_hot", [np.array([0, 2, 5, -1], np.float32)], {"depth": 4}),
        ("tile", [x[0]], {"reps": (2, 1, 3)}),
        ("repeat", [x[0]], {"repeats": 2, "axis": 1}),
        ("reverse", [x], {"axis": 1}),
        ("broadcast_to", [x[:, :1]], {"shape": (3, 4, 5)}),
        ("clip", [x], {"a_min": -0.5, "a_max": 0.7}),
        ("dot", [x[0], x[1].T], {}),
        ("dot", [x[0], x[1]], {"transpose_a": True}),
        ("batch_dot", [x, x], {"transpose_b": True}),
        ("slice", [x], {"begin": (0, 1, None), "end": (2, 4, None)}),
        ("slice_axis", [x], {"axis": 2, "begin": 1, "end": 4}),
        ("take", [x, idx], {"axis": 1}),
        ("argmax", [x], {"axis": 1}),
        ("argmin", [x], {"axis": 2, "keepdims": True}),
        ("Reshape", [x], {"shape": (0, -1)}),
        ("reshape_like", [x, x.reshape(4, 15)], {}),
        ("smooth_l1", [x], {"scalar": 2.0}),
        ("norm", [x], {"axis": 1}),
        ("broadcast_maximum", [x, x[:1]], {}),
        ("stack", [x, x * 2], {"axis": 1}),
        ("Concat", [x, x * 2], {"dim": 2}),
        ("add_n", [x, x * 2, x * 3], {}),
    ]


@pytest.mark.parametrize("case", range(len(_op_cases())))
def test_nd_ops_match_jax(case):
    name, ins, attrs = _op_cases()[case]
    pins, jins = zip(*[_both(a) for a in ins])
    _same(getattr(mx.nd, name)(*pins, **attrs),
          getattr(jmx.nd, name)(*jins, **attrs))


def test_nd_namespace_covers_the_registry():
    for name in mx.ops.list_ops():
        assert callable(getattr(mx.nd, name))
    assert mx.nd.contrib.PagedDecodeAttention is mx.nd._contrib_PagedDecodeAttention


def test_random_ops_seeded_and_distributed():
    """Draws come from the port's per-device generator: the same seed
    repeats them; shapes, types and moments are the reference's."""
    with mx.cpu():
        mx.random.seed(5)
        u = mx.nd.random.uniform(-1, 3, shape=(20000,))
        n = mx.nd.random.normal(2.0, 0.5, shape=(200, 100))
        k = mx.nd.random.randint(3, 9, shape=(5000,))
        mx.random.seed(5)
        u2 = mx.nd.random.uniform(-1, 3, shape=(20000,))
    np.testing.assert_array_equal(u.asnumpy(), u2.asnumpy())
    assert u.dtype == torch.float32 and k.dtype == torch.int32
    assert n.shape == (200, 100)
    assert -1 <= u.asnumpy().min() and u.asnumpy().max() < 3
    assert abs(u.asnumpy().mean() - 1.0) < 0.05
    assert abs(n.asnumpy().mean() - 2.0) < 0.02
    assert abs(n.asnumpy().std() - 0.5) < 0.02
    assert set(np.unique(k.asnumpy())) == set(range(3, 9))


# ----------------------------------------------------------------------
# indexing, assignment, conversions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("key", [1, -1, slice(1, 3), (slice(None), 2),
                                 (0, slice(1, None, 2)), [2, 0],
                                 (slice(None), [1, 3]), "nd"])
def test_getitem_matches_jax(key):
    a = _r(np.random.RandomState(2), 4, 5)
    pa, ja = _both(a)
    if key == "nd":
        pk, jk = _both(np.array([3, 1, 1], np.float32))
        pk, jk = pk.astype("int32"), jk.astype("int32")
        _same(pa[pk], ja[jk])
    else:
        _same(pa[key], ja[key])


@pytest.mark.parametrize("key,value", [
    (slice(None), 2.5), (1, np.arange(5, dtype=np.float32)),
    ((slice(None), 2), np.ones(4, np.float32)),
    (slice(1, 3), np.full((1, 5), 7.0, np.float32)),
    (0, np.array([[1, 2, 3, 4, 5]], np.float32)),
    ((2, 3), 9.0)])
def test_setitem_matches_jax(key, value):
    a = _r(np.random.RandomState(4), 4, 5)
    pa, ja = _both(a)
    before = pa._data
    pa[key] = value
    ja[key] = value
    _same(pa, ja, exact=True)
    assert pa._data is before           # written in place


def test_setitem_rejects_mismatched_shapes():
    pa = mx.nd.zeros((4, 5), ctx=mx.cpu())
    with pytest.raises(mx.MXNetError):
        pa[1] = np.ones((5, 2), np.float32)


def test_conversions_and_shape_helpers():
    a = _r(np.random.RandomState(6), 2, 3, 4)
    pa, ja = _both(a)
    _same(pa.reshape((0, -1)), ja.reshape((0, -1)))
    _same(pa.reshape(4, 6), ja.reshape(4, 6))
    _same(pa.T, ja.T)
    _same(pa.flatten(), ja.flatten())
    _same(pa.sum(axis=2), ja.sum(axis=2))
    _same(pa.swapaxes(0, 1), ja.swapaxes(0, 1))
    _same(pa.expand_dims(0), ja.expand_dims(0))
    _same(pa.max(axis=1, keepdims=True), ja.max(axis=1, keepdims=True))
    _same(pa.argmax(axis=2), ja.argmax(axis=2))
    _same(pa.norm(), ja.norm())                   # the fluent form
    s = mx.nd.array(np.array([3.5], np.float32), ctx=mx.cpu())
    assert s.asscalar() == 3.5 and isinstance(s.asscalar(), np.floating)
    assert pa.astype("int32").dtype == torch.int32
    assert pa.astype("float32", copy=False) is pa
    assert pa.size == 24 and pa.ndim == 3 and len(pa) == 2
    assert pa.as_in_context(mx.cpu()) is pa
    dst = mx.nd.zeros((2, 3, 4), ctx=mx.cpu())
    pa.copyto(dst)
    _same(dst, ja)
    pa.wait_to_read()
    host = pa.asnumpy()
    host[0] = 0                                   # a copy, not a view
    assert pa.asnumpy()[0, 0, 0] == a[0, 0, 0]


def test_creation_types_follow_the_jax_package():
    """float64 -> float32 and int64 -> int32 as the JAX package's
    ``nd.array``; the other numpy types stay."""
    for src, want in ((np.arange(3, dtype=np.float64), "float32"),
                      (np.arange(3), "int32"),
                      (np.arange(3, dtype=np.uint8), "uint8"),
                      ([1.0, 2.0], "float32")):
        got = mx.nd.array(src, ctx=mx.cpu())
        assert str(got.dtype).replace("torch.", "") == want
        assert str(jmx.nd.array(src).dtype) == want
    for fn in ("zeros", "ones"):
        _same(getattr(mx.nd, fn)((2, 3), ctx=mx.cpu(), dtype="int32"),
              getattr(jmx.nd, fn)((2, 3), dtype="int32"), exact=True)
    _same(mx.nd.full((2, 2), 4.5, ctx=mx.cpu()), jmx.nd.full((2, 2), 4.5))
    _same(mx.nd.arange(2, 11, 3, ctx=mx.cpu()), jmx.nd.arange(2, 11, 3))


def test_default_context_is_the_card():
    """Without ``ctx`` an entry point takes gpu(0): on a host with no
    GPU it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert mx.nd.zeros((2,)).context == mx.gpu(0)
    else:
        with pytest.raises(mx.MXNetError, match="no CUDA device"):
            mx.nd.zeros((2,))
        with pytest.raises(mx.MXNetError, match="no CUDA device"):
            mx.nd.random.uniform(shape=(2,))


def test_mixed_contexts_raise():
    a = mx.nd.zeros((2,), ctx=mx.cpu())
    b = mx.nd.NDArray(torch.zeros(2, device="meta"))
    with pytest.raises(mx.MXNetError, match="one context"):
        mx.nd.broadcast_add(a, b)


# ----------------------------------------------------------------------
# in-place writes
# ----------------------------------------------------------------------
def test_inplace_operators_write_in_place():
    a = _r(np.random.RandomState(8), 3, 4)
    pa, ja = _both(a)
    t = pa._data
    pa += 1.5
    ja += 1.5
    pa *= pa
    ja *= ja
    pa -= 0.25
    ja -= 0.25
    pa /= 2
    ja /= 2
    _same(pa, ja)
    assert pa._data is t
    out = mx.nd.zeros((3, 4), ctx=mx.cpu())
    res = mx.nd.broadcast_add(pa, pa, out=out)
    assert res is out
    _same(out, ja + ja)
    with pytest.raises(mx.MXNetError):
        pa += mx.nd.zeros((2, 3, 4), ctx=mx.cpu())


def test_inplace_on_recorded_arrays_raises_mxnet_error():
    """The reference's rule while recording: no write into an array the
    graph holds, and no write of a recorded value; it must surface as
    MXNetError, never torch's 'modified by an inplace operation'."""
    x = mx.nd.array(np.ones((2, 3), np.float32), ctx=mx.cpu())
    x.attach_grad()
    scratch = mx.nd.zeros((2, 3), ctx=mx.cpu())
    with mx.autograd.record():
        y = x * 2
        for write in (lambda: x.__iadd__(1), lambda: y.__imul__(2),
                      lambda: x.__setitem__(0, 5.0),
                      lambda: scratch.__setitem__(slice(None), y),
                      lambda: mx.nd.broadcast_add(x, x, out=y)):
            with pytest.raises(mx.MXNetError, match="recording"):
                write()
        scratch[:] = 3.0                      # not part of the graph
        acc = mx.nd.zeros((2, 3), ctx=mx.cpu())
        acc += y                              # joins the graph
        z = (acc * x).sum()
    z.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 4 * np.ones((2, 3)))
    jx = jmx.nd.array(np.ones((2, 3), np.float32))
    jx.attach_grad()
    with jmx.autograd.record():
        with pytest.raises(jmx.MXNetError):
            jx[0] = 5.0
