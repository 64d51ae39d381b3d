"""PyTorch port: the float16 forms of row 7 (``fused_scale_relu_matmul``)
and of the ops of ResNet's float16 graphs, against the JAX package on
the CPU (ROADMAP A.1, float16 for rows 7 and 10; row 10's plain f16
form is held in tests/test_torch_fused_band4d.py).

Inputs are drawn with seeded numpy, rounded to f16 and fed to both
packages.  The JAX side runs its Pallas kernel in interpret mode
(``MXTPU_FUSED_PALLAS=interpret``; the row counts are multiples of 128
and every call asserts the kernel's launch counter rose).  Bounds:

* row 7's plain f16 form against the Pallas kernel, with and without a
  residual: within one f16 ulp at the output array's scale (the
  largest finite magnitude), and the same non-finite outputs where the
  inputs reach f16's range: activations past 65504 (inf, NaN where
  infs of both signs meet in a sum), sums past 65504 in the product
  and in the residual add, NaN and inf inputs;
* the ops in f16 (BatchNorm in training and inference, ``fix_gamma``
  both ways; Convolution NCHW and NHWC, strided and grouped; Pooling
  max, avg with and without ``count_include_pad``, global avg;
  ``_FusedBNReluConv`` forward and backward): every f16 output and
  gradient within one f16 ulp at its array's scale, f32 outputs (the
  batch statistics) at rtol 2e-5 / atol 1e-6 (measured: 0 or 1 ulp).
  The exception is the gradient of an input added by broadcast (a
  convolution's bias, the fused op's broadcasting residual), a sum of
  the cotangent over every output position: the JAX package sums it in
  f16 (measured 2-11 ulps from the exact sum at these sizes), the port
  in f32 with one rounding, so the port's is held within one ulp of the
  exact sum and the two within 16 ulps of each other (ROADMAP C's bf16
  bias-gradient difference, in f16);
* a hybridized Gluon block whose float16 graph holds an op outside
  ``executor.FLOAT16_OPS`` raises as ``simple_bind`` raises (ROADMAP
  C.1), and the same graph in f32 runs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import fused as jfused
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.pallas.dispatch import PALLAS_LAUNCHES

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import NameManager
from mxnet_tpu_torch.executor import FLOAT16_OPS
from mxnet_tpu_torch.kernels import (PLAIN_CALLS, fused_scale_relu_matmul_plain,
                                     reset_counts)
from mxnet_tpu_torch.ops.registry import get_op

F16 = np.float16
_KERNEL = "fused_scale_relu_matmul"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_PALLAS", "interpret")


def _launches():
    return PALLAS_LAUNCHES.labels(kernel=_KERNEL).value


def _ulp_at(a):
    """One f16 ulp at the array's scale: its largest finite magnitude
    (2^-24 among the subnormals)."""
    a = np.asarray(a, np.float32)
    fin = a[np.isfinite(a)]
    m = max(float(np.abs(fin).max()) if fin.size else 0.0, 2.0 ** -14)
    return 2.0 ** (np.floor(np.log2(m)) - 10)


def _hold(got, ref, what, ulps=1):
    """Within ``ulps`` f16 ulps at ``ref``'s scale where ``ref`` is
    finite; NaN where NaN and the same infs elsewhere."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
    inf = np.isinf(ref)
    np.testing.assert_array_equal(got[inf], ref[inf], err_msg=what)
    fin = np.isfinite(ref)
    assert np.isfinite(got[fin]).all(), what
    err = np.abs(got[fin] - ref[fin])
    assert err.max(initial=0.0) <= ulps * _ulp_at(ref), \
        "%s: %g f16 ulps" % (what, err.max() / _ulp_at(ref))


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _r(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# ----------------------------------------------------------------------
# row 7's plain f16 form against the Pallas kernel
# ----------------------------------------------------------------------
def _row7_inputs(rng, M, K, N, with_res, special):
    """f32 numpy (x, scale, shift, w (N, K), res); ``special`` puts the
    cases that reach f16's range into rows 3-11 (the card's
    chip_smoke._f16_special)."""
    x = _r(rng, M, K)
    s = 1 + _r(rng, K, scale=0.2)
    h = _r(rng, K, scale=0.2)
    w = _r(rng, N, K, scale=K ** -0.5)
    res = _r(rng, M, N) if with_res else None
    if special:
        s[:8] = 2.0
        w[:4] = 0.5
        x[3, :8] = 60000.0              # activations past 65504
        x[5] = 3000.0                   # sums past 65504 in columns 0-3
        x[7, 5] = np.nan
        x[9, 0] = np.inf
        if with_res:
            x[11] = 50.0
            res[11, :4] = 65504.0       # the residual add overflows
    return x, s, h, w, res


@pytest.mark.parametrize("special", [False, True], ids=["normal", "range"])
@pytest.mark.parametrize("with_res", [False, True])
def test_row7_plain_f16_matches_pallas(with_res, special):
    rng = np.random.RandomState(21 + with_res + 2 * special)
    M, K, N = 384, 72, 40
    x, s, h, w, res = _row7_inputs(rng, M, K, N, with_res, special)
    hf = jnp.float16
    before = _launches()
    ref = jfused.fused_scale_relu_matmul(
        jnp.asarray(x).astype(hf), jnp.asarray(s), jnp.asarray(h),
        jnp.asarray(w.T).astype(hf),
        None if res is None else jnp.asarray(res).astype(hf))
    assert _launches() == before + 1 and ref.dtype == hf
    reset_counts()
    t = torch.from_numpy
    got = fused_scale_relu_matmul_plain(
        t(x).half(), t(s), t(h), t(w).half(),
        None if res is None else t(res).half())
    assert PLAIN_CALLS[_KERNEL] == 1 and got.dtype == torch.float16
    _hold(_np32(got), _np32(ref), "row 7 f16")
    if special:
        ref = _np32(ref)
        assert np.isnan(ref[7]).all() and np.isinf(ref[5, :4]).all()
        assert np.isnan(ref[3]).any() or np.isinf(ref[3]).any()
        if with_res:
            assert np.isinf(ref[11, :4]).all()


# ----------------------------------------------------------------------
# the ops in f16
# ----------------------------------------------------------------------
def _sum_to(cot, shape, channel_axis):
    """The exact (f64) gradient of an input of ``shape`` added to the
    output by broadcast: ``cot`` summed over the broadcast axes (a 1-D
    bias lies along ``channel_axis``)."""
    cot = cot.astype(np.float64)
    if len(shape) == 1:
        return cot.sum(axis=tuple(a for a in range(cot.ndim)
                                  if a != channel_axis % cot.ndim))
    return cot.sum(axis=tuple(a for a, n in enumerate(shape)
                              if n == 1 and cot.shape[a] != 1),
                   keepdims=True)


def _compare_op(name, ins, attrs, is_train=True, diff=None, bias=None):
    """f16 inputs (f32 for the BatchNorm vectors) through both packages:
    every output, and the gradients of the inputs in ``diff`` (default:
    all) for a random f16 cotangent of output 0.  ``bias``: the index of
    an input added by broadcast, held as the module docstring says."""
    diff = list(range(len(ins))) if diff is None else diff
    fn = jreg.get_op(name).fn

    def f(*d):
        a = [jnp.asarray(v) for v in ins]
        for i, v in zip(diff, d):
            a[i] = v
        with jreg._OpCtxScope(is_train, jax.random.key(0)):
            return fn(*a, **attrs)

    jouts, vjp = jax.vjp(f, *[jnp.asarray(ins[i]) for i in diff])
    jouts = list(jouts) if isinstance(jouts, (tuple, list)) else [jouts]
    cot = np.random.RandomState(9).randn(*jouts[0].shape).astype(F16)
    jgrads = vjp(tuple([jnp.asarray(cot)] + [jnp.zeros_like(o)
                                             for o in jouts[1:]])
                 if len(jouts) > 1 else jnp.asarray(cot))
    op = get_op(name)
    ts = [torch.from_numpy(np.array(a)).requires_grad_(i in diff)
          for i, a in enumerate(ins)]
    kw = dict(attrs, is_train=is_train) if op.takes_is_train else attrs
    outs = op.fn(*ts, **kw)
    outs = list(outs) if isinstance(outs, tuple) else [outs]
    grads = torch.autograd.grad(outs[0], [ts[i] for i in diff],
                                torch.from_numpy(cot), allow_unused=True)
    assert outs[0].dtype == torch.float16
    for i, (got, ref) in enumerate(zip(outs, jouts)):
        assert str(got.dtype).replace("torch.", "") == str(ref.dtype), i
        what = "%s output %d" % (name, i)
        if got.dtype == torch.float32:
            np.testing.assert_allclose(_np32(got), _np32(ref), rtol=2e-5,
                                       atol=1e-6, err_msg=what)
        else:
            _hold(_np32(got), _np32(ref), what)
    for i, got, ref in zip(diff, grads, jgrads):
        got = np.zeros(ins[i].shape, np.float32) if got is None \
            else _np32(got)
        what = "%s grad %d" % (name, i)
        if i == bias:
            exact = _sum_to(cot, ins[i].shape,
                            -1 if attrs.get("layout") else 1)
            _hold(got, exact.astype(F16), what + " (exact sum)")
            _hold(got, _np32(ref), what, ulps=16)
        else:
            _hold(got, _np32(ref), what)


@pytest.mark.parametrize("case", ["nchw_stem", "nchw_grouped_strided_bias",
                                  "nhwc_grouped_bias", "nhwc_1x1_strided",
                                  "nhwc_3x3"])
def test_convolution_f16_matches_jax(case):
    rng = np.random.RandomState(5)
    r = lambda *s, scale=1.0: _r(rng, *s, scale=scale).astype(F16)
    bias = None
    if case == "nchw_stem":
        ins = [r(2, 3, 20, 20), r(8, 3, 7, 7, scale=0.1)]
        attrs = dict(kernel=(7, 7), num_filter=8, stride=(2, 2), pad=(3, 3),
                     no_bias=True)
    elif case == "nchw_grouped_strided_bias":
        ins, bias = [r(2, 4, 11, 9), r(6, 2, 3, 3, scale=0.2), r(6)], 2
        attrs = dict(kernel=(3, 3), num_filter=6, num_group=2,
                     stride=(2, 2), pad=(1, 1))
    elif case == "nhwc_grouped_bias":
        ins, bias = [r(2, 11, 9, 4), r(6, 3, 3, 2, scale=0.2), r(6)], 2
        attrs = dict(kernel=(3, 3), num_filter=6, num_group=2, pad=(1, 1),
                     layout="NHWC")
    elif case == "nhwc_1x1_strided":
        ins = [r(2, 8, 8, 5), r(7, 1, 1, 5, scale=0.3)]
        attrs = dict(kernel=(1, 1), num_filter=7, stride=(2, 2),
                     no_bias=True, layout="NHWC")
    else:
        ins = [r(2, 8, 8, 16), r(16, 3, 3, 16, scale=0.1)]
        attrs = dict(kernel=(3, 3), num_filter=16, pad=(1, 1), no_bias=True,
                     layout="NHWC")
    _compare_op("Convolution", ins, attrs, bias=bias)


@pytest.mark.parametrize("case", ["max", "max_nhwc", "max_full", "avg",
                                  "avg_excl_pad", "global_avg",
                                  "global_avg_nhwc"])
def test_pooling_f16_matches_jax(case):
    """Max pooling over ReLU outputs (ties at 0: the gradient goes to the
    first maximum in both packages), average pooling (the window sum
    and the division in f16 in the reference), the global average
    (summed in f32 in both, one rounding)."""
    rng = np.random.RandomState(7)
    relu = lambda *s: np.maximum(_r(rng, *s) - 1.0, 0).astype(F16)
    x = {"max": relu(2, 3, 9, 11), "max_nhwc": relu(2, 9, 11, 3),
         "max_full": relu(2, 3, 9, 11),
         "avg": _r(rng, 2, 3, 9, 11).astype(F16),
         "avg_excl_pad": _r(rng, 2, 3, 9, 11).astype(F16),
         "global_avg": (_r(rng, 2, 16, 7, 7) + 3).astype(F16),
         "global_avg_nhwc": (_r(rng, 2, 7, 7, 64) + 3).astype(F16)}[case]
    attrs = {
        "max": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
        "max_nhwc": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                         layout="NHWC"),
        "max_full": dict(kernel=(3, 3), stride=(2, 2),
                         pooling_convention="full"),
        "avg": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="avg"),
        "avg_excl_pad": dict(kernel=(3, 2), stride=(2, 2), pad=(1, 1),
                             pool_type="avg", count_include_pad=False),
        "global_avg": dict(kernel=(7, 7), global_pool=True, pool_type="avg"),
        "global_avg_nhwc": dict(kernel=(7, 7), global_pool=True,
                                pool_type="avg", layout="NHWC")}[case]
    _compare_op("Pooling", [x], attrs)


@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batchnorm_f16_matches_jax(layout, is_train, fix_gamma):
    """f16 data, gamma and beta and f16 moving statistics (the type both
    packages infer for them in an f16 graph): the five outputs (batch
    mean and inverse std in f32) and dx, dgamma, dbeta."""
    rng = np.random.RandomState(8)
    C = 6
    shape = (4, C, 5, 3) if layout == "NCHW" else (4, 5, 3, C)
    ins = [(_r(rng, *shape, scale=2.0) + 0.5).astype(F16),
           (1 + _r(rng, C, scale=0.2)).astype(F16),
           _r(rng, C, scale=0.2).astype(F16),
           _r(rng, C, scale=0.3).astype(F16),
           (1 + np.abs(_r(rng, C, scale=0.3))).astype(F16)]
    _compare_op("BatchNorm", ins,
                dict(eps=2e-5, momentum=0.9, fix_gamma=fix_gamma,
                     axis=1 if layout == "NCHW" else 3),
                is_train=is_train, diff=[0, 1, 2])


@pytest.mark.parametrize("is_train,fix_gamma,res", [
    (True, False, None), (True, True, None), (False, False, None),
    (True, False, (2, 8, 8, 20)), (True, False, (1, 1, 1, 20))])
def test_fused_op_f16_matches_jax(is_train, fix_gamma, res):
    """``_FusedBNReluConv`` in f16 (rows B * H * W = 128, one Pallas
    tile): the output, the new moving statistics, and the gradients of
    data, gamma, beta, the weight and the residual, against the
    reference's op and its ``_core`` VJP."""
    rng = np.random.RandomState(4)
    r = lambda *s, scale=1.0: _r(rng, *s, scale=scale).astype(F16)
    ins = [(_r(rng, 2, 8, 8, 12, scale=1.5) + 0.3).astype(F16),
           (1 + r(12, scale=0.2)), r(12, scale=0.2), r(12, scale=0.3),
           (1 + np.abs(_r(rng, 12, scale=0.3))).astype(F16),
           r(20, 1, 1, 12, scale=0.3)]
    if res:
        ins.append(r(*res))
    attrs = dict(num_filter=20, eps=2e-5, momentum=0.9, fix_gamma=fix_gamma,
                 layout="NHWC", with_residual=res is not None)
    before = _launches()
    _compare_op("_FusedBNReluConv", ins, attrs, is_train=is_train,
                diff=[i for i in (0, 1, 2, 5, 6) if i < len(ins)],
                bias=6 if res and res[0] == 1 else None)
    assert _launches() == before + 1


# ----------------------------------------------------------------------
# ROADMAP C.1: a hybridized float16 graph takes simple_bind's check
# ----------------------------------------------------------------------
class _ExpBlock(mx.gluon.HybridBlock):
    """A dense layer followed by ``exp``, an op with no float16 form held
    against the JAX package."""

    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.dense = mx.gluon.nn.Dense(4, in_units=8)

    def hybrid_forward(self, F, x):
        return F.exp(self.dense(x))


def test_hybridized_f16_graph_outside_float16_ops_raises():
    assert "exp" not in FLOAT16_OPS
    x = np.random.RandomState(3).rand(2, 8).astype(np.float32)
    for dtype in ("float32", "float16"):
        with NameManager():
            net = _ExpBlock()
        if dtype == "float16":
            net.cast("float16")
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        xs = mx.nd.array(x.astype(dtype), ctx=mx.cpu())
        eager = net(xs)                     # imperative: no graph to check
        assert str(eager.dtype).endswith(dtype)
        net.hybridize()
        if dtype == "float32":
            np.testing.assert_allclose(net(xs).asnumpy(), eager.asnumpy(),
                                       rtol=1e-6)
            continue
        with pytest.raises(mx.MXNetError, match=r"hybridized .*: a float16 "
                           r"graph with exp; .*ROADMAP A\.6"):
            net(xs)
    sym = mx.sym.exp(mx.sym.FullyConnected(mx.sym.Variable("data"),
                                           num_hidden=4, name="fc"))
    with pytest.raises(mx.MXNetError, match=r"simple_bind: a float16 graph "
                       r"with exp; .*ROADMAP A\.6"):
        sym.simple_bind(ctx=mx.cpu(), type_dict={"data": "float16"},
                        data=(2, 8))
