"""PyTorch port: Deconvolution and the ``Conv*Transpose`` layers against
the JAX package.

The op in 1-, 2- and 3-D with stride, pad, adj, dilate, groups and a
bias, forward and the data, weight and bias gradients against
``jax.vjp`` of the JAX op on the same numpy inputs: f32 at rtol 2e-5 /
atol 1e-6; bf16 and f16 element by element within one ulp of the JAX
result, or no farther from the exact value (the op in f64 on the same
16-bit inputs) than the JAX result plus one ulp (the JAX package adds
the bias after rounding the sums and sums the bias gradient in the
16-bit type on the CPU; the port rounds once, ROADMAP C).  The shape
rule against the JAX package's ``infer_shape``; the three Gluon layers
with deferred shape inference against the JAX package's layers on the
same weights; a float16 symbol binds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.base import NameManager as JNameManager
from mxnet_tpu.ops.registry import get_op as jget_op

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import NameManager, torch_dtype
from mxnet_tpu_torch.ops.nn import deconvolution

DTYPES = ("float32", "bfloat16", "float16")
CASES = {
    "1d_stride_adj_bias": dict(C=4, nf=6, sp=(7,), kernel=(3,), stride=(2,),
                               pad=(1,), adj=(1,), dilate=(1,), num_group=1,
                               no_bias=False),
    "2d_groups_bias": dict(C=4, nf=6, sp=(5, 6), kernel=(4, 3),
                           stride=(2, 3), pad=(1, 0), adj=(0, 1),
                           dilate=(1, 1), num_group=2, no_bias=False),
    "2d_dilate_no_bias": dict(C=6, nf=4, sp=(5, 5), kernel=(3, 3),
                              stride=(1, 1), pad=(2, 1), adj=(0, 0),
                              dilate=(2, 1), num_group=1, no_bias=True),
    "2d_dcgan": dict(C=8, nf=4, sp=(4, 4), kernel=(4, 4), stride=(2, 2),
                     pad=(1, 1), adj=(0, 0), dilate=(1, 1), num_group=1,
                     no_bias=True),
    "3d_groups_adj_bias": dict(C=4, nf=4, sp=(3, 4, 3), kernel=(2, 3, 2),
                               stride=(2, 1, 2), pad=(0, 1, 0),
                               adj=(1, 0, 0), dilate=(1, 1, 1), num_group=2,
                               no_bias=False),
}
_FMT = {"bfloat16": (7, -126), "float16": (10, -14)}


def _attrs(c):
    a = {k: c[k] for k in ("kernel", "stride", "pad", "adj", "dilate",
                           "num_group", "no_bias")}
    a["num_filter"] = c["nf"]
    return a


def _arrays(c, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, c["C"], *c["sp"]) * 0.5).astype(np.float32)
    w = (rng.randn(c["C"], c["nf"] // c["num_group"], *c["kernel"])
         * 0.3).astype(np.float32)
    b = rng.randn(c["nf"]).astype(np.float32)
    return x, w, b


def _ulp(a, dtype):
    mant, lo = _FMT[dtype]
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** lo)))
    return 2.0 ** (e - mant)


def _port(x, w, b, dy, dtype, attrs, cast=None):
    dt = torch_dtype(dtype)
    cast = cast or dt
    ts = [torch.from_numpy(t).to(dt).to(cast).requires_grad_()
          for t in (x, w, b)]
    out = deconvolution(*ts, **attrs)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(dy).to(dt)
                                .to(cast), allow_unused=True)
    assert out.dtype == cast
    return [np.zeros(t.shape) if g is None else g.detach().double().numpy()
            for t, g in zip([out] + ts[:2] + ts[2:], [out] + list(grads))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_deconvolution_and_gradients_match_jax(case, dtype):
    c = CASES[case]
    attrs = _attrs(c)
    x, w, b = _arrays(c)
    out, vjp = jax.vjp(lambda *a: jget_op("Deconvolution").fn(*a, **attrs),
                       *[jnp.asarray(t).astype(dtype) for t in (x, w, b)])
    # the head gradient at a loss's scale (a mean over the batch)
    dy = (np.random.RandomState(1).randn(*out.shape) * 0.1).astype(
        np.float32)
    want = [np.array(jnp.asarray(t).astype(jnp.float32)).astype(np.float64)
            for t in (out,) + tuple(vjp(jnp.asarray(dy).astype(dtype)))]
    got = _port(x, w, b, dy, dtype, attrs)
    assert got[0].shape == want[0].shape
    if dtype == "float32":
        for g, wv in zip(got, want):
            np.testing.assert_allclose(g, wv, rtol=2e-5, atol=1e-6)
        return
    exact = _port(x, w, b, dy, dtype, attrs, cast=torch.float64)
    for what, g, wv, e in zip(("out", "d_data", "d_weight", "d_bias"), got,
                              want, exact):
        u = _ulp(np.maximum(np.abs(g), np.abs(wv)), dtype)
        ok = (np.abs(g - wv) <= u) | (np.abs(g - e) <= np.abs(wv - e) + u)
        assert ok.all(), "%s %s %s: %d elements off" % (
            case, dtype, what, int((~ok).sum()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_shape_rule_matches_jax_infer_shape(case):
    """The symbol's arguments and their shapes, and the output shape,
    as the JAX package infers them."""
    c = CASES[case]
    attrs = _attrs(c)
    data_shape = (2, c["C"]) + c["sp"]
    res = []
    for pkg in (mx, jmx):
        s = pkg.sym.Deconvolution(pkg.sym.Variable("data"), name="dc",
                                  target_shape=(), layout=None, **attrs)
        args, outs, aux = s.infer_shape(data=data_shape)
        res.append((s.list_arguments(), [tuple(a) for a in args],
                    [tuple(o) for o in outs], list(aux)))
    assert res[0] == res[1]


def test_target_shape_and_layout_change_nothing():
    """``target_shape`` and ``layout`` are accepted and ignored, as in
    the JAX package (ROADMAP C)."""
    c = CASES["2d_dcgan"]
    x, w, b = _arrays(c)
    attrs = _attrs(c)
    plain = deconvolution(torch.from_numpy(x), torch.from_numpy(w), **attrs)
    given = deconvolution(torch.from_numpy(x), torch.from_numpy(w),
                          target_shape=(9, 9), layout="NCHW", **attrs)
    assert torch.equal(plain, given)
    jplain = jget_op("Deconvolution").fn(jnp.asarray(x), jnp.asarray(w),
                                         **attrs)
    jgiven = jget_op("Deconvolution").fn(jnp.asarray(x), jnp.asarray(w),
                                         target_shape=(9, 9), layout="NCHW",
                                         **attrs)
    assert jplain.shape == jgiven.shape == tuple(plain.shape)


@pytest.mark.parametrize("rank,kw", [
    (1, dict(channels=5, kernel_size=3, strides=2, padding=1,
             output_padding=1)),
    (2, dict(channels=6, kernel_size=(4, 3), strides=(2, 1), padding=(1, 1),
             groups=2, activation="relu")),
    (3, dict(channels=4, kernel_size=2, strides=2, use_bias=False)),
])
def test_conv_transpose_layers_match_jax(rank, kw):
    """``nn.Conv{1,2,3}DTranspose`` with deferred shape inference (no
    ``in_channels``): the weight's shape is (in, channels / groups,
    *kernel), the names are the JAX layer's, and the output and
    gradients equal the JAX layer's on the same weights."""
    name = "Conv%dDTranspose" % rank
    x = np.random.RandomState(rank).randn(
        2, 4, *((5,) * rank)).astype(np.float32)
    with JNameManager():
        jnet = getattr(jmx.gluon.nn, name)(**kw)
    jnet.initialize(jmx.init.Xavier())
    jout = jnet(jmx.nd.array(x))
    with NameManager():
        net = getattr(mx.gluon.nn, name)(**kw)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    jparams = {p.name: p.data().asnumpy()
               for p in jnet.collect_params().values()}
    params = net.collect_params()
    assert sorted(p.name for p in params.values()) == sorted(jparams)
    with mx.autograd.record():
        out = net(mx.nd.array(x, ctx=mx.cpu()))
    # deferred: the first call gave the weight its shape; now set the
    # JAX layer's values and run again
    for p in params.values():
        assert p.shape == jparams[p.name].shape
        p.set_data(mx.nd.array(jparams[p.name], ctx=mx.cpu()))
    g = np.random.RandomState(9).randn(*jout.shape).astype(np.float32)
    with mx.autograd.record():
        out = net(mx.nd.array(x, ctx=mx.cpu()))
    out.backward(mx.nd.array(g, ctx=mx.cpu()))
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), rtol=2e-5,
                               atol=1e-6)
    with jmx.autograd.record():
        jo = jnet(jmx.nd.array(x))
    jo.backward(jmx.nd.array(g))
    for p in jnet.collect_params().values():
        np.testing.assert_allclose(
            [q for q in params.values() if q.name == p.name][0].grad()
            .asnumpy(), p.grad().asnumpy(), rtol=2e-5, atol=1e-5)


def test_float16_deconvolution_graph_binds_and_trains():
    """Deconvolution is in the float16 graphs' ops: an f16 DCGAN-style
    generator block binds with gradients and its f16 output is the f32
    sums rounded once."""
    c = CASES["2d_dcgan"]
    d = mx.sym.Variable("data")
    net = mx.sym.Deconvolution(d, name="dc", **_attrs(c))
    net = mx.sym.LeakyReLU(net, act_type="leaky", slope=0.2)
    exe = net.simple_bind(ctx=mx.cpu(), grad_req="write",
                          type_dict={"data": "float16"}, data=(2, 8, 4, 4))
    assert exe.arg_dict["dc_weight"]._data.dtype == torch.float16
    x, w, _ = _arrays(c)
    exe.copy_params_from({"dc_weight": w})
    out = exe.forward(is_train=True, data=x)[0]._data
    exe.backward(mx.nd.ones(out.shape, ctx=mx.cpu(), dtype="float16"))
    x16, w16 = (torch.from_numpy(t).half().float() for t in (x, w))
    ref = torch.nn.functional.conv_transpose2d(x16, w16, stride=2,
                                               padding=1).half()
    ref = torch.where(ref > 0, ref, 0.2 * ref)
    assert torch.equal(out, ref)
    assert torch.isfinite(exe.grad_dict["dc_weight"]._data).all()
