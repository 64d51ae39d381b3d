"""PyTorch port: the channel-last vision ops, the fused BN -> ReLU ->
Conv1x1 primitive and op, and the fusion pass, against the JAX package
on the CPU.

Inputs are made with seeded numpy RandomStates and fed to both
packages.  The JAX side runs its Pallas kernel in interpret mode
(``MXTPU_FUSED_PALLAS=interpret``, set for every test: the JAX package
reads it when it traces), and every fused call on a row count that is a
multiple of 128 asserts that the kernel's launch counter rose, so the
Pallas body ran and not the jnp path that the JAX package takes for
other row counts.  The port's wrappers take their plain versions on CPU
tensors.  f32 tolerances are the ROADMAP's rtol 2e-5 with an atol of
1e-6 times the reference's largest magnitude (at least 1): products
and weight gradients sum in another order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import models as jmodels
from mxnet_tpu import symbol as jsym
from mxnet_tpu.ops import fused as jfused
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.pallas.dispatch import PALLAS_LAUNCHES
from mxnet_tpu.symbol.fuse import fuse_conv_bn as jfuse_conv_bn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import (PLAIN_CALLS, fused_scale_relu_matmul_plain,
                                     reset_counts)
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.ops.fused import fused_scale_relu_matmul
from mxnet_tpu_torch.ops.registry import get_op
from mxnet_tpu_torch.symbol.fuse import count_fused, fuse_conv_bn
from mxnet_tpu_torch.weights import symbol_shapes

RTOL, ATOL = 2e-5, 1e-6
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


def _r(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    atol = ATOL * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol, err_msg=what)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


# ----------------------------------------------------------------------
# the primitive
# ----------------------------------------------------------------------
def _operands(rng, M, K, N, with_res):
    return (_r(rng, M, K), 1 + _r(rng, K, scale=0.3), _r(rng, K, scale=0.3),
            _r(rng, N, K, scale=K ** -0.5),
            _r(rng, M, N) if with_res else None)


@pytest.mark.parametrize("with_res", [False, True])
def test_plain_matches_pallas_and_jnp(with_res):
    """The plain version against the Pallas kernel (M = 384: three row
    tiles of 128) and against the jnp path, with and without the
    residual."""
    x, s, h, w, res = _operands(np.random.RandomState(1), 384, 40, 24,
                                with_res)
    jr = None if res is None else jnp.asarray(res)
    args = (jnp.asarray(x), jnp.asarray(s), jnp.asarray(h),
            jnp.asarray(w.T))
    before = _launches()
    pal = jfused._pallas_fwd(*args, jr)
    assert _launches() == before + 1
    ref = jfused._jnp_fwd(*args, jr)
    reset_counts()
    got = fused_scale_relu_matmul_plain(
        _t(x), _t(s), _t(h), _t(w), None if res is None else _t(res))
    assert PLAIN_CALLS[_KERNEL] == 1
    _close(got.numpy(), pal, "against pallas")
    _close(got.numpy(), ref, "against jnp")


def test_plain_odd_shape_matches_jnp():
    """A row count the TPU kernel refuses (77): the JAX package takes
    its jnp path there, the port's kernel takes any shape."""
    x, s, h, w, res = _operands(np.random.RandomState(2), 77, 13, 9, True)
    before = _launches()
    ref = jfused.fused_scale_relu_matmul(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(h), jnp.asarray(w.T),
        jnp.asarray(res))
    assert _launches() == before                  # no Pallas tile fits
    got = fused_scale_relu_matmul(_t(x), _t(s), _t(h), _t(w), _t(res))
    _close(got.numpy(), ref, "odd shape")


@pytest.mark.parametrize("with_res", [False, True])
def test_gradients_match_custom_vjp(with_res):
    """dx, dscale, dshift, dW and dres of the autograd Function against
    the JAX package's custom VJP (M = 256, so its forward is the Pallas
    kernel)."""
    rng = np.random.RandomState(3)
    x, s, h, w, res = _operands(rng, 256, 16, 12, with_res)
    dy = _r(rng, 256, 12)
    jins = [jnp.asarray(a) for a in (x, s, h, w.T)]
    if with_res:
        jins.append(jnp.asarray(res))
    before = _launches()
    jy, vjp = jax.vjp(lambda *a: jfused.fused_scale_relu_matmul(*a), *jins)
    assert _launches() == before + 1
    jg = vjp(jnp.asarray(dy))
    ins = [_t(a, grad=True) for a in (x, s, h, w)]
    if with_res:
        ins.append(_t(res, grad=True))
    y = fused_scale_relu_matmul(*ins)
    grads = torch.autograd.grad(y, ins, _t(dy))
    _close(y.detach().numpy(), jy, "y")
    for name, g, ref in zip(("dx", "dscale", "dshift", "dW", "dres"), grads,
                            jg):
        ref = np.asarray(ref)
        _close(g.numpy(), ref.T if name == "dW" else ref, name)


# ----------------------------------------------------------------------
# the op
# ----------------------------------------------------------------------
def _op_inputs(rng, with_res, B=2, H=8, W=8, K=12, O=20):
    ins = [_r(rng, B, H, W, K, scale=1.5) + 0.3, 1 + _r(rng, K, scale=0.2),
           _r(rng, K, scale=0.2), _r(rng, K, scale=0.3),
           1 + np.abs(_r(rng, K, scale=0.3)), _r(rng, O, 1, 1, K, scale=0.3)]
    if with_res:
        ins.append(_r(rng, *with_res))
    return ins


_DIFF = (0, 1, 2, 5, 6)        # data, gamma, beta, weight, residual


@pytest.mark.parametrize("is_train,fix_gamma,res", [
    (True, False, None), (True, True, None), (False, False, None),
    (False, True, None), (True, False, (2, 8, 8, 20)),
    (True, False, (1, 1, 1, 20))])
def test_fused_op_matches_jax(is_train, fix_gamma, res):
    """``_FusedBNReluConv`` in train and eval mode, both fix_gamma
    values, with a residual of the output's shape (the kernel's
    epilogue) and one that broadcasts (added after it): the output, the
    new moving statistics, and the gradients of data, gamma, beta, the
    weight and the residual for a random cotangent.  The rows number
    B * H * W = 128, one Pallas tile."""
    rng = np.random.RandomState(4)
    ins = _op_inputs(rng, res)
    attrs = dict(num_filter=20, eps=2e-5, momentum=0.9, fix_gamma=fix_gamma,
                 layout="NHWC", with_residual=res is not None)
    cot = _r(rng, 2, 8, 8, 20)
    diff = [i for i in _DIFF if i < len(ins)]
    fn = jreg.get_op("_FusedBNReluConv").fn

    def f(*d):
        a = [jnp.asarray(v) for v in ins]
        for i, v in zip(diff, d):
            a[i] = v
        with jreg._OpCtxScope(is_train, jax.random.key(0)):
            return fn(*a, **attrs)

    before = _launches()
    jouts, vjp = jax.vjp(f, *[jnp.asarray(ins[i]) for i in diff])
    assert _launches() == before + 1
    jgrads = vjp((jnp.asarray(cot), jnp.zeros_like(jouts[1]),
                  jnp.zeros_like(jouts[2])))

    ts = [_t(a, grad=i in diff) for i, a in enumerate(ins)]
    outs = get_op("_FusedBNReluConv").fn(*ts, is_train=is_train, **attrs)
    grads = torch.autograd.grad(outs[0], [ts[i] for i in diff], _t(cot),
                                allow_unused=True)
    for what, got, ref in zip(("y", "moving_mean", "moving_var"), outs,
                              jouts):
        _close(got.detach().numpy(), ref, what)
    for i, g, ref in zip(diff, grads, jgrads):
        got = np.zeros(ins[i].shape, np.float32) if g is None else g.numpy()
        _close(got, ref, "grad of input %d" % i)


def test_fused_symbol_function_creates_the_residual_variable():
    """``unused_inputs``: without ``with_residual`` the symbol function
    leaves the residual out, with it the residual becomes an argument,
    as in the JAX package."""
    for with_res in (False, True):
        kw = dict(num_filter=8, with_residual=with_res, name="f")
        ref = jsym._FusedBNReluConv(jsym.Variable("data"), **kw)
        got = mx.sym._FusedBNReluConv(mx.sym.Variable("data"), **kw)
        assert got.list_arguments() == ref.list_arguments()
        assert got.list_auxiliary_states() == ref.list_auxiliary_states()
        assert ("f_residual" in got.list_arguments()) == with_res


# ----------------------------------------------------------------------
# the pass
# ----------------------------------------------------------------------
def test_fuse_pass_on_resnet50_nhwc():
    """ResNet-50 v2 NHWC: 28 fused sites (12 conv1, 16 conv3 with the
    shortcut add as the residual), the unfused symbol's arguments and
    auxiliary states, and the JAX pass's sites, names, attributes and
    inferred shapes; an NCHW graph comes back unchanged."""
    kw = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
              layout="NHWC")
    sym = resnet.get_symbol(**kw)
    fsym = fuse_conv_bn(sym)
    jf = jfuse_conv_bn(jmodels.get_symbol("resnet", **kw))
    fused = [n for n in fsym._topo() if not n.is_var
             and n.op.name == "_FusedBNReluConv"]
    assert count_fused(fsym) == len(fused) == 28
    assert sum(n.attrs["with_residual"] for n in fused) == 16
    assert fsym.list_arguments() == sym.list_arguments() \
        == jf.list_arguments()
    assert fsym.list_auxiliary_states() == sym.list_auxiliary_states() \
        == jf.list_auxiliary_states()
    jfused_nodes = {n.name: n for n in jf._topo() if not n.is_var
                    and n.op.name == "_FusedBNReluConv"}
    assert sorted(jfused_nodes) == sorted(n.name for n in fused)
    for n in fused:
        ref = jfused_nodes[n.name].attrs
        for key in ("num_filter", "eps", "momentum", "fix_gamma",
                    "with_residual"):
            assert n.attrs[key] == ref[key], (n.name, key)
        assert [i.name for i, _ in n.inputs] == \
            [i.name for i, _ in jfused_nodes[n.name].inputs]
    shapes = dict(data=(2, 224, 224, 3), softmax_label=(2,))
    for got, ref in zip(fsym.infer_shape(**shapes), jf.infer_shape(**shapes)):
        assert [tuple(s) for s in got] == [tuple(s) for s in ref]
    assert symbol_shapes(fsym, **shapes) == symbol_shapes(sym, **shapes)
    nchw = resnet.get_symbol(num_classes=10, num_layers=50,
                             image_shape=(3, 224, 224))
    assert fuse_conv_bn(nchw) is nchw and count_fused(nchw) == 0


def test_fuse_pass_leaves_shared_activations_and_defaults():
    """An activation feeding two 1x1 convolutions is not fused; a
    BatchNorm built without eps/fix_gamma gives the fused op the
    BatchNorm defaults (1e-3, True), as the JAX pass does."""
    for pkg in (jsym, mx.sym):
        data = pkg.Variable("data")
        act = pkg.Activation(pkg.BatchNorm(data, axis=3, name="bn"),
                             act_type="relu")
        c1 = pkg.Convolution(act, num_filter=8, kernel=(1, 1), no_bias=True,
                             layout="NHWC", name="c1")
        c2 = pkg.Convolution(act, num_filter=8, kernel=(1, 1), no_bias=True,
                             layout="NHWC", name="c2")
        shared = (jfuse_conv_bn if pkg is jsym else fuse_conv_bn)(c1 + c2)
        assert not any(not n.is_var and n.op.name == "_FusedBNReluConv"
                       for n in shared._topo())
    single = fuse_conv_bn(mx.sym.Convolution(
        mx.sym.Activation(mx.sym.BatchNorm(mx.sym.Variable("data"), axis=3,
                                           name="bn"), act_type="relu"),
        num_filter=8, kernel=(1, 1), no_bias=True, layout="NHWC", name="c"))
    (node,) = [n for n in single._topo() if not n.is_var]
    assert node.op.name == "_FusedBNReluConv"
    assert node.attrs["eps"] == 1e-3 and node.attrs["fix_gamma"] is True


# ----------------------------------------------------------------------
# channel-last Convolution, Pooling and BatchNorm
# ----------------------------------------------------------------------
def _compare_op(name, ins, attrs, is_train=True):
    """Outputs and the gradients of every input for a random cotangent
    of output 0 (BatchNorm: data, gamma and beta)."""
    fn = jreg.get_op(name).fn
    n_diff = 3 if name == "BatchNorm" else len(ins)

    def f(*d):
        with jreg._OpCtxScope(is_train, jax.random.key(0)):
            return fn(*d, *[jnp.asarray(a) for a in ins[n_diff:]], **attrs)

    jouts, vjp = jax.vjp(f, *[jnp.asarray(a) for a in ins[:n_diff]])
    jouts = list(jouts) if isinstance(jouts, (tuple, list)) else [jouts]
    cot = np.random.RandomState(9).randn(*jouts[0].shape).astype(np.float32)
    jgrads = vjp(tuple([jnp.asarray(cot)] + [jnp.zeros_like(o)
                                             for o in jouts[1:]])
                 if len(jouts) > 1 else jnp.asarray(cot))
    op = get_op(name)
    ts = [_t(a, grad=i < n_diff) for i, a in enumerate(ins)]
    kw = dict(attrs, is_train=is_train) if op.takes_is_train else attrs
    outs = op.fn(*ts, **kw)
    outs = list(outs) if isinstance(outs, tuple) else [outs]
    grads = torch.autograd.grad(outs[0], ts[:n_diff], _t(cot))
    assert outs[0].is_contiguous()
    for i, (got, ref) in enumerate(zip(outs, jouts)):
        _close(got.detach().numpy(), ref, "%s output %d" % (name, i))
    for i, (got, ref) in enumerate(zip(grads, jgrads)):
        # a global pool's gradient is a broadcast view, not a relayout
        assert got.is_contiguous() or name != "Convolution"
        _close(got.numpy(), ref, "%s grad %d" % (name, i))


@pytest.mark.parametrize("case", ["stem", "grouped_dilated_bias", "1x1_s2"])
def test_nhwc_convolution_matches_jax(case):
    """NHWC data with OHWI weights: the ImageNet stem (7x7, stride 2, pad
    3), a grouped dilated 3x3 with a bias, a strided 1x1; the outputs
    and the gradients come back contiguous NHWC (no relayout copy is
    made, and none is needed by the consumer)."""
    rng = np.random.RandomState(5)
    if case == "stem":
        ins = [_r(rng, 2, 20, 20, 3), _r(rng, 8, 7, 7, 3, scale=0.1)]
        attrs = dict(kernel=(7, 7), num_filter=8, stride=(2, 2), pad=(3, 3),
                     no_bias=True)
    elif case == "grouped_dilated_bias":
        ins = [_r(rng, 2, 11, 9, 4), _r(rng, 6, 3, 3, 2, scale=0.2),
               _r(rng, 6)]
        attrs = dict(kernel=(3, 3), num_filter=6, num_group=2, dilate=(2, 1),
                     pad=(2, 1))
    else:
        ins = [_r(rng, 2, 8, 8, 5), _r(rng, 7, 1, 1, 5, scale=0.3)]
        attrs = dict(kernel=(1, 1), num_filter=7, stride=(2, 2),
                     no_bias=True)
    _compare_op("Convolution", ins, dict(attrs, layout="NHWC"))


@pytest.mark.parametrize("case", ["max_stem", "max_full", "avg_global",
                                  "avg_excl_pad", "sum", "max_global"])
def test_nhwc_pooling_matches_jax(case):
    """NHWC pooling: max 3x3/s2/p1 over ReLU outputs (ties go to the
    first maximum, as XLA's select-and-scatter), the 'full' convention,
    global average and max, average without padding in the count, and
    sum."""
    rng = np.random.RandomState(7)
    x = np.maximum(_r(rng, 2, 9, 11, 3) - 1.0, 0)
    attrs = {
        "max_stem": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
        "max_full": dict(kernel=(3, 3), stride=(2, 2),
                         pooling_convention="full"),
        "avg_global": dict(kernel=(7, 7), global_pool=True, pool_type="avg"),
        "max_global": dict(kernel=(7, 7), global_pool=True),
        "avg_excl_pad": dict(kernel=(3, 2), stride=(2, 2), pad=(1, 1),
                             pool_type="avg", count_include_pad=False),
        "sum": dict(kernel=(2, 2), stride=(1, 2), pool_type="sum",
                    pooling_convention="full"),
    }[case]
    if case == "max_global":
        x = _r(rng, 2, 9, 11, 3)
    _compare_op("Pooling", [x], dict(attrs, layout="NHWC"))


@pytest.mark.parametrize("is_train", [True, False])
def test_nhwc_batchnorm_matches_jax(is_train):
    """BatchNorm over axis 3 of NHWC data: all five outputs and dx,
    dgamma, dbeta."""
    rng = np.random.RandomState(8)
    C = 6
    ins = [_r(rng, 4, 5, 3, C, scale=2.0) + 0.5, 1 + _r(rng, C, scale=0.2),
           _r(rng, C, scale=0.2), _r(rng, C, scale=0.3),
           1 + np.abs(_r(rng, C, scale=0.3))]
    _compare_op("BatchNorm", ins, dict(eps=2e-5, momentum=0.9,
                                       fix_gamma=False, axis=3),
                is_train=is_train)


@pytest.mark.parametrize("kw,shape", [
    (dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224)),
     (2, 224, 224, 3)),
    (dict(num_classes=10, num_layers=18, image_shape=(3, 64, 64),
          version=1), (2, 64, 64, 3))])
def test_nhwc_resnet_symbols_match_jax(kw, shape):
    """``layout='NHWC'``: the same arguments, auxiliary states and
    outputs, with OHWI weight shapes, as the JAX package's symbol."""
    jsymbol = jmodels.get_symbol("resnet", layout="NHWC", **kw)
    sym = resnet.get_symbol(layout="NHWC", **kw)
    assert sym.list_arguments() == jsymbol.list_arguments()
    assert sym.list_auxiliary_states() == jsymbol.list_auxiliary_states()
    assert sym.list_outputs() == jsymbol.list_outputs()
    for got, ref in zip(sym.infer_shape(data=shape),
                        jsymbol.infer_shape(data=shape)):
        assert [tuple(s) for s in got] == [tuple(s) for s in ref]
