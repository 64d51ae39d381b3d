"""PyTorch port: ``_contrib_CausalSelfAttention`` against the JAX op.

The op (packed (B, S, 3d) q|k|v -> (B, S, d), causal, over the port's
row 8 flash kernels) and its gradient against ``jax.vjp`` of the JAX
op's path off the TPU (the materialized softmax under
``jax.checkpoint``): f32 at rtol 2e-5 / atol 1e-6; f16 at relative L2
``FLASH_L2`` = 2^-8 (the JAX path rounds the scores to the input type
before its f32 softmax; the kernels keep them f32, ROADMAP C), as
tests/test_torch_serve_f16.py holds the f16 draft's attention; bf16,
with three mantissa bits fewer, at 2^-7, and no farther from the JAX
op's f32 result on the same bf16 inputs than the JAX op's own bf16
result is (the port's gradient sits 0.0024-0.0029 from it, the JAX
package's 0.0033-0.0037).
Symbol, ``mx.nd`` and Gluon's ``F.contrib`` reach it; its shape rule
matches the JAX package's; on the CPU it takes the plain versions of
the three kernels (forward, dK/dV, dQ); and one ``Module.fit`` step of
FullyConnected -> CausalSelfAttention -> FullyConnected ends on the
JAX package's weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops.registry import get_op as jget_op

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import torch_dtype
from mxnet_tpu_torch.ops.nn import causal_self_attention

FLASH_L2 = 2.0 ** -8
L2 = {"bfloat16": 2.0 ** -7, "float16": FLASH_L2}
DTYPES = ("float32", "bfloat16", "float16")
B, S, H, D = 2, 24, 3, 8


def _qkv(seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    qkv = (rng.randn(B, S, 3 * H * D) * scale).astype(np.float32)
    dy = rng.randn(B, S, H * D).astype(np.float32)
    return qkv, dy


def _f64(t):
    return np.array(jnp.asarray(t).astype(jnp.float32)).astype(np.float64) \
        if not isinstance(t, torch.Tensor) else t.detach().double().numpy()


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale", [None, 0.2])
def test_op_and_gradient_match_jax(dtype, scale):
    qkv, dy = _qkv()
    jin = jnp.asarray(qkv).astype(dtype)
    op = jget_op("_contrib_CausalSelfAttention").fn
    out, vjp = jax.vjp(lambda a: op(a, num_heads=H, scale=scale), jin)
    (jg,) = vjp(jnp.asarray(dy).astype(dtype))
    dt = torch_dtype(dtype)
    t = torch.from_numpy(qkv).to(dt).requires_grad_()
    before = dict(kernels.PLAIN_CALLS)
    got = causal_self_attention(t, num_heads=H, scale=scale)
    (g,) = torch.autograd.grad(got, t, torch.from_numpy(dy).to(dt))
    # the CPU takes each kernel's plain version, once
    for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
              "flash_attention_bwd_dq"):
        assert kernels.PLAIN_CALLS[k] == before.get(k, 0) + 1, k
    assert got.dtype == dt and g.dtype == dt
    assert tuple(got.shape) == (B, S, H * D)
    if dtype == "float32":
        np.testing.assert_allclose(_f64(got), _f64(out), rtol=2e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(_f64(g), _f64(jg), rtol=2e-5, atol=1e-6)
    else:
        _hold_16bit(op, qkv, dy, dtype, got, g, out, jg, scale)


def _hold_16bit(op, qkv, dy, dtype, got, g, out, jg, scale=None):
    """Output and gradient within ``L2[dtype]`` of the JAX op's, and no
    farther from the JAX op's f32 result on the same 16-bit inputs than
    its own 16-bit result is."""
    j32 = jnp.asarray(qkv).astype(dtype).astype(jnp.float32)
    o32, vjp32 = jax.vjp(lambda a: op(a, num_heads=H, scale=scale), j32)
    (g32,) = vjp32(jnp.asarray(dy).astype(dtype).astype(jnp.float32))
    for mine, ref, exact in ((got, out, o32), (g, jg, g32)):
        assert _rel_l2(_f64(mine), _f64(ref)) < L2[dtype]
        assert _rel_l2(_f64(mine), _f64(exact)) \
            <= _rel_l2(_f64(ref), _f64(exact))


def test_every_front_end_reaches_it_and_shapes_match_jax():
    qkv, _ = _qkv(seed=1)
    want = causal_self_attention(torch.from_numpy(qkv), num_heads=H)
    nd = mx.nd.contrib.CausalSelfAttention(mx.nd.array(qkv, ctx=mx.cpu()),
                                           num_heads=H)
    assert torch.equal(nd._data, want)

    class Net(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.contrib.CausalSelfAttention(x, num_heads=H)

    net = Net()
    for hybrid in (False, True):
        if hybrid:
            net.hybridize()
        out = net(mx.nd.array(qkv, ctx=mx.cpu()))
        assert torch.equal(out._data, want)
    shapes = []
    for pkg in (mx, jmx):
        s = pkg.sym.contrib.CausalSelfAttention(pkg.sym.Variable("qkv"),
                                                num_heads=H, name="att")
        args, outs, aux = s.infer_shape(qkv=(B, S, 3 * H * D))
        shapes.append((s.list_arguments(), [tuple(a) for a in args],
                       [tuple(o) for o in outs]))
    assert shapes[0] == shapes[1]
    exe = mx.sym.contrib.CausalSelfAttention(
        mx.sym.Variable("qkv"), num_heads=H).simple_bind(
        ctx=mx.cpu(), qkv=(B, S, 3 * H * D))
    assert torch.equal(exe.forward(qkv=qkv)[0]._data, want)


def test_heads_must_divide_the_width():
    with pytest.raises(mx.MXNetError):
        causal_self_attention(torch.zeros(1, 4, 3 * 10), num_heads=3)
    with pytest.raises(mx.MXNetError):
        causal_self_attention(torch.zeros(1, 4, 10), num_heads=2)


def _sym(pkg, classes=5):
    data = pkg.sym.Variable("data")
    x = pkg.sym.FullyConnected(data, num_hidden=3 * H * D, flatten=False,
                               name="qkv")
    x = pkg.sym.contrib.CausalSelfAttention(x, num_heads=H, name="att")
    x = pkg.sym.FullyConnected(x, num_hidden=classes, name="head")
    return pkg.sym.SoftmaxOutput(x, name="softmax")


def _fit(pkg, params, x, y):
    mod = pkg.Module(_sym(pkg), context=pkg.cpu())
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    arr = (lambda v: pkg.nd.array(v, ctx=pkg.cpu())) if pkg is mx \
        else pkg.nd.array
    mod.init_params(arg_params={k: arr(v) for k, v in params.items()})
    it = pkg.io.NDArrayIter(x, y, batch_size=x.shape[0])
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
            eval_metric="acc")
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_fit_step_matches_jax():
    """Two SGD steps of FullyConnected -> CausalSelfAttention ->
    FullyConnected through ``Module.fit`` (the port's fused step) end on
    the JAX package's weights at 2e-5 / 1e-6."""
    rng = np.random.RandomState(4)
    x = rng.randn(4, S, 6).astype(np.float32)
    y = rng.randint(0, 5, (4,)).astype(np.float32)
    params = {"qkv_weight": rng.randn(3 * H * D, 6) * 0.3,
              "qkv_bias": rng.randn(3 * H * D) * 0.1,
              "head_weight": rng.randn(5, S * H * D) * 0.05,
              "head_bias": np.zeros(5)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    got = _fit(mx, params, x, y)
    want = _fit(jmx, params, x, y)
    for k in params:
        assert np.abs(got[k] - params[k]).max() > 1e-4, k
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("dtype", ("bfloat16", "float16"))
def test_16bit_graph_binds_and_matches_jax(dtype):
    """A 16-bit graph with the op binds (CausalSelfAttention is one of
    the float16 graphs' ops) and its output and input gradient hold the
    JAX op's as the op does."""
    qkv, dy = _qkv(seed=2)
    exe = mx.sym.contrib.CausalSelfAttention(
        mx.sym.Variable("qkv"), num_heads=H).simple_bind(
        ctx=mx.cpu(), grad_req="write", type_dict={"qkv": dtype},
        qkv=(B, S, 3 * H * D))
    out = exe.forward(is_train=True, qkv=qkv)[0]._data
    exe.backward(mx.nd.array(dy, ctx=mx.cpu()))
    op = jget_op("_contrib_CausalSelfAttention").fn
    jout, vjp = jax.vjp(lambda a: op(a, num_heads=H),
                        jnp.asarray(qkv).astype(dtype))
    (jg,) = vjp(jnp.asarray(dy).astype(dtype))
    _hold_16bit(op, qkv, dy, dtype, out, exe.grad_dict["qkv"]._data, jout,
                jg)
