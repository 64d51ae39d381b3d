"""PyTorch port: bf16 training with multi-precision SGD, against the JAX
package on the CPU.

Inputs and weights are made with seeded numpy and handed to both
packages.  What is held, and at which bound:

* type inference (``infer_shape_type``): the inferred type of every
  argument and auxiliary state equals the JAX package's, name by name,
  for ResNet-50 NHWC bf16 (unfused and after ``fuse_conv_bn``) and the
  bf16 transformer; ``simple_bind`` allocates in those types;
* ``mp_sgd_update`` / ``mp_sgd_mom_update`` and the optimizer's
  ``create_state_multi_precision`` / ``update_multi_precision``: the
  f32 master and momentum within 1e-6 relative, the bf16 weight equal
  to the master rounded to bf16, bit for bit;
* the plain bf16 flash attention (forward and the three kernels'
  backward through ``FlashAttentionFn``) against ``jax.vjp`` of the
  reference's bf16 XLA attention: every element within 2^-6 of the
  array's largest value and the relative L2 error under 1e-2 (the
  reference rounds the scores to bf16 before the softmax, the port
  keeps them in f32 as the flash kernel does; measured relative L2
  0.0016 to 0.0038, largest error 1 to 2 bf16 ulps), also at small
  forms of the edges of the card's tiling (S 17, 130 and 1, D 36 and
  80; at S = 1 dq and dk are exact zeros on both sides);
* the plain bf16 fused BN-apply/ReLU/1x1 product against the
  reference's ``fused_scale_relu_matmul`` Pallas kernel in interpret
  mode, at the reference's own bf16 bound, 5e-2
  (tests/test_fused_conv.py);
* two bf16 ``TrainStep`` steps of ResNet-18 NCHW (3x32x32, batch 4,
  4 classes: tests/test_trainer.py's bf16 configuration), of a fused
  NHWC bottleneck ResNet (ResNet-18 has no site to fuse) and of a
  2-layer bf16 transformer: the outputs' relative L2 error under 2e-2
  and 3e-2 (measured 0.001 to 0.007 and 0.012), and the f32 masters'
  moves from their bf16-rounded start.  A random-init BatchNorm
  ResNet's gradient moves by tens of percents under bf16-level changes:
  the JAX package against itself with the input scaled by 1 + 2^-12
  moves its masters 0.29 (ResNet-18) and 0.15 (bottleneck) apart in
  relative L2, and the port lands 0.29 and 0.15 from it, so the ResNet
  masters are held at 0.5.  The transformer's are held at 5e-2
  (measured 0.012, the size of its output difference: the packages
  round bf16 products at other points, the reference its attention
  scores too).  In both packages the bf16 weight is the master rounded
  to bf16;
* bf16 parameters carried between the packages bit for bit;
* the float16 ResNet and transformer symbols build, ``TrainStep`` and
  ``simple_bind`` take an f16 ResNet graph, and an f16 weight under
  ``multi_precision`` takes an f32 master (float16 training:
  tests/test_torch_fit_f16.py, tests/test_torch_resnet_f16.py); a bf16
  parameter under ``multi_precision`` in ``Module``'s updater trains
  through its master.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.ops import optimizer_ops as joo
from mxnet_tpu.ops.fused import fused_scale_relu_matmul as jfused
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu.pallas.dispatch import PALLAS_LAUNCHES
from mxnet_tpu.parallel.trainer import TrainStep as JTrainStep
from mxnet_tpu.symbol.fuse import fuse_conv_bn as jfuse_conv_bn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import (PLAIN_CALLS, flash_attention,
                                     fused_scale_relu_matmul_plain,
                                     reset_counts)
from mxnet_tpu_torch.models import resnet, transformer
from mxnet_tpu_torch.ops import optimizer_ops as oo
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.symbol.fuse import count_fused, fuse_conv_bn
from mxnet_tpu_torch.weights import (convert_symbol_params, export_params,
                                     symbol_shapes)

BF16 = torch.bfloat16
RESNET50 = dict(num_classes=10, num_layers=50, image_shape=(3, 64, 64),
                dtype="bfloat16", layout="NHWC")
RESNET18 = dict(num_classes=4, num_layers=18, image_shape=(3, 32, 32),
                dtype="bfloat16")
LM = dict(num_classes=50, num_layers=2, d_model=64, num_heads=2,
          seq_len=16, dtype="bfloat16")
# ResNet-18 has no 1x1 stride-1 convolution to fuse, so the fused arm
# takes tests/test_torch_trainstep.py's small bottleneck net (5 sites)
BOTTLENECK = dict(units=[2, 1, 1], num_stages=3, filter_list=[8, 32, 64, 128],
                  num_classes=4, image_shape=(3, 32, 32), bottle_neck=True,
                  dtype="bfloat16", layout="NHWC")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _name(dtype):
    return str(dtype).replace("torch.", "")


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np32(a):
    """numpy f32 of a torch tensor or a JAX array of any float type."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ----------------------------------------------------------------------
# type inference and allocation
# ----------------------------------------------------------------------
def _symbols(which):
    if which == "transformer":
        return (transformer.get_symbol(**LM), jtransformer.get_symbol(**LM),
                {"data": (2, 16), "softmax_label": (32,)})
    sym, jsym = resnet.get_symbol(**RESNET50), jresnet.get_symbol(**RESNET50)
    if which == "resnet50_nhwc_fused":
        sym, jsym = fuse_conv_bn(sym), jfuse_conv_bn(jsym)
    return sym, jsym, {"data": (2, 64, 64, 3), "softmax_label": (2,)}


@pytest.mark.parametrize("which", ["resnet50_nhwc", "resnet50_nhwc_fused",
                                   "transformer"])
def test_inferred_types_match_jax(which):
    """Every argument's and auxiliary state's inferred type equals the
    JAX package's, name by name: bf16 data makes the weights it meets
    bf16 (BatchNorm's statistics too, as the JAX package infers them),
    the f32 data input and labels stay f32, the embeddings keep their
    own type."""
    sym, jsym, shapes = _symbols(which)
    if which == "resnet50_nhwc_fused":
        assert count_fused(sym) == 28          # bench.py's fused sites
    _, at, _, xt = sym.infer_shape_type(shapes)
    _, jat, _, jxt = jsym.infer_shape_type(shapes)
    assert sym.list_arguments() == jsym.list_arguments()
    assert sym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert [_name(t) for t in at] == [str(t) for t in jat]
    assert [_name(t) for t in xt] == [str(t) for t in jxt]
    assert BF16 in at
    exe = sym.simple_bind(ctx=mx.cpu(), grad_req="write", **shapes)
    for name, t in zip(sym.list_arguments(), at):
        assert exe.arg_dict[name]._data.dtype == t
        assert exe.grad_dict[name]._data.dtype == t
    for name, t in zip(sym.list_auxiliary_states(), xt):
        assert exe.aux_dict[name]._data.dtype == t


def test_given_input_type_and_type_dict():
    """An f32 symbol given bf16 data (``TrainStep(dtype='bfloat16')``'s
    form): the types equal the JAX package's, ``infer_type`` gives the
    same, and ``simple_bind(type_dict=...)`` allocates them."""
    sym, jsym = (m.get_symbol(**dict(RESNET18, dtype="float32"))
                 for m in (resnet, jresnet))
    shapes = {"data": (1, 3, 32, 32), "softmax_label": (1,)}
    _, at, _, xt = sym.infer_shape_type(shapes, {"data": "bfloat16"})
    _, jat, _, jxt = jsym.infer_shape_type(shapes, {"data": jnp.bfloat16})
    assert [_name(t) for t in at + xt] == [str(t) for t in jat + jxt]
    assert sym.infer_type(data="bfloat16")[0] == at
    exe = sym.simple_bind(ctx=mx.cpu(), type_dict={"data": "bfloat16"},
                          **shapes)
    assert exe.arg_dict["data"]._data.dtype == BF16
    assert exe.arg_dict["conv0_weight"]._data.dtype == BF16


# ----------------------------------------------------------------------
# multi-precision updates
# ----------------------------------------------------------------------
@pytest.mark.parametrize("momentum,wd,clip", [(0.0, 0.0, -1.0),
                                              (0.9, 1e-2, 0.3)])
def test_mp_sgd_update_ops_match_jax(momentum, wd, clip):
    """The in-place port ops against the JAX ops, three updates from
    the same bf16 weight, f32 master, bf16 gradients."""
    rng = np.random.RandomState(1)
    w32 = rng.randn(7, 5).astype(np.float32)
    grads = [rng.randn(7, 5).astype(np.float32) for _ in range(3)]
    kw = dict(lr=0.1, wd=wd, rescale_grad=0.5, clip_gradient=clip)
    jw = jnp.asarray(w32).astype(jnp.bfloat16)
    jw32, jmom = jnp.asarray(w32), jnp.zeros((7, 5), jnp.float32)
    tw = torch.from_numpy(w32).to(BF16)
    tw32, tmom = torch.from_numpy(w32.copy()), torch.zeros(7, 5)
    for g in grads:
        jg, tg = jnp.asarray(g).astype(jnp.bfloat16), torch.from_numpy(g).to(
            BF16)
        if momentum:
            jw, jmom, jw32 = joo.mp_sgd_mom_update(jw, jg, jmom, jw32,
                                                   momentum=momentum, **kw)
            oo.mp_sgd_mom_update(tw, tg, tmom, tw32, momentum=momentum, **kw)
        else:
            jw, jw32 = joo.mp_sgd_update(jw, jg, jw32, **kw)
            oo.mp_sgd_update(tw, tg, tw32, **kw)
    np.testing.assert_allclose(tw32.numpy(), np.asarray(jw32), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tmom.numpy(), np.asarray(jmom), rtol=1e-6,
                               atol=1e-7)
    assert tw.dtype == BF16 and torch.equal(tw, tw32.to(BF16))
    np.testing.assert_array_equal(_np32(tw), _np32(jw))


def test_optimizer_multi_precision_state():
    """``create_state_multi_precision`` / ``update_multi_precision``
    (the counterpart of tests/test_dtype.py's bf16 case): an f32 master
    beside the momentum, the bf16 weight tracking it, both packages
    alike after 10 updates; without ``multi_precision`` no master."""
    kw = dict(learning_rate=0.1, momentum=0.9, multi_precision=True)
    opt, jopt = mx.optimizer.SGD(**kw), jmx.optimizer.SGD(**kw)
    w = mx.nd.array(np.ones(8, np.float32), ctx=mx.cpu()).astype("bfloat16")
    jw = jmx.nd.array(np.ones(8, np.float32)).astype("bfloat16")
    state = opt.create_state_multi_precision(0, w)
    jstate = jopt.create_state_multi_precision(0, jw)
    g = mx.nd.array(np.full(8, 0.25, np.float32), ctx=mx.cpu()).astype(
        "bfloat16")
    jg = jmx.nd.array(np.full(8, 0.25, np.float32)).astype("bfloat16")
    for _ in range(10):
        opt.update_multi_precision(0, w, g, state)
        jopt.update_multi_precision(0, jw, jg, jstate)
    mom, w32 = state
    assert w32.dtype == torch.float32 and w.dtype == BF16
    np.testing.assert_allclose(w32.asnumpy(), jstate[1].asnumpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(mom.asnumpy(), jstate[0].asnumpy(),
                               rtol=1e-6)
    np.testing.assert_array_equal(w.asnumpy(),
                                  jw.astype("float32").asnumpy())
    assert float(w32.asnumpy().mean()) < 1.0
    plain = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
    assert plain.create_state_multi_precision(0, w).shape == (8,)


# ----------------------------------------------------------------------
# the kernels' plain bf16 forms
# ----------------------------------------------------------------------
def _jax_causal_attention(q, k, v, scale):
    B, H, S, D = q.shape
    pack = lambda t: t.transpose(0, 2, 1, 3).reshape(B, S, H * D)
    qkv = jnp.concatenate([pack(q), pack(k), pack(v)], axis=-1)
    o = jget_op("_contrib_CausalSelfAttention").fn(qkv, num_heads=H,
                                                   scale=scale)
    return o.reshape(B, S, H, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,H,S,D", [(2, 2, 40, 64), (1, 2, 70, 32),
                                     (1, 2, 17, 36), (1, 1, 130, 80),
                                     (2, 2, 1, 16)])
def test_flash_attention_bf16_matches_jax(B, H, S, D):
    rng = np.random.RandomState(S)
    q, k, v, do = ((rng.randn(B, H, S, D) * 0.5).astype(np.float32)
                   for _ in range(4))
    sc = 1.0 / np.sqrt(D)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16)
                       for a in (q, k, v, do))
    ref_o, vjp = jax.vjp(lambda q, k, v: _jax_causal_attention(q, k, v, sc),
                         jq, jk, jv)
    ref = (ref_o,) + vjp(jdo)
    reset_counts()
    ins = [torch.from_numpy(a).to(BF16).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ins, scale=sc)
    got = (out,) + torch.autograd.grad(out, ins,
                                       torch.from_numpy(do).to(BF16))
    for what, a, r in zip(("out", "dq", "dk", "dv"), got, ref):
        assert a.dtype == BF16, what
        a, r = _np32(a), _np32(r)
        np.testing.assert_allclose(a, r, rtol=0,
                                   atol=2.0 ** -6 * float(np.abs(r).max()),
                                   err_msg=what)
        # at S = 1 dq and dk are exact zeros (a softmax over one score
        # has no gradient), which the atol-0 bound above demands
        if np.abs(r).any():
            assert _rel_l2(a, r) < 1e-2, what
    assert PLAIN_CALLS["flash_attention_fwd"] == 1
    assert PLAIN_CALLS["flash_attention_bwd_dq"] == 1


@pytest.mark.parametrize("with_res,shape", [
    (False, (256, 64, 96)), (True, (256, 64, 96)),
    (False, (384, 72, 36)), (True, (384, 72, 36))],
    ids=["False", "True", "False-384x72x36", "True-384x72x36"])
def test_fused_matmul_bf16_matches_pallas(monkeypatch, with_res, shape):
    """The plain bf16 form against the reference's Pallas kernel
    (interpret mode; M a multiple of 128 so the kernel, not the jnp
    path, runs: its launch counter rises), at a shape of whole tiles and
    at the card kernel's edges: K a multiple of 8 but not of its K step
    (32), N not a multiple of 8."""
    monkeypatch.setenv("MXTPU_FUSED_PALLAS", "interpret")
    rng = np.random.RandomState(3 + with_res)
    M, K, N = shape
    x = rng.randn(M, K).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(K)).astype(np.float32)
    shift = (0.2 * rng.randn(K)).astype(np.float32)
    w = (rng.randn(N, K) / np.sqrt(K)).astype(np.float32)
    res = rng.randn(M, N).astype(np.float32) if with_res else None
    counter = PALLAS_LAUNCHES.labels(kernel="fused_scale_relu_matmul")
    before = counter.value
    bf = jnp.bfloat16
    ref = jfused(jnp.asarray(x).astype(bf), jnp.asarray(scale),
                 jnp.asarray(shift), jnp.asarray(w.T).astype(bf),
                 None if res is None else jnp.asarray(res).astype(bf))
    assert counter.value == before + 1 and ref.dtype == bf
    got = fused_scale_relu_matmul_plain(
        torch.from_numpy(x).to(BF16), torch.from_numpy(scale),
        torch.from_numpy(shift), torch.from_numpy(w).to(BF16),
        None if res is None else torch.from_numpy(res).to(BF16))
    assert got.dtype == BF16
    np.testing.assert_allclose(_np32(got), _np32(ref), rtol=5e-2, atol=5e-2)


# ----------------------------------------------------------------------
# TrainStep in bf16 with multi-precision SGD
# ----------------------------------------------------------------------
def _weights(sym, shapes, seed=3):
    """He-normal weights, BatchNorm scales near one, moving statistics
    near (0, 1), as f32 numpy."""
    args, auxs = symbol_shapes(sym, **shapes)
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in args.items():
        if n.endswith("_gamma"):
            out[n] = 1 + 0.1 * rng.randn(*s)
        elif n.endswith(("_beta", "_bias")):
            out[n] = 0.1 * rng.randn(*s)
        else:
            fan = int(np.prod(s[1:])) if len(s) > 1 else s[0]
            out[n] = rng.randn(*s) * np.sqrt(2.0 / fan)
    aux = {n: (1 + 0.1 * np.abs(rng.randn(*s))) if n.endswith("_var")
           else 0.1 * rng.randn(*s) for n, s in auxs.items()}
    return ({n: a.astype(np.float32) for n, a in out.items()},
            {n: a.astype(np.float32) for n, a in aux.items()})


def _case(which):
    rng = np.random.RandomState(6)
    if which == "transformer":
        sym, jsym = (m.get_symbol(**LM) for m in (transformer, jtransformer))
        shapes = {"data": (2, 16), "softmax_label": (32,)}
        batch = {"data": rng.randint(0, 50, (2, 16)).astype(np.float32),
                 "softmax_label": rng.randint(0, 50, (32,)).astype(
                     np.float32)}
        return sym, jsym, shapes, batch, 1.0 / 32, (3e-2, 5e-2)
    x = rng.uniform(0, 1, (4, 3, 32, 32)).astype(np.float32)
    y = rng.randint(0, 4, (4,)).astype(np.float32)
    if which == "resnet18_nchw":
        sym, jsym = (m.get_symbol(**RESNET18) for m in (resnet, jresnet))
    else:
        sym = fuse_conv_bn(resnet.resnet(**BOTTLENECK))
        jsym = jfuse_conv_bn(jresnet.resnet(**BOTTLENECK))
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    shapes = {"data": x.shape, "softmax_label": (4,)}
    return sym, jsym, shapes, {"data": x, "softmax_label": y}, 0.25, \
        (2e-2, 0.5)


@pytest.mark.parametrize("which", ["resnet18_nchw", "bottleneck_nhwc_fused",
                                   "transformer"])
def test_trainstep_bf16_multi_precision_matches_jax(monkeypatch, which):
    monkeypatch.setenv("MXTPU_FUSED_PALLAS", "interpret")
    sym, jsym, shapes, batch, rescale, (out_l2, master_l2) = _case(which)
    args, auxs = _weights(sym, shapes)
    io = dict(data_shapes={"data": shapes["data"]},
              label_shapes={"softmax_label": shapes["softmax_label"]})
    opt = dict(learning_rate=0.05, momentum=0.9, wd=1e-4,
               multi_precision=True, rescale_grad=rescale)
    ts = TrainStep(sym, mx.optimizer.SGD(**opt), ctx=mx.cpu(), **io)
    ts.init_params(mx.init.Xavier(), arg_params=args, aux_params=auxs)
    jts = JTrainStep(jsym, jmx.optimizer.SGD(**opt), **io)
    jts.init_params(jmx.init.Xavier(),
                    arg_params={n: jmx.nd.array(a) for n, a in args.items()},
                    aux_params={n: jmx.nd.array(a) for n, a in auxs.items()})
    reset_counts()
    for _ in range(2):
        out = ts.step(batch)[0]
        jout = jts.step(batch)[0]
        assert out.dtype == torch.float32 and np.isfinite(_np32(out)).all()
        assert _rel_l2(_np32(out), _np32(jout)) < out_l2
    if which == "bottleneck_nhwc_fused":
        assert count_fused(sym) == 5
        assert PLAIN_CALLS["fused_scale_relu_matmul"] == 2 * 5
    low = [n for n, t in ts.params.items() if t.dtype == BF16]
    assert low and sorted(low) == sorted(
        n for n, t in jts.params.items() if t.dtype == jnp.bfloat16)
    moved, jmoved = [], []
    for n in low:
        mom, w32 = ts.states[n]
        assert w32.dtype == torch.float32 and mom.dtype == torch.float32
        assert torch.equal(ts.params[n], w32.to(BF16)), n
        jw32 = np.asarray(jts.states[n][-1])
        np.testing.assert_array_equal(
            _np32(jts.params[n]), _np32(jnp.asarray(jw32).astype(
                jnp.bfloat16)))
        start = _np32(torch.from_numpy(args[n]).to(BF16))   # the masters'
        moved.append((w32.numpy() - start).ravel())
        jmoved.append((jw32 - start).ravel())
    moved, jmoved = np.concatenate(moved), np.concatenate(jmoved)
    assert np.abs(moved).max() > 0
    assert _rel_l2(moved, jmoved) < master_l2


# ----------------------------------------------------------------------
# weights across, and what still raises
# ----------------------------------------------------------------------
def test_bf16_weights_carry_bit_exact():
    """JAX bf16 parameters (numpy ``ml_dtypes.bfloat16``) become torch
    bf16 with the same bits, bind into a bf16 TrainStep as they are, and
    come back through ``export_params`` as f32 that casts to the same
    bits in the JAX package."""
    sym = resnet.get_symbol(**RESNET18)
    shapes = {"data": (4, 3, 32, 32), "softmax_label": (4,)}
    args, auxs = _weights(sym, shapes)
    jargs = {n: np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
             for n, a in args.items()}
    bits = lambda a: np.asarray(a).view(np.uint16)
    targs, _ = convert_symbol_params(jargs, auxs, mx.cpu(), sym, **shapes)
    for n, a in jargs.items():
        t = targs[n]._data
        assert t.dtype == BF16
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(
            np.uint16), bits(a))
    ts = TrainStep(sym, mx.optimizer.SGD(multi_precision=True),
                   data_shapes={"data": shapes["data"]},
                   label_shapes={"softmax_label": (4,)}, ctx=mx.cpu())
    ts.init_params(mx.init.Xavier(), arg_params=jargs, aux_params=auxs)
    back = export_params(ts.params)
    for n, a in jargs.items():
        assert back[n].dtype == np.float32
        np.testing.assert_array_equal(
            bits(jnp.asarray(back[n]).astype(jnp.bfloat16)), bits(a))


def test_float16_and_module_bf16_multi_precision_raise():
    # float16 trains the transformer (tests/test_torch_fit_f16.py) and,
    # with the float16 forms of rows 7 and 10, ResNet
    # (tests/test_torch_resnet_f16.py): its symbol, TrainStep on it and
    # an f16 bind of its graph now build
    assert "cast_embed" in transformer.get_symbol(
        **dict(LM, dtype="float16")).tojson()
    assert "cast_data" in resnet.get_symbol(
        **dict(RESNET18, dtype="float16")).tojson()
    sym = resnet.get_symbol(**dict(RESNET18, dtype="float32"))
    ts = TrainStep(sym, mx.optimizer.SGD(), dtype="float16", ctx=mx.cpu(),
                   data_shapes={"data": (1, 3, 32, 32)})
    assert ts._exe.arg_dict["data"]._data.dtype == torch.float16
    exe = sym.simple_bind(ctx=mx.cpu(), type_dict={"data": "float16"},
                          data=(1, 3, 32, 32), softmax_label=(1,))
    assert exe.arg_dict["conv0_weight"]._data.dtype == torch.float16
    w = mx.nd.array(np.ones(4, np.float32), ctx=mx.cpu()).astype("float16")
    mom, w32 = mx.optimizer.SGD(
        momentum=0.9, multi_precision=True).create_state_multi_precision(0, w)
    assert mom._data.dtype == w32._data.dtype == torch.float32
    # Module binds the bf16 symbol's weights in bf16 and, since bf16
    # Module.fit is ported, trains them through f32 masters under
    # multi_precision; so does a float16 weight in the updater
    mod = mx.Module(resnet.get_symbol(**RESNET18), context=mx.cpu())
    rng = np.random.RandomState(0)
    it = mx.io.NDArrayIter(rng.rand(4, 3, 32, 32).astype(np.float32),
                           np.arange(4).astype(np.float32), batch_size=4)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mx.init.Xavier())
    before = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1,
                              "multi_precision": True})
    after = mod.get_params()[0]
    assert all(v._data.dtype == torch.bfloat16 for v in after.values())
    assert any(not np.array_equal(before[k], v.asnumpy())
               for k, v in after.items())
    inner, w32 = mod._updater.states[0]
    assert inner is None and w32._data.dtype == torch.float32
    assert mod._fused_fit is not None and mod._fused_fit.launches == 1
    assert mod._loss_scaler is not None
    mod._updater("f16", w, w)
    inner, w32 = mod._updater.states["f16"]
    assert inner is None and w32._data.dtype == torch.float32
    assert w._data.dtype == torch.float16
