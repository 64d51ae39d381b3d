"""PyTorch port: the vision slice (Convolution, BatchNorm, Pooling,
Activation, Flatten, the LeNet and ResNet symbols, Module.fit with
auxiliary states and the kvstore, a 2-bit compressed update) against
the JAX package on the CPU.

Every comparison feeds the same numpy inputs and weights to both
packages.  The JAX side runs its eager Module path (``MXNET_FIT_FUSED=0``:
fwd_bwd, then the bucketed kvstore), the path this slice ports, with its
Pallas quantizer in interpret mode (``MXNET_Q2BIT_IMPL=pallas``).
Tolerances are stated per test.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.models import lenet as jlenet
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import lenet, resnet
from mxnet_tpu_torch.ops.registry import get_op
from mxnet_tpu_torch.weights import convert_symbol_params, symbol_shapes

RTOL, ATOL = 2e-5, 1e-6
B = 4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The tensors here are small and gain nothing from many intra-op
    threads; two keep this file off the cores that timing-sensitive
    tests running beside it in other workers measure."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_eager_path(monkeypatch):
    monkeypatch.setenv("MXNET_FIT_FUSED", "0")
    monkeypatch.setenv("MXNET_Q2BIT_IMPL", "pallas")


def _jax_op(name, ins, attrs, is_train, cot):
    """Outputs of the JAX op and the cotangents of its differentiable
    inputs (``cot`` seeds output 0)."""
    fn = jreg.get_op(name).fn
    n_diff = len(ins) if name != "BatchNorm" else 3

    def f(*diff):
        with jreg._OpCtxScope(is_train, jax.random.key(0)):
            out = fn(*diff, *[jnp.asarray(a) for a in ins[n_diff:]], **attrs)
        return out

    outs, vjp = jax.vjp(f, *[jnp.asarray(a) for a in ins[:n_diff]])
    single = not isinstance(outs, (tuple, list))
    first = outs if single else outs[0]
    cts = jnp.asarray(cot) if single else \
        (jnp.asarray(cot),) + tuple(jnp.zeros_like(o) for o in outs[1:])
    grads = vjp(cts)
    outs = [outs] if single else list(outs)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads], \
        np.asarray(first)


def _port_op(name, ins, attrs, is_train, cot):
    op = get_op(name)
    n_diff = len(ins) if name != "BatchNorm" else 3
    ts = [torch.from_numpy(np.array(a)) for a in ins]
    for t in ts[:n_diff]:
        t.requires_grad_()
    kw = dict(attrs, is_train=is_train) if op.takes_is_train else attrs
    outs = op.fn(*ts, **kw)
    outs = list(outs) if isinstance(outs, tuple) else [outs]
    grads = torch.autograd.grad(outs[0], ts[:n_diff], torch.from_numpy(cot),
                                allow_unused=True)
    grads = [np.zeros(t.shape, np.float32) if g is None else g.numpy()
             for g, t in zip(grads, ts)]
    return [o.detach().numpy() for o in outs], grads


def _cot(rng, name, ins, attrs, is_train):
    fn = jreg.get_op(name).fn
    with jreg._OpCtxScope(is_train, jax.random.key(0)):
        out = fn(*[jnp.asarray(a) for a in ins], **attrs)
    out = out[0] if isinstance(out, (tuple, list)) else out
    return rng.randn(*out.shape).astype(np.float32)


def _compare(name, ins, attrs, is_train=True):
    """Forward outputs and input gradients, port against JAX, at rtol
    2e-5 and an atol of 1e-6 times the array's largest magnitude (at
    least 1): a weight gradient sums over every output position, in
    another order, and its small elements carry the rounding of the
    large terms."""
    cot = _cot(np.random.RandomState(1), name, ins, attrs, is_train)
    jouts, jgrads, _ = _jax_op(name, ins, attrs, is_train, cot)
    outs, grads = _port_op(name, ins, attrs, is_train, cot)
    assert len(outs) == len(jouts)
    for kind, got, ref in (("output", outs, jouts),
                           ("input grad", grads, jgrads)):
        for i, (a, b) in enumerate(zip(got, ref)):
            atol = ATOL * max(1.0, float(np.abs(b).max()) if b.size else 0)
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol,
                                       err_msg="%s %s %d" % (name, kind, i))


def _r(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# ----------------------------------------------------------------------
# ops, forward and backward (rtol 2e-5 / atol 1e-6)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["stem", "grouped_dilated", "bias_1x1"])
def test_convolution_matches_jax(case):
    """The ImageNet stem (7x7, stride 2, pad 3), a grouped and dilated
    3x3 with a bias, and a strided 1x1 with a bias."""
    rng = np.random.RandomState(3)
    if case == "stem":
        x, w = _r(rng, 2, 3, 20, 20), _r(rng, 8, 3, 7, 7, scale=0.1)
        ins, attrs = [x, w], dict(kernel=(7, 7), num_filter=8, stride=(2, 2),
                                  pad=(3, 3), no_bias=True)
    elif case == "grouped_dilated":
        x, w = _r(rng, 2, 4, 11, 9), _r(rng, 6, 2, 3, 3, scale=0.2)
        ins = [x, w, _r(rng, 6)]
        attrs = dict(kernel=(3, 3), num_filter=6, num_group=2,
                     dilate=(2, 1), pad=(2, 1))
    else:
        x, w = _r(rng, 2, 5, 8, 8), _r(rng, 7, 5, 1, 1, scale=0.3)
        ins = [x, w, _r(rng, 7)]
        attrs = dict(kernel=(1, 1), num_filter=7, stride=(2, 2))
    _compare("Convolution", ins, attrs)


@pytest.mark.parametrize("is_train,fix_gamma,use_global", [
    (True, False, False), (True, True, False), (False, False, False),
    (True, False, True)])
def test_batchnorm_matches_jax(is_train, fix_gamma, use_global):
    """Train mode (batch statistics, moving statistics moved by the
    momentum, biased variance), fix_gamma (zero dgamma), eval mode and
    use_global_stats (the moving statistics normalize): all five outputs
    and dx, dgamma, dbeta."""
    rng = np.random.RandomState(5)
    C = 6
    x = _r(rng, 4, C, 5, 3, scale=2.0) + 0.5
    ins = [x, 1 + _r(rng, C, scale=0.2), _r(rng, C, scale=0.2),
           _r(rng, C, scale=0.3), 1 + np.abs(_r(rng, C, scale=0.3))]
    attrs = dict(eps=2e-5, momentum=0.9, fix_gamma=fix_gamma,
                 use_global_stats=use_global)
    _compare("BatchNorm", ins, attrs, is_train=is_train)


@pytest.mark.parametrize("case", ["max_stem", "max_full", "avg_global",
                                  "avg_excl_pad", "sum", "max_global"])
def test_pooling_matches_jax(case):
    """Max 3x3/s2/p1 over ReLU outputs (windows tie at 0: the first
    maximum takes the gradient, as XLA's select-and-scatter gives it),
    the 'full' convention, global average and max, average without the
    padding in the count, and sum."""
    rng = np.random.RandomState(7)
    x = np.maximum(_r(rng, 2, 3, 9, 11) - 1.0, 0)     # 84% zeros: ties
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
        x = _r(rng, 2, 3, 9, 11)           # no ties for a global max
    _compare("Pooling", [x], attrs)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation_matches_jax(act):
    rng = np.random.RandomState(9)
    _compare("Activation", [_r(rng, 3, 4, 5, scale=3.0)], dict(act_type=act))


def test_flatten_matches_jax():
    _compare("Flatten", [_r(np.random.RandomState(1), 2, 3, 4, 5)], {})


# ----------------------------------------------------------------------
# symbols
# ----------------------------------------------------------------------
@pytest.mark.parametrize("net,kw,shape", [
    ("resnet", dict(num_classes=10, num_layers=8, image_shape=(3, 28, 28)),
     (B, 3, 28, 28)),
    ("resnet", dict(num_classes=1000, num_layers=50,
                    image_shape=(3, 224, 224)), (B, 3, 224, 224)),
    ("resnet", dict(num_classes=10, num_layers=18, image_shape=(3, 64, 64),
                    version=1), (B, 3, 64, 64)),
    ("lenet", dict(num_classes=10), (B, 1, 28, 28))])
def test_symbols_match_jax(net, kw, shape):
    """The same argument and auxiliary-state names, in the same order,
    with the same inferred shapes, and the same outputs."""
    jsym = {"resnet": jresnet, "lenet": jlenet}[net].get_symbol(**kw)
    sym = mx.models.get_symbol(net, **kw)
    assert sym.list_arguments() == jsym.list_arguments()
    assert sym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert sym.list_outputs() == jsym.list_outputs()
    ja, jo, jx = jsym.infer_shape(data=shape)
    a, o, x = sym.infer_shape(data=shape)
    for got, ref in ((a, ja), (o, jo), (x, jx)):
        assert [tuple(s) for s in got] == [tuple(s) for s in ref]
    if kw.get("num_layers") == 50:
        args, auxs = symbol_shapes(sym, data=shape, softmax_label=(B,))
        assert len(args) == 157 and len(auxs) == 102
        assert sum(int(np.prod(s)) for s in args.values()) == 25549486


# ----------------------------------------------------------------------
# Module
# ----------------------------------------------------------------------
_NETS = {
    "resnet8": (lambda pkg: (jresnet if pkg is jmx else resnet).get_symbol(
        num_classes=10, num_layers=8, image_shape=(3, 28, 28)), (3, 28, 28)),
    "lenet": (lambda pkg: (jlenet if pkg is jmx else lenet).get_symbol(
        num_classes=10), (1, 28, 28)),
}


def _weights(sym, image, seed=11):
    """Numpy weights and moving statistics for ``sym``: He-normal
    convolutions and layers, BatchNorm scales near one."""
    args, auxs = symbol_shapes(sym, data=(B,) + image, softmax_label=(B,))
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in args.items():
        if n.endswith("_gamma"):
            out[n] = 1 + _r(rng, *s, scale=0.1)
        elif n.endswith(("_beta", "_bias")):
            out[n] = _r(rng, *s, scale=0.1)
        else:
            out[n] = _r(rng, *s, scale=np.sqrt(2.0 / np.prod(s[1:])))
    aux = {n: (1 + np.abs(_r(rng, *s, scale=0.2))) if n.endswith("_var")
           else _r(rng, *s, scale=0.2) for n, s in auxs.items()}
    return out, aux


def _images(image, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n,) + image).astype(np.float32),
            rng.randint(0, 10, n).astype(np.float32))


def _module(pkg, net, ctx, **kw):
    return pkg.mod.Module(_NETS[net][0](pkg), context=ctx, **kw)


@pytest.mark.parametrize("net,store", [("resnet8", True), ("lenet", False)])
def test_module_fit_matches_jax(net, store):
    """Module.fit over 2 epochs of 3 batches (SGD with momentum and wd,
    accuracy and cross-entropy) from the same numpy weights and moving
    statistics, ResNet-8 through a dense device kvstore, LeNet through
    the local updater: the final parameters within 1e-4 of each one's
    largest value (six steps of sums in another order, as
    test_torch_train's fit), the moving statistics likewise, and the
    last epoch's metrics within rtol 1e-5."""
    image = _NETS[net][1]
    args, auxs = _weights(_NETS[net][0](mx), image)
    x, y = _images(image, 3 * B, 13)
    res = []
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        arr = (lambda a: pkg.nd.array(a)) if pkg is jmx else \
            (lambda a: mx.nd.array(a, ctx=mx.cpu()))
        mod = _module(pkg, net, ctx)
        metric = pkg.metric.create(["acc", "ce"])
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=B), num_epoch=2,
                kvstore=pkg.kv.create("device") if store else "local",
                optimizer="sgd", eval_metric=metric,
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                                  "wd": 1e-4},
                arg_params={k: arr(v) for k, v in args.items()},
                aux_params={k: arr(v) for k, v in auxs.items()})
        a, b = mod.get_params()
        res.append(({k: v.asnumpy() for k, v in a.items()},
                    {k: v.asnumpy() for k, v in b.items()}, metric.get()))
    (ja, jx, jm), (pa, px, pm) = res
    assert sorted(pa) == sorted(ja) and sorted(px) == sorted(jx)
    for ref, got in ((ja, pa), (jx, px)):
        for name in ref:
            np.testing.assert_allclose(got[name], ref[name], rtol=0,
                                       atol=1e-4 * np.abs(ref[name]).max(),
                                       err_msg=name)
    assert any(np.abs(pa[n] - args[n]).max() > 1e-4 for n in args)
    if auxs:
        assert all(np.abs(px[n] - auxs[n]).max() > 1e-4 for n in auxs)
    assert pm[0] == jm[0]
    np.testing.assert_allclose(pm[1], jm[1], rtol=1e-5)


def test_compressed_update_matches_jax():
    """One forward/backward and one 2-bit Module.update of ResNet-8
    through a device kvstore instance, from the same weights, threshold
    the median of |g|: q, so the updated weights (within _ULP_RTOL, the
    update's FMA contraction), agree wherever the JAX gradient lies
    farther than 1e-4 * t from t; the elements inside that band (where
    a last-bit difference in the gradient may flip q) are counted, and
    stay a small share."""
    image = _NETS["resnet8"][1]
    args, auxs = _weights(_NETS["resnet8"][0](mx), image)
    x, y = _images(image, B, 17)
    opt = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}

    def run(pkg, ctx, comp):
        arr = (lambda a: pkg.nd.array(a)) if pkg is jmx else \
            (lambda a: mx.nd.array(a, ctx=mx.cpu()))
        mod = _module(pkg, "resnet8", ctx, compression_params=comp)
        mod.bind(data_shapes=[("data", (B,) + image)],
                 label_shapes=[("softmax_label", (B,))])
        mod.set_params({k: arr(v) for k, v in args.items()},
                       {k: arr(v) for k, v in auxs.items()})
        kv = pkg.kv.create("device")
        mod.init_optimizer(kvstore=kv, optimizer="sgd", optimizer_params=opt)
        batch = pkg.io.DataBatch(data=[arr(x)], label=[arr(y)])
        mod.forward_backward(batch)
        grads = {n: g[0].asnumpy() for n, g in
                 zip(mod._exec_group.param_names,
                     mod._exec_group.grad_arrays)}
        mod.update()
        return grads, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    g0, _ = run(jmx, jmx.cpu(), None)
    t = float(np.median(np.abs(np.concatenate([g.ravel()
                                               for g in g0.values()]))))
    comp = {"type": "2bit", "threshold": t}
    jg, jw = run(jmx, jmx.cpu(), comp)
    pg, pw = run(mx, mx.cpu(), comp)
    band = compared = 0
    for name, ref in jw.items():
        near = np.abs(np.abs(jg[name]) - np.float32(t)) <= 1e-4 * t
        band += int(near.sum())
        compared += near.size
        np.testing.assert_allclose(pw[name][~near], ref[~near], rtol=5e-7,
                                   atol=5e-7, err_msg=name)
        np.testing.assert_allclose(pg[name], jg[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    # expected ~0.9e-4 for a bell-shaped |g| at its median: a handful of
    # the 78k elements here
    assert band / compared < 1e-3, (band, compared)
    moved = sum(int((pw[n] != args[n]).sum()) for n in pw)
    assert moved > compared // 4


def test_module_rejects_later_slices():
    """Several contexts and the distributed, 'tpu' and 'nccl' stores each
    raise, naming their slice; the float16 symbol, which raised until
    ROADMAP A.1's float16 for rows 7 and 10, builds; channel-last (NHWC)
    training, which the channel-last slice brought, binds and runs
    forward."""
    sym = resnet.get_symbol(num_classes=10, num_layers=8,
                            image_shape=(3, 28, 28))
    with pytest.raises(mx.MXNetError, match="multi-GPU"):
        mx.Module(sym, context=[mx.cpu(), mx.cpu(1)])
    x, y = _images((3, 28, 28), B, 2)
    mod = mx.Module(sym, context=mx.cpu())
    for kv in ("dist_sync", "dist_device_sync", "tpu", "nccl"):
        with pytest.raises(mx.MXNetError, match="multi-GPU"):
            mod.fit(mx.io.NDArrayIter(x, y, batch_size=B), num_epoch=1,
                    kvstore=kv, force_init=True)
    # float16 ResNet training is ported (ROADMAP A.1, float16 for rows 7
    # and 10; tests/test_torch_resnet_f16.py): the symbol builds
    assert "cast_data" in resnet.get_symbol(
        num_classes=10, num_layers=8, image_shape=(3, 28, 28),
        dtype="float16").tojson()
    nhwc = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(mx.sym.Flatten(
        mx.sym.Convolution(mx.sym.Variable("data"), kernel=(3, 3),
                           num_filter=4, layout="NHWC")), num_hidden=10),
        name="softmax")
    mod = mx.Module(nhwc, context=mx.cpu())
    mod.bind(data_shapes=[("data", (B, 28, 28, 3))],
             label_shapes=[("softmax_label", (B,))])
    mod.init_params()
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(
        np.zeros((B, 28, 28, 3)), ctx=mx.cpu())], label=None))
    assert mod.get_outputs()[0].shape == (B, 10)


def test_convert_symbol_params_checks_names_and_shapes():
    sym = lenet.get_symbol()
    args, _ = symbol_shapes(sym, data=(B, 1, 28, 28), softmax_label=(B,))
    good = {n: np.zeros(s, np.float32) for n, s in args.items()}
    a, x = convert_symbol_params(good, {}, mx.cpu(), sym,
                                 data=(B, 1, 28, 28), softmax_label=(B,))
    assert sorted(a) == sorted(args) and x == {}
    with pytest.raises(mx.MXNetError, match="missing"):
        convert_symbol_params({}, {}, mx.cpu(), sym, data=(B, 1, 28, 28),
                              softmax_label=(B,))
    bad = dict(good, conv1_weight=np.zeros((1, 1), np.float32))
    with pytest.raises(mx.MXNetError, match="conv1_weight"):
        convert_symbol_params(bad, {}, mx.cpu(), sym, data=(B, 1, 28, 28),
                              softmax_label=(B,))
