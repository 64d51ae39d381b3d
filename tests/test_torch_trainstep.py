"""PyTorch port: ``parallel.TrainStep`` on the channel-last ResNet, with
and without the BN -> ReLU -> Conv1x1 fusion pass, against the JAX
package's ``TrainStep`` on the CPU.

Both packages start from the same numpy parameters and moving
statistics and take the same numpy batches.  The JAX side runs the
fused sites' Pallas kernel in interpret mode
(``MXTPU_FUSED_PALLAS=interpret``, set for the whole test because the
JAX package reads it when it traces the step) and every fused run
asserts that the kernel's launch counter rose by the number of fused
sites: the counter moves once per site when the step is traced, so the
Pallas body ran and not the jnp path, which the JAX package takes when
a site's row count is not a multiple of 128 (here 2048, 512 and 128).
After steps, parameters, moving statistics and outputs are held within
1e-4 of each array's largest value, the bound of
tests/test_torch_vision.py's Module.fit comparison (sums taken in
another order, compounded over the steps).  The two packages'
gradients agree within ~1e-5 of each array's largest value; Adam,
AdaGrad, RMSProp and Signum divide by a running magnitude of the
gradient, which turns that into an O(lr) difference where a gradient is
near zero, so for them the parameters are compared where every step's
gradient is at least 1% of its array's largest one, and those elements
must be at least half of all parameter elements.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.pallas.dispatch import PALLAS_LAUNCHES
from mxnet_tpu.parallel.trainer import TrainStep as JTrainStep
from mxnet_tpu.symbol.fuse import fuse_conv_bn as jfuse_conv_bn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.symbol.fuse import count_fused, fuse_conv_bn
from mxnet_tpu_torch.weights import symbol_shapes

B = 2
IMAGE = (32, 32, 3)
_KERNEL = "fused_scale_relu_matmul"
# a bottleneck ResNet small enough for the CPU: every fused site's row
# count (B*32*32, B*16*16, B*8*8) is a multiple of 128; stage 1's second
# unit gives a fused site without a residual
NET = dict(units=[2, 1, 1], num_stages=3, filter_list=[8, 32, 64, 128],
           num_classes=10, image_shape=(3, 32, 32), bottle_neck=True,
           layout="NHWC")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_PALLAS", "interpret")


def _symbols(fused):
    sym, jsym = resnet.resnet(**NET), jresnet.resnet(**NET)
    if fused:
        sym, jsym = fuse_conv_bn(sym), jfuse_conv_bn(jsym)
    return sym, jsym


def _weights(sym, seed=11):
    """He-normal weights, BatchNorm scales near one, moving statistics
    near (0, 1)."""
    args, auxs = symbol_shapes(sym, data=(B,) + IMAGE, softmax_label=(B,))
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in args.items():
        z = rng.randn(*s).astype(np.float32)
        if n.endswith("_gamma"):
            out[n] = 1 + 0.1 * z
        elif n.endswith(("_beta", "_bias")):
            out[n] = 0.1 * z
        else:
            out[n] = z * np.float32(np.sqrt(2.0 / np.prod(s[1:])))
    aux = {n: (1 + np.abs(0.2 * rng.randn(*s))).astype(np.float32)
           if n.endswith("_var") else (0.2 * rng.randn(*s)).astype(np.float32)
           for n, s in auxs.items()}
    return out, aux


def _batches(n, seed=13):
    rng = np.random.RandomState(seed)
    return [{"data": rng.uniform(-1, 1, (B,) + IMAGE).astype(np.float32),
             "softmax_label": rng.randint(0, 10, B).astype(np.float32)}
            for _ in range(n)]


def _run(sym, jsym, make_opt, steps, args, auxs, batches):
    """The same steps through both packages: ``(port, jax)``, each
    ``(params, auxs, outputs per step)`` as numpy, and the port's
    gradients of every step."""
    shapes = dict(data_shapes={"data": (B,) + IMAGE},
                  label_shapes={"softmax_label": (B,)})
    res, grads = [], []
    for pkg in (jmx, mx):
        if pkg is jmx:
            ts = JTrainStep(jsym, make_opt(pkg), **shapes)
        else:
            ts = TrainStep(sym, make_opt(pkg), ctx=mx.cpu(), **shapes)
        ts.init_params(pkg.init.Xavier(), arg_params=args, aux_params=auxs)
        outs = []
        for i in range(steps):
            out = ts.step(batches[i % len(batches)])
            if pkg is jmx:
                outs.append([np.asarray(o) for o in out])
            else:
                outs.append([o.numpy() for o in out])
                grads.append({n: g.numpy().copy()
                              for n, g in ts.grads.items()})
        res.append(({n: np.asarray(v) for n, v in ts.params.items()},
                    {n: np.asarray(v) for n, v in ts.auxs.items()}, outs))
    return res[1], res[0], grads


def _check(port, ref, grads=None):
    """``grads`` (the port's, per step): compare each parameter only
    where every step's gradient is at least 1% of the array's largest,
    and require that to be at least half of all parameter elements."""
    (pp, pa, po), (jp, ja, jo) = port, ref
    assert sorted(pp) == sorted(jp) and sorted(pa) == sorted(ja)
    kept = total = 0
    for kind, got, want in (("param", pp, jp), ("aux", pa, ja)):
        for name in want:
            keep = np.ones(want[name].shape, bool)
            for g in (grads or []) if kind == "param" else []:
                keep &= np.abs(g[name]) >= 1e-2 * np.abs(g[name]).max()
            if kind == "param":
                kept, total = kept + keep.sum(), total + keep.size
            np.testing.assert_allclose(
                got[name][keep], want[name][keep], rtol=0,
                atol=1e-4 * np.abs(want[name]).max(),
                err_msg="%s %s" % (kind, name))
    assert kept >= total / 2, (kept, total)
    for step, (g, w) in enumerate(zip(po, jo)):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-4 * np.abs(b).max(),
                                       err_msg="outputs of step %d" % step)


@pytest.mark.parametrize("fused", [False, True])
def test_trainstep_sgd_matches_jax(fused):
    """Three SGD steps (momentum 0.9, wd 1e-4) over two batches, fused
    and unfused: parameters, moving statistics and every step's outputs.
    The fused port runs the kernel's plain version once per site per
    step; the JAX launch counter rises by the site count at the trace."""
    sym, jsym = _symbols(fused)
    sites = count_fused(sym)
    assert sites == (5 if fused else 0)
    args, auxs = _weights(sym)
    before = PALLAS_LAUNCHES.labels(kernel=_KERNEL).value
    reset_counts()
    port, ref, _ = _run(sym, jsym, lambda pkg: pkg.optimizer.SGD(
        learning_rate=0.05, momentum=0.9, wd=1e-4), 3, args, auxs,
        _batches(2))
    # once per site each time the JAX step is traced
    rose = PALLAS_LAUNCHES.labels(kernel=_KERNEL).value - before
    assert (rose > 0 and rose % sites == 0) if fused else rose == 0
    assert PLAIN_CALLS[_KERNEL] == 3 * sites and LAUNCHES[_KERNEL] == 0
    _check(port, ref)
    # every parameter moved (bn_data_gamma, fixed, by weight decay only)
    assert all(np.abs(port[0][n] - args[n]).max() > 0 for n in args)


def _adagrad(pkg):
    # eps 1e-3: the update's slope in g is at most lr / sqrt(eps) = 1.6,
    # so the comparison sees the arithmetic and not the gradients' last
    # bits (at the default 1e-7 it is 158)
    opt = pkg.optimizer.AdaGrad(learning_rate=0.05, eps=1e-3, wd=1e-4)
    if pkg is jmx:
        # the JAX TrainStep reads ``eps``, which its AdaGrad stores as
        # ``float_stable_eps`` only (a reference-side fault; ROADMAP C)
        opt.eps = opt.float_stable_eps
    return opt


@pytest.mark.parametrize("name,make_opt", [
    ("adam", lambda pkg: pkg.optimizer.Adam(learning_rate=0.01, wd=1e-4)),
    ("rmsprop_centered", lambda pkg: pkg.optimizer.RMSProp(
        learning_rate=0.005, centered=True, wd=1e-4)),
    ("signum", lambda pkg: pkg.optimizer.Signum(learning_rate=0.01,
                                                momentum=0.9, wd=1e-4,
                                                wd_lh=1e-3)),
    ("adagrad", _adagrad)])
def test_trainstep_optimizers_match_jax(name, make_opt):
    """Two fused steps with each other optimizer TrainStep supports:
    Adam (bias correction folded into lr with one global step count),
    centered RMSProp, Signum and AdaGrad."""
    sym, jsym = _symbols(True)
    args, auxs = _weights(sym, seed=17)
    port, ref, grads = _run(sym, jsym, make_opt, 2, args, auxs,
                            _batches(1, 19))
    _check(port, ref, grads)


def test_unused_parameter_gets_zero_gradient_and_weight_decay():
    """A fused site with ``fix_gamma`` (BatchNorm's default) does not
    use gamma: autograd gives it no gradient, and TrainStep updates it
    with a zero one, so weight decay still shrinks it, as the JAX
    package's vjp zeros do."""
    def net(pkg, fuse):
        data = pkg.sym.Variable("data")
        body = pkg.sym.Activation(pkg.sym.BatchNorm(data, axis=3, name="bn"),
                                  act_type="relu")
        body = pkg.sym.Convolution(body, num_filter=6, kernel=(1, 1),
                                   no_bias=True, layout="NHWC", name="conv")
        out = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            pkg.sym.Flatten(body), num_hidden=10, name="fc"), name="softmax")
        return fuse(out)

    sym, jsym = net(mx, fuse_conv_bn), net(jmx, jfuse_conv_bn)
    assert count_fused(sym) == 1
    args, auxs = _weights(sym, seed=23)
    port, ref, _ = _run(sym, jsym, lambda pkg: pkg.optimizer.SGD(
        learning_rate=0.1, momentum=0.9, wd=0.05), 2, args, auxs,
        _batches(1, 29))
    _check(port, ref)
    w, mom = 1.0, 0.0                      # SGD momentum on g = wd * w
    for _ in range(2):
        mom = 0.9 * mom - 0.1 * 0.05 * w
        w += mom
    np.testing.assert_allclose(port[0]["bn_gamma"], args["bn_gamma"] * w,
                               rtol=1e-5)


def test_trainstep_init_and_contract(monkeypatch):
    """``init_params``: given arrays take precedence, the rest draw on
    the device from the seeded generator (reproducibly), a custom
    initializer fills on the host; ``get_params`` returns host copies;
    no context on a host without a GPU, a mesh, bf16 and a step before
    ``init_params`` raise."""
    sym, _ = _symbols(True)
    shapes = dict(data_shapes={"data": (B,) + IMAGE},
                  label_shapes={"softmax_label": (B,)})
    args, auxs = _weights(sym)

    def init(initializer, **given):
        ts = TrainStep(sym, mx.optimizer.SGD(learning_rate=0.1),
                       ctx=mx.cpu(), **shapes)
        mx.random.seed(5)
        ts.init_params(initializer, **given)
        return ts

    given = {"conv0_weight": args["conv0_weight"]}
    a, b = (init(mx.init.Xavier(), arg_params=given) for _ in range(2))
    np.testing.assert_array_equal(a.params["conv0_weight"].numpy(),
                                  args["conv0_weight"])
    name = "stage1_unit1_conv1_weight"
    np.testing.assert_array_equal(a.params[name].numpy(),
                                  b.params[name].numpy())
    assert float(a.auxs["bn1_moving_var"].min()) == 1.0

    class Fives(mx.init.Xavier):
        def _init_weight(self, desc, arr):
            arr[:] = 5.0

    c = init(Fives(), aux_params=auxs)
    assert float(c.params[name].min()) == 5.0
    np.testing.assert_array_equal(c.auxs["bn1_moving_mean"].numpy(),
                                  auxs["bn1_moving_mean"])
    got_args, got_auxs = c.get_params()
    assert got_args[name].context == mx.cpu()
    assert sorted(got_auxs) == sorted(auxs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        TrainStep(sym, mx.optimizer.SGD(), **shapes)     # gpu(0) by default
    with pytest.raises(mx.MXNetError, match="multi-GPU"):
        TrainStep(sym, mx.optimizer.SGD(), mesh=object(), ctx=mx.cpu(),
                  **shapes)
    with pytest.raises(mx.MXNetError, match="bf16"):
        TrainStep(sym, mx.optimizer.SGD(), dtype="bfloat16", ctx=mx.cpu(),
                  **shapes)
    with pytest.raises(mx.MXNetError, match="init_params"):
        TrainStep(sym, mx.optimizer.SGD(), ctx=mx.cpu(), **shapes).step(
            _batches(1)[0])


@pytest.mark.parametrize("name,kw", [
    ("signum", dict(learning_rate=0.01, momentum=0.9, wd=0.01, wd_lh=1e-3)),
    ("signum", dict(learning_rate=0.01, momentum=0.0, wd=0.01)),
    ("adagrad", dict(learning_rate=0.05, wd=0.01, clip_gradient=1.0)),
    ("rmsprop", dict(learning_rate=0.01, wd=0.01, clip_weights=0.6)),
    ("rmsprop", dict(learning_rate=0.01, wd=0.01, centered=True,
                     rescale_grad=0.5))])
def test_optimizer_updates_match_jax(name, kw):
    """The eager ``Optimizer.update`` of each optimizer this slice adds
    (Signum with momentum and as signSGD, AdaGrad, RMSProp plain with
    clipped weights and centered) on the same weights and three
    gradients as the JAX package's: the same f32 arithmetic, so rtol
    2e-6 (one rounding of a fused multiply-add)."""
    rng = np.random.RandomState(31)
    w0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) for _ in range(3)]
    out = []
    for pkg in (jmx, mx):
        arr = (lambda a: pkg.nd.array(a)) if pkg is jmx else \
            (lambda a: mx.nd.array(a, ctx=mx.cpu()))
        opt = pkg.optimizer.create(name, **kw)
        weight = arr(w0)
        state = opt.create_state(0, weight)
        for g in grads:
            opt.update(0, weight, arr(g), state)
        out.append(weight.asnumpy())
    np.testing.assert_allclose(out[1], out[0], rtol=2e-6, atol=1e-7)
    assert np.abs(out[1] - w0).max() > 1e-3
