"""PyTorch port: Gluon (layers, losses, deferred initialization and
parameter names, Trainer dense and 2-bit, hybridization, model-zoo
ResNet-18 v2) against the JAX package's Gluon on the CPU.

Each block is built in a fresh name scope in both packages (so the
names agree), the JAX block is initialized and run once, and its
parameters are carried into the port's by name
(``weights.gluon_params_from_numpy``).  Forward outputs and gradients
are compared at rtol 2e-5 and an atol of 1e-6 times the array's largest
magnitude (at least 1): a weight gradient sums over every output
position in another order.  The port's hybridized path must equal its
eager path exactly (the same ops on the same tensors).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.base import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import NameManager
from mxnet_tpu_torch.weights import gluon_params_from_numpy

RTOL, ATOL = 2e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_quantizer(monkeypatch):
    monkeypatch.setenv("MXNET_Q2BIT_IMPL", "pallas")


def _r(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _arr(pkg, a):
    return pkg.nd.array(a) if pkg is jmx else mx.nd.array(a, ctx=mx.cpu())


def _np(x):
    return np.asarray(x.asnumpy())


def _assert_close(got, ref, what=""):
    got, ref = _np(got) if hasattr(got, "asnumpy") else got, \
        _np(ref) if hasattr(ref, "asnumpy") else ref
    atol = ATOL * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol, err_msg=what)


def _build(factory):
    """(JAX block, port block), each built in a fresh name scope."""
    with JNameManager():
        jb = factory(jmx)
    with NameManager():
        pb = factory(mx)
    return jb, pb


# parameters the initializers set to a constant (zeros or ones): carried
# as the port's initializer made them; every other parameter is drawn
_CONSTANT_PARAMS = ("_bias", "_beta", "_gamma", "_moving_mean",
                    "_running_mean", "_moving_var", "_running_var")


def _carry(jb, pb, inputs, seed=0):
    """Finish the port block's deferred initialization (one forward, for
    the shapes), draw every parameter that is not a constant with numpy
    from ``RandomState(seed)`` (Xavier-uniform, magnitude 3 over the
    mean of the fans, as ``mx.init.Xavier()``), and carry the same
    arrays into both blocks by name; returns them as numpy.  No weight
    comes from the port's own random streams, which are unseeded."""
    pb.initialize(mx.init.Xavier(), ctx=mx.cpu())
    pb(*[_arr(mx, a) for a in inputs])
    rng = np.random.RandomState(seed)
    arrays = {}
    for k, p in pb.collect_params().items():
        a = _np(p.data())
        if not k.endswith(_CONSTANT_PARAMS):
            hw = int(np.prod(a.shape[2:]))
            scale = np.sqrt(3.0 / ((a.shape[0] + a.shape[1]) * hw / 2.0))
            a = rng.uniform(-scale, scale, a.shape).astype(np.float32)
        arrays[k] = a
    gluon_params_from_numpy(pb, arrays)
    jb.initialize()
    for k, p in jb.collect_params().items():
        p.set_data(jmx.nd.array(arrays[k]))
    return arrays


def _run(pkg, block, inputs, n_diff, dy, train=True, hybrid=False):
    """Output, input gradients and parameter gradients of one recorded
    forward, seeded with ``dy``."""
    if hybrid:
        block.hybridize()
    ins = [_arr(pkg, a) for a in inputs]
    for x in ins[:n_diff]:
        x.attach_grad()
    with pkg.autograd.record(train_mode=train):
        out = block(*ins)
    out.backward(_arr(pkg, dy))
    params = {k: p for k, p in block.collect_params().items()}
    grads = {k: _np(p.grad()) for k, p in params.items()
             if p.grad_req != "null"}
    stats = {k: _np(p.data()) for k, p in params.items()
             if p.grad_req == "null"}
    return _np(out), [_np(x.grad) for x in ins[:n_diff]], grads, stats


def _compare_block(factory, inputs, n_diff=1, train=True):
    """The JAX block (hybridized: one compiled program, the JAX
    package's fast path to the same ops) against the port's eager
    block; the port's hybridized block against its eager one, exactly,
    from the same parameters."""
    jb, pb = _build(factory)
    start = _carry(jb, pb, inputs)
    out = _np(pb(*[_arr(mx, a) for a in inputs]))
    dy = _r(np.random.RandomState(99), *out.shape)
    ref = _run(jmx, jb, inputs, n_diff, dy, train, hybrid=True)
    runs = []
    for hybrid in (False, True):
        with NameManager():
            block = factory(mx)
        block.initialize(ctx=mx.cpu())
        gluon_params_from_numpy(block, start)
        runs.append(_run(mx, block, inputs, n_diff, dy, train, hybrid))
    got, hyb = runs
    _assert_close(got[0], ref[0], "output")
    for a, b in zip(got[1], ref[1]):
        _assert_close(a, b, "input grad")
    assert sorted(got[2]) == sorted(ref[2])
    for part in (2, 3):
        for k in ref[part]:
            _assert_close(got[part][k], ref[part][k], k)
    np.testing.assert_array_equal(hyb[0], got[0])
    for a, b in zip(hyb[1], got[1]):
        np.testing.assert_array_equal(a, b)
    for part in (2, 3):
        for k in got[part]:
            np.testing.assert_array_equal(hyb[part][k], got[part][k])


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
def _seq(pkg):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Conv2D(4, 3, padding=1),
                pkg.gluon.nn.BatchNorm(),
                pkg.gluon.nn.Activation("relu"),
                pkg.gluon.nn.MaxPool2D(2),
                pkg.gluon.nn.Flatten(),
                pkg.gluon.nn.Dense(3))
    return net


_LAYERS = {
    "dense": (lambda p: p.gluon.nn.Dense(5, activation="relu"), (4, 3, 2)),
    "dense_noflat": (lambda p: p.gluon.nn.Dense(5, flatten=False,
                                                use_bias=False), (4, 3, 6)),
    "tanh": (lambda p: p.gluon.nn.Activation("tanh"), (4, 6)),
    "softrelu": (lambda p: p.gluon.nn.Activation("softrelu"), (4, 6)),
    "sigmoid": (lambda p: p.gluon.nn.Activation("sigmoid"), (4, 6)),
    "leaky": (lambda p: p.gluon.nn.LeakyReLU(0.1), (4, 6)),
    "batchnorm": (lambda p: p.gluon.nn.BatchNorm(), (4, 3, 5, 5)),
    "batchnorm_frozen": (lambda p: p.gluon.nn.BatchNorm(scale=False,
                                                        center=False),
                         (4, 3, 5, 5)),
    "layernorm": (lambda p: p.gluon.nn.LayerNorm(), (4, 6)),
    "instancenorm": (lambda p: p.gluon.nn.InstanceNorm(scale=True),
                     (2, 3, 5, 5)),
    "flatten": (lambda p: p.gluon.nn.Flatten(), (2, 3, 4)),
    "conv1d": (lambda p: p.gluon.nn.Conv1D(4, 3, strides=2, padding=1),
               (2, 3, 9)),
    "conv2d": (lambda p: p.gluon.nn.Conv2D(4, (3, 2), strides=(2, 1),
                                           padding=(1, 0), dilation=(1, 2)),
               (2, 3, 7, 8)),
    "conv2d_groups": (lambda p: p.gluon.nn.Conv2D(
        6, 3, groups=3, use_bias=False, activation="relu"), (2, 3, 6, 6)),
    "conv3d": (lambda p: p.gluon.nn.Conv3D(2, 2, in_channels=3),
               (1, 3, 4, 5, 4)),
    "maxpool1d": (lambda p: p.gluon.nn.MaxPool1D(2), (2, 3, 9)),
    "avgpool1d": (lambda p: p.gluon.nn.AvgPool1D(
        3, 2, 1, count_include_pad=False), (2, 3, 9)),
    "maxpool2d": (lambda p: p.gluon.nn.MaxPool2D(3, 2, 1), (2, 3, 7, 7)),
    "avgpool2d": (lambda p: p.gluon.nn.AvgPool2D(2, ceil_mode=True),
                  (2, 3, 7, 7)),
    "maxpool3d": (lambda p: p.gluon.nn.MaxPool3D(2), (1, 2, 4, 4, 6)),
    "avgpool3d": (lambda p: p.gluon.nn.AvgPool3D(2), (1, 2, 4, 4, 6)),
    "globalmax1d": (lambda p: p.gluon.nn.GlobalMaxPool1D(), (2, 3, 9)),
    "globalavg2d": (lambda p: p.gluon.nn.GlobalAvgPool2D(), (2, 3, 5, 4)),
    "globalmax3d": (lambda p: p.gluon.nn.GlobalMaxPool3D(), (1, 2, 3, 4, 5)),
    "globalavg1d": (lambda p: p.gluon.nn.GlobalAvgPool1D(), (2, 3, 9)),
    "globalmax2d": (lambda p: p.gluon.nn.GlobalMaxPool2D(), (2, 3, 5, 4)),
    "globalavg3d": (lambda p: p.gluon.nn.GlobalAvgPool3D(), (1, 2, 3, 4, 5)),
    "reflectionpad": (lambda p: p.gluon.nn.ReflectionPad2D(2), (2, 3, 5, 5)),
    "hybridsequential": (_seq, (2, 3, 6, 6)),
    "hybridlambda": (lambda p: p.gluon.nn.HybridLambda(
        lambda F, x: F.relu(x) * 2 + F.tanh(x)), (3, 4)),
    "hybridlambda_name": (lambda p: p.gluon.nn.HybridLambda("tanh"), (3, 4)),
}


@pytest.mark.parametrize("name", sorted(_LAYERS))
def test_layer_matches_jax(name):
    factory, shape = _LAYERS[name]
    x = _r(np.random.RandomState(len(name)), *shape)
    _compare_block(factory, [x])


def test_batchnorm_predict_mode_matches_jax():
    x = _r(np.random.RandomState(2), 4, 3, 5, 5)
    _compare_block(_LAYERS["batchnorm"][0], [x], train=False)


def test_embedding_matches_jax():
    idx = np.random.RandomState(3).randint(0, 10, (3, 5)).astype(np.float32)
    _compare_block(lambda p: p.gluon.nn.Embedding(10, 4), [idx], n_diff=0)


def test_eager_blocks_and_raising_layers(tmp_path):
    x = _r(np.random.RandomState(4), 3, 4)
    for pkg in (jmx, mx):
        seq = pkg.gluon.nn.Sequential()
        seq.add(pkg.gluon.nn.Lambda("tanh"), pkg.gluon.nn.Lambda(
            lambda v: v * 3))
        seq.initialize()
        got = seq(_arr(pkg, x)).asnumpy()
        np.testing.assert_allclose(got, np.tanh(x) * 3, rtol=1e-6)
    # the Conv*Transpose layers run now (parity cases in
    # test_torch_deconvolution.py): the output shape is the JAX layer's
    for name, shape in (("Conv1DTranspose", (2, 3, 5)),
                        ("Conv2DTranspose", (2, 3, 5, 5))):
        outs = []
        for pkg in (jmx, mx):
            layer = getattr(pkg.gluon.nn, name)(4, 3, strides=2)
            layer.initialize(**({} if pkg is jmx else {"ctx": mx.cpu()}))
            outs.append(layer(_arr(pkg, np.ones(shape, np.float32))).shape)
        assert tuple(outs[0]) == tuple(outs[1]) == (2, 4) + (11,) * (
            len(shape) - 2)
    with pytest.raises(mx.MXNetError):
        mx.gluon.nn.Conv2D(4, 3, layout="NHWC")
    # parameter files, export and SymbolBlock (ROADMAP A.7) work now
    x3 = _r(np.random.RandomState(5), 4, 3)
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    want = net(_arr(mx, x3)).asnumpy()
    net.save_parameters(str(tmp_path / "x.params"))
    other = mx.gluon.nn.Dense(2, in_units=3)
    other.load_parameters(str(tmp_path / "x.params"), ctx=mx.cpu())
    np.testing.assert_array_equal(other(_arr(mx, x3)).asnumpy(), want)
    net.export(str(tmp_path / "x"))
    block = mx.gluon.SymbolBlock.imports(
        str(tmp_path / "x-symbol.json"), ["data"],
        str(tmp_path / "x-0000.params"), ctx=mx.cpu())
    np.testing.assert_array_equal(block(_arr(mx, x3)).asnumpy(), want)


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------
def _loss_cases():
    rng = np.random.RandomState(7)
    pred = _r(rng, 4, 5)
    reg = _r(rng, 4, 5)
    bits = (rng.rand(4, 5) > 0.5).astype(np.float32)
    signs = bits * 2 - 1
    probs = np.exp(reg) / np.exp(reg).sum(1, keepdims=True)
    sparse = np.array([0, 3, 4, 1], np.float32)
    sig = 1 / (1 + np.exp(-pred))
    return {
        "l2": (lambda p: p.gluon.loss.L2Loss(), [pred, reg]),
        "l2_weighted": (lambda p: p.gluon.loss.L2Loss(weight=0.5),
                        [pred, reg, np.abs(_r(rng, 4, 1))]),
        "l1": (lambda p: p.gluon.loss.L1Loss(weight=2.0), [pred, reg]),
        "sigmoid_bce": (lambda p: p.gluon.loss.SigmoidBCELoss(),
                        [pred, bits]),
        "sigmoid_bce_from_sigmoid": (
            lambda p: p.gluon.loss.SigmoidBCELoss(from_sigmoid=True),
            [sig, bits]),
        "softmax_ce": (lambda p: p.gluon.loss.SoftmaxCrossEntropyLoss(),
                       [pred, sparse]),
        "softmax_ce_dense": (lambda p: p.gluon.loss.SoftmaxCELoss(
            sparse_label=False), [pred, probs]),
        "softmax_ce_logits": (lambda p: p.gluon.loss.SoftmaxCELoss(
            from_logits=True), [pred - np.log(np.exp(pred).sum(
                1, keepdims=True)), sparse]),
        "kldiv": (lambda p: p.gluon.loss.KLDivLoss(from_logits=False),
                  [pred, probs]),
        "huber": (lambda p: p.gluon.loss.HuberLoss(rho=0.5), [pred, reg]),
        "hinge": (lambda p: p.gluon.loss.HingeLoss(), [pred, signs]),
        "squared_hinge": (lambda p: p.gluon.loss.SquaredHingeLoss(),
                          [pred, signs]),
        "logistic": (lambda p: p.gluon.loss.LogisticLoss(), [pred, signs]),
        "logistic_binary": (lambda p: p.gluon.loss.LogisticLoss(
            label_format="binary"), [pred, bits]),
        "triplet": (lambda p: p.gluon.loss.TripletLoss(margin=0.5),
                    [pred, reg, _r(rng, 4, 5)]),
        "cosine": (lambda p: p.gluon.loss.CosineEmbeddingLoss(),
                   [pred, reg, signs[:, 0]]),
    }


@pytest.mark.parametrize("name", sorted(_loss_cases()))
def test_loss_matches_jax(name):
    factory, inputs = _loss_cases()[name]
    _compare_block(factory, inputs)


def test_sigmoid_bce_pos_weight_matches_jax():
    rng = np.random.RandomState(8)
    pred, pw = _r(rng, 4, 5), np.abs(_r(rng, 5)) + 0.5
    bits = (rng.rand(4, 5) > 0.5).astype(np.float32)
    outs = []
    for pkg in (jmx, mx):
        loss = pkg.gluon.loss.SigmoidBCELoss()
        p = _arr(pkg, pred)
        p.attach_grad()
        with pkg.autograd.record():
            out = loss(p, _arr(pkg, bits), None, _arr(pkg, pw))
        out.backward()
        outs.append((out, p.grad))
    for a, b in zip(outs[1], outs[0]):
        _assert_close(a, b)


# ----------------------------------------------------------------------
# deferred initialization and names
# ----------------------------------------------------------------------
def test_deferred_init_and_names_match_jax():
    """Names (prefix counters included) and declared shapes equal the
    JAX package's; unknown dimensions wait for the first forward, which
    fills them as the JAX package's does."""
    jb, pb = _build(lambda p: p.gluon.model_zoo.vision.resnet18_v2(
        classes=10))
    jb.initialize()
    pb.initialize(ctx=mx.cpu())
    jp, pp = jb.collect_params(), pb.collect_params()
    assert list(pp.keys()) == list(jp.keys())
    assert "resnetv20_stage1_conv2d0_weight" in pp
    assert [p.shape for p in pp.values()] == [p.shape for p in jp.values()]
    deferred = [k for k, p in pp.items() if p._data is None]
    assert deferred and all(jp[k]._data is None for k in deferred)
    with pytest.raises(mx.gluon.DeferredInitializationError):
        pp[deferred[0]].data()
    x = _r(np.random.RandomState(9), 2, 3, 6, 6)
    jb, pb = _build(_seq)
    jb.initialize()
    pb.initialize(ctx=mx.cpu())
    jb(_arr(jmx, x))
    pb(_arr(mx, x))
    jp, pp = jb.collect_params(), pb.collect_params()
    assert list(pp.keys()) == list(jp.keys())
    assert [p.shape for p in pp.values()] == [p.shape for p in jp.values()]
    assert all(p.data().context == mx.cpu() for p in pp.values())


def test_gluon_params_from_numpy_checks_names_and_shapes():
    with NameManager():
        net = mx.gluon.nn.Dense(3)
    net.initialize(ctx=mx.cpu())
    w, b = np.ones((3, 4), np.float32), np.arange(3, dtype=np.float32)
    gluon_params_from_numpy(net, {"dense0_weight": w, "dense0_bias": b})
    assert net.weight.shape == (3, 4)                 # deferred shape taken
    np.testing.assert_array_equal(net.bias.data().asnumpy(), b)
    with pytest.raises(mx.MXNetError, match="missing"):
        gluon_params_from_numpy(net, {"dense0_weight": w})
    with pytest.raises(mx.MXNetError, match="unknown"):
        gluon_params_from_numpy(net, {"dense0_weight": w, "dense0_bias": b,
                                      "other": b})
    with pytest.raises(mx.MXNetError, match="shape"):
        gluon_params_from_numpy(net, {"dense0_weight": w[:2],
                                      "dense0_bias": b})


# ----------------------------------------------------------------------
# Trainer
# ----------------------------------------------------------------------
def _small_net(pkg, conv_bias=True):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Conv2D(4, 3, padding=1, use_bias=conv_bias),
                pkg.gluon.nn.BatchNorm(),
                pkg.gluon.nn.Activation("relu"),
                pkg.gluon.nn.Flatten(),
                pkg.gluon.nn.Dense(5))
    return net


def _train(pkg, net, x, y, steps=1, hybrid=None, **trainer_kw):
    """``steps`` Trainer steps; the JAX net runs hybridized unless told
    otherwise (its fast path), the port's eagerly."""
    if hybrid if hybrid is not None else pkg is jmx:
        net.hybridize()
    trainer = pkg.gluon.Trainer(net.collect_params(), **trainer_kw)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    grads = None
    for _ in range(steps):
        with pkg.autograd.record():
            loss = loss_fn(net(_arr(pkg, x)), _arr(pkg, y))
        loss.backward()
        grads = {k: _np(p.grad()) for k, p in net.collect_params().items()
                 if p.grad_req != "null"}
        trainer.step(x.shape[0])
    return trainer, grads, {k: _np(p.data())
                            for k, p in net.collect_params().items()}


def _trainer_pair(conv_bias, **trainer_kw):
    rng = np.random.RandomState(10)
    x, y = _r(rng, 4, 3, 6, 6), np.array([0, 2, 4, 1], np.float32)
    jb, pb = _build(lambda p: _small_net(p, conv_bias))
    start = _carry(jb, pb, [x])
    ref = _train(jmx, jb, x, y, **trainer_kw)
    got = _train(mx, pb, x, y, **trainer_kw)
    return ref, got, start, x.shape[0]


def _adam_band(g, w_tol, g_tol, lr, eps, beta2):
    """Elements where one Adam step can leave the weight tolerance under
    a gradient gap the gradient tolerance allows.  The first step is
    ``lr * g / (|g| + e)`` with ``e = eps / sqrt(1 - beta2)`` (the bias
    corrections folded in), whose slope in g is ``lr * e / (|g| + e)^2``:
    a gap of ``g_tol`` moves the step by more than ``w_tol`` where
    ``(|g| + e)^2 < lr * e * g_tol / w_tol``."""
    e = eps / np.sqrt(1.0 - beta2)
    return (np.abs(g) + e) ** 2 < lr * e * g_tol / w_tol


@pytest.mark.parametrize("opt,kw,on_kv", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}, True),
    ("sgd", {"learning_rate": 0.1}, False),
    ("adam", {"learning_rate": 0.01, "wd": 1e-4}, True)])
def test_trainer_step_matches_jax(opt, kw, on_kv):
    """One step, dense, through the device kvstore (the update on the
    store or on the parameters); the gradients agree at the test's
    tolerance.  Adam runs without the convolution's bias: BatchNorm
    right after it makes that gradient rounding noise around 0, which
    Adam's normalization turns into a full step of either sign in each
    package.  For the same reason Adam's weights are compared outside
    the band of tiny gradients where the packages' gradients differ
    (``_adam_band``, from the tolerances, eps and the learning rate), as
    the 2-bit test compares outside its threshold's band; the band
    stays a small share."""
    ref, got, start, batch = _trainer_pair(
        opt != "adam", optimizer=opt, optimizer_params=kw, kvstore="device",
        update_on_kvstore=on_kv)
    for k in ref[1]:
        _assert_close(got[1][k], ref[1][k], "grad " + k)
    band = compared = 0
    for k in ref[2]:
        keep = np.ones(ref[2][k].shape, bool)
        if opt == "adam" and k in ref[1]:
            g = ref[1][k]
            # the update's gradient: rescaled by 1/batch, plus wd * w
            g_eff = g / batch + kw["wd"] * start[k]
            g_tol = ATOL * max(1.0, float(np.abs(g).max())) / batch
            w_tol = ATOL * max(1.0, float(np.abs(ref[2][k]).max()))
            # a gradient both packages computed to the same bits gets
            # the same step: only a gap inside the band is let through
            keep = ~(_adam_band(g_eff, w_tol, g_tol, kw["learning_rate"],
                                eps=1e-8, beta2=0.999) & (got[1][k] != g))
            band += int((~keep).sum())
            compared += keep.size
        _assert_close(got[2][k][keep], ref[2][k][keep], k)
    if opt == "adam":
        assert band / compared < 2e-2, (band, compared)


def test_trainer_two_bit_step_matches_jax():
    """Compressed step through the port's bucketed 2-bit kvstore, the
    threshold at the median |g|: the updated parameters agree wherever
    the JAX gradient lies farther than 1e-4 t from t (inside that band a
    last-bit difference may flip q); the band stays a small share."""
    rng = np.random.RandomState(10)
    x, y = _r(rng, 4, 3, 6, 6), np.array([0, 2, 4, 1], np.float32)
    jb, pb = _build(_small_net)
    start = _carry(jb, pb, [x])
    # the threshold from a plain gradient of the same parameters
    with NameManager():
        probe = _small_net(mx)
    probe.initialize(ctx=mx.cpu())
    gluon_params_from_numpy(probe, start)
    _, g0, _ = _train(mx, probe, x, y, optimizer="sgd",
                      optimizer_params={"learning_rate": 0.0})
    t = float(np.median(np.abs(np.concatenate([g.ravel()
                                               for g in g0.values()]))))
    kw = dict(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        kvstore="device", compression_params={"type": "2bit",
                                              "threshold": t})
    from mxnet_tpu_torch.kernels import PLAIN_CALLS
    before = PLAIN_CALLS["two_bit_quantize_fused"]
    rj = _train(jmx, jb, x, y, **kw)
    rp = _train(mx, pb, x, y, **kw)
    assert PLAIN_CALLS["two_bit_quantize_fused"] > before
    band = compared = 0
    for name, ref in rj[2].items():
        if name not in rj[1]:
            _assert_close(rp[2][name], ref, name)
            continue
        near = np.abs(np.abs(rj[1][name]) - np.float32(t)) <= 1e-4 * t
        band += int(near.sum())
        compared += near.size
        np.testing.assert_allclose(rp[2][name][~near], ref[~near],
                                   rtol=5e-7, atol=5e-7, err_msg=name)
    assert band / compared < 1e-2, (band, compared)
    assert any(not np.array_equal(rp[2][k], start[k]) for k in rj[1])


def test_trainer_surface():
    rng = np.random.RandomState(11)
    x, y = _r(rng, 4, 3, 6, 6), np.array([0, 2, 4, 1], np.float32)
    with NameManager():
        net = _small_net(mx)
    net.initialize(ctx=mx.cpu())
    net(_arr(mx, x))
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.5}, update_on_kvstore=False)
    assert tr.learning_rate == 0.5
    tr.set_learning_rate(0.25)
    assert tr.learning_rate == 0.25
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(_arr(mx, x)), _arr(mx, y))
    loss.backward()
    w0 = _np(net[4].weight.data())
    g = _np(net[4].weight.grad())
    tr.allreduce_grads()
    tr.update(4)
    np.testing.assert_allclose(_np(net[4].weight.data()),
                               w0 - 0.25 * g / 4, rtol=1e-6, atol=1e-7)
    kv_tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1})
    kv_tr.step(4)
    with pytest.raises(mx.MXNetError, match="update_on_kvstore"):
        kv_tr.update(4)
    fresh = mx.gluon.nn.Dense(3)
    fresh.initialize(ctx=mx.cpu())                   # still deferred
    stale = mx.gluon.Trainer(fresh.collect_params(), "sgd",
                             {"learning_rate": 0.1}, kvstore=None)
    stale.step(1, ignore_stale_grad=True)
    with pytest.raises(mx.MXNetError, match="initialized"):
        stale.step(1)


# ----------------------------------------------------------------------
# hybridization and the model zoo
# ----------------------------------------------------------------------
def test_resnet18_v2_step_matches_jax():
    """ResNet-18 v2 at 3x32x32, batch 4, one SGD step (momentum, wd)
    through kvstore='device', both hybridized: outputs at the f32 bound;
    each parameter's move within 1e-3 of its largest move and all moves
    within 5e-4 relative L2 (a BatchNorm net's gradient carries the
    packages' different summation orders; measured 9.4e-5 and 4.1e-5
    on this CPU)."""
    rng = np.random.RandomState(12)
    x = rng.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32)
    y = np.array([1, 7, 3, 0], np.float32)
    jb, pb = _build(lambda p: p.gluon.model_zoo.vision.resnet18_v2(
        classes=10))
    start = _carry(jb, pb, [x])
    jb.hybridize()
    pb.hybridize()
    kw = dict(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        kvstore="device")
    outs = [_np(b(_arr(pkg, x))) for pkg, b in ((jmx, jb), (mx, pb))]
    _assert_close(outs[1], outs[0], "output")
    ref = _train(jmx, jb, x, y, **kw)[2]
    got = _train(mx, pb, x, y, **kw)[2]
    moves = {k: (got[k] - start[k], ref[k] - start[k]) for k in ref}
    for k, (mg, mr) in moves.items():
        np.testing.assert_allclose(mg, mr, rtol=0,
                                   atol=1e-3 * np.abs(mr).max(), err_msg=k)
    mg, mr = (np.concatenate([m[i].ravel() for m in moves.values()])
              for i in (0, 1))
    assert np.linalg.norm(mg - mr) <= 5e-4 * np.linalg.norm(mr)
    assert np.abs(mr).max() > 0


def test_hybridized_resnet_equals_eager_and_reuses_its_graph():
    rng = np.random.RandomState(13)
    x = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    y = np.array([1, 7], np.float32)
    res = []
    for hybrid in (False, True):
        with NameManager():
            net = mx.gluon.model_zoo.vision.get_model("resnet18_v1",
                                                      classes=10)
        mx.random.seed(3)
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        res.append(_train(mx, net, x, y, steps=2, hybrid=hybrid,
                          optimizer="sgd",
                          optimizer_params={"learning_rate": 0.1,
                                            "momentum": 0.9}))
        if hybrid:
            assert len(net._cached) == 1
    for k in res[0][2]:
        np.testing.assert_array_equal(res[1][2][k], res[0][2][k])
    with pytest.raises(mx.MXNetError, match="pretrained"):
        mx.gluon.model_zoo.vision.resnet50_v2(pretrained=True)


def test_data_loader_and_utils():
    rng = np.random.RandomState(14)
    x, y = _r(rng, 10, 3), np.arange(10, dtype=np.float32)
    ds = mx.gluon.data.ArrayDataset(x, y)
    with mx.cpu():
        batches = list(mx.gluon.data.DataLoader(ds, batch_size=4,
                                                last_batch="discard"))
    assert len(batches) == 2
    np.testing.assert_array_equal(batches[1][0].asnumpy(), x[4:8])
    np.testing.assert_array_equal(batches[1][1].asnumpy(), y[4:8])
    mx.random.seed(1)
    order = [i for b in mx.gluon.data.BatchSampler(
        mx.gluon.data.RandomSampler(10), 3, "keep") for i in b]
    assert sorted(order) == list(range(10))
    with pytest.raises(mx.MXNetError, match="A.6"):
        mx.gluon.data.DataLoader(ds, batch_size=2, num_workers=2)
    data = mx.nd.array(x, ctx=mx.cpu())
    parts = mx.gluon.utils.split_data(data, 2)
    np.testing.assert_array_equal(parts[1].asnumpy(), x[5:])
    (whole,) = mx.gluon.utils.split_and_load(data, [mx.cpu()])
    assert whole is data
    arrs = [mx.nd.array(a, ctx=mx.cpu()) for a in (x, y)]
    jarrs = [jmx.nd.array(a) for a in (x, y)]
    norm = mx.gluon.utils.clip_global_norm(arrs, 1.0)
    jnorm = jmx.gluon.utils.clip_global_norm(jarrs, 1.0)
    np.testing.assert_allclose(norm, jnorm, rtol=1e-6)
    for a, b in zip(arrs, jarrs):
        _assert_close(a, b)
    with pytest.raises(mx.MXNetError, match="network"):
        mx.gluon.utils.download("http://localhost/x")


def test_trainer_bf16_multi_precision_raises_like_the_updater():
    """bf16 weights under multi_precision train through the f32 masters
    of the Updater the Trainer applies (ROADMAP A.1's bf16 half): the
    master steps in f32 and the weight is the master rounded to bf16; a
    float16 weight takes an f32 master in that Updater too (float16
    training, ROADMAP A.1: tests/test_torch_fit_f16.py)."""
    with NameManager():
        net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mx.cpu())
    net.cast("bfloat16")
    assert net.weight.data().dtype == torch.bfloat16
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1,
                                "multi_precision": True})
    x = mx.nd.array(np.ones((2, 4), np.float32), ctx=mx.cpu(),
                    dtype="bfloat16")
    w0 = net.weight.data().astype("float32").asnumpy()
    with mx.autograd.record():
        loss = net(x).sum()
    loss.backward()
    g = net.weight.grad().astype("float32").asnumpy()
    trainer.step(2)
    w = net.weight.data()._data
    assert w.dtype == torch.bfloat16
    updater = trainer._kvstore._updater
    inner, w32 = updater.states[trainer._param2idx[net.weight.name]]
    want = w0 - np.float32(0.1) * (g * np.float32(0.5))
    assert inner is None and w32._data.dtype == torch.float32
    np.testing.assert_array_equal(w32.asnumpy(), want)
    assert torch.equal(w, torch.from_numpy(want).bfloat16())
    w16 = mx.nd.array(np.ones(4, np.float32), ctx=mx.cpu()).astype("float16")
    updater("f16", w16, w16)
    inner, w32 = updater.states["f16"]
    assert inner is None and w32._data.dtype == torch.float32
    assert w16._data.dtype == torch.float16
