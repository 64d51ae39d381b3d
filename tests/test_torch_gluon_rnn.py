"""PyTorch port: ``gluon.rnn`` against the JAX package on the CPU.

The cells (RNN, LSTM, GRU, and the Sequential, Dropout at rate 0,
Zoneout at rate 0, Residual and Bidirectional cells; hybridized and
not) and the fused layers (``RNN``, ``LSTM``, ``GRU`` over the ``RNN``
op, TNC and NTC, bidirectional, two layers) carry the JAX package's
parameter names; on the same numpy weights (``weights.
gluon_params_from_numpy``) their outputs, last states and the
gradients of every parameter and of the input agree at rtol 2e-5 /
atol 1e-6 in f32, and one ``Trainer`` SGD step ends on the JAX
package's weights.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.base import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import NameManager
from mxnet_tpu_torch.weights import gluon_params_from_numpy

RTOL, ATOL = 2e-5, 1e-6
T, B, I, H = 4, 3, 5, 6


def _cell(pkg, kind):
    r = pkg.gluon.rnn
    if kind in ("rnn", "lstm", "gru"):
        return {"rnn": r.RNNCell, "lstm": r.LSTMCell,
                "gru": r.GRUCell}[kind](H, input_size=I)
    if kind == "sequential":
        s = r.SequentialRNNCell()
        with s.name_scope():
            s.add(r.LSTMCell(H, input_size=I))
            s.add(r.DropoutCell(0.0))
            s.add(r.GRUCell(H, input_size=H))
        return s
    if kind == "zoneout":
        return r.ZoneoutCell(r.LSTMCell(H, input_size=I), 0.0, 0.0)
    if kind == "residual":
        return r.ResidualCell(r.GRUCell(I, input_size=I))
    if kind == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(H, input_size=I),
                                   r.RNNCell(H, input_size=I))
    raise ValueError(kind)


def _layer(pkg, kind, layout):
    r = pkg.gluon.rnn
    cls = {"rnn": r.RNN, "lstm": r.LSTM, "gru": r.GRU}[kind]
    return cls(H, num_layers=2, bidirectional=True, layout=layout,
               input_size=I)


def _make(pkg, build):
    with (JNameManager() if pkg is jmx else NameManager()):
        net = build(pkg)
    ctx = jmx.cpu() if pkg is jmx else mx.cpu()
    net.initialize(pkg.init.Xavier(), ctx=ctx)
    return net, ctx


def _same_weights(jnet, tnet, seed):
    rng = np.random.RandomState(seed)
    vals = {k: (rng.randn(*p.shape) * 0.25).astype(np.float32)
            for k, p in jnet.collect_params().items()}
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(vals[k]))
    assert sorted(tnet.collect_params().keys()) == sorted(vals)
    gluon_params_from_numpy(tnet, vals)


def _run(pkg, net, ctx, x, call):
    xa = pkg.nd.array(x, ctx=ctx)
    xa.attach_grad()
    with pkg.autograd.record():
        outs = call(net, xa)
        flat = []
        for o in outs:
            flat.extend(o if isinstance(o, (list, tuple)) else [o])
        loss = sum((o * o).sum() for o in flat)
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()}
    return [o.asnumpy() for o in flat], grads, xa.grad.asnumpy()


def _compare(j, t):
    jouts, jgrads, jx = j
    touts, tgrads, tx = t
    assert len(touts) == len(jouts)
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k], jgrads[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(tx, jx, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "sequential",
                                  "zoneout", "residual", "bidirectional"])
@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_cells_unroll_match_jax(kind, hybridize, layout):
    jnet, jctx = _make(jmx, lambda p: _cell(p, kind))
    tnet, tctx = _make(mx, lambda p: _cell(p, kind))
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    _same_weights(jnet, tnet, 3)
    shape = (B, T, I) if layout == "NTC" else (T, B, I)
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)

    def call(net, xa):
        outs, states = net.unroll(T, xa, layout=layout, merge_outputs=True)
        return [outs] + list(states)
    _compare(_run(jmx, jnet, jctx, x, call), _run(mx, tnet, tctx, x, call))


def test_cell_steps_and_valid_length_match_jax():
    jnet, jctx = _make(jmx, lambda p: _cell(p, "lstm"))
    tnet, tctx = _make(mx, lambda p: _cell(p, "lstm"))
    _same_weights(jnet, tnet, 5)
    x = np.random.RandomState(6).randn(B, T, I).astype(np.float32)
    lens = np.array([4, 2, 3], np.float32)

    def call_for(pkg, ctx):
        def call(net, xa):
            outs, states = net.unroll(T, xa, merge_outputs=False,
                                      valid_length=pkg.nd.array(lens,
                                                                ctx=ctx))
            return list(outs) + list(states)
        return call
    _compare(_run(jmx, jnet, jctx, x, call_for(jmx, jctx)),
             _run(mx, tnet, tctx, x, call_for(mx, tctx)))
    # one step a call
    xs = np.random.RandomState(7).randn(B, I).astype(np.float32)
    outs = []
    for pkg, net, ctx in ((jmx, jnet, jctx), (mx, tnet, tctx)):
        st = net.begin_state(B, ctx=ctx)
        o, st = net(pkg.nd.array(xs, ctx=ctx), st)
        outs.append([o.asnumpy()] + [s.asnumpy() for s in st])
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru"])
@pytest.mark.parametrize("layout", ["TNC", "NTC"])
def test_fused_layers_match_jax(kind, layout):
    jnet, jctx = _make(jmx, lambda p: _layer(p, kind, layout))
    tnet, tctx = _make(mx, lambda p: _layer(p, kind, layout))
    assert repr(tnet) == repr(jnet)
    _same_weights(jnet, tnet, 8)
    shape = (B, T, I) if layout == "NTC" else (T, B, I)
    x = np.random.RandomState(9).randn(*shape).astype(np.float32)

    def call_for(pkg, ctx):
        def call(net, xa):
            st = net.begin_state(B, ctx=ctx)
            out, new = net(xa, st)
            return [out] + list(new)
        return call
    _compare(_run(jmx, jnet, jctx, x, call_for(jmx, jctx)),
             _run(mx, tnet, tctx, x, call_for(mx, tctx)))
    # without states: the output sequence only
    out = tnet(mx.nd.array(x, ctx=tctx))
    assert out.shape == (shape[0], shape[1], 2 * H)


def test_deferred_input_size_and_trainer_step_match_jax():
    """``gluon.rnn.LSTM(H, num_layers=2)`` with its input width from the
    first batch, then one Trainer SGD step on both packages."""
    def build(pkg):
        return pkg.gluon.rnn.LSTM(H, num_layers=2)
    nets = {}
    x = np.random.RandomState(10).randn(T, B, I).astype(np.float32)
    for name, pkg in (("jax", jmx), ("port", mx)):
        net, ctx = _make(pkg, build)
        net(pkg.nd.array(x, ctx=ctx))         # the deferred shapes
        nets[name] = (pkg, net, ctx)
    _same_weights(nets["jax"][1], nets["port"][1], 11)
    after = {}
    for name, (pkg, net, ctx) in nets.items():
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1, "momentum": 0.9})
        xa = pkg.nd.array(x, ctx=ctx)
        with pkg.autograd.record():
            loss = (net(xa) ** 2).sum()
        loss.backward()
        trainer.step(B)
        after[name] = {k: p.data().asnumpy()
                       for k, p in net.collect_params().items()}
    assert nets["port"][1].l0_i2h_weight.shape == (4 * H, I)
    for k, v in after["jax"].items():
        np.testing.assert_allclose(after["port"][k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_layer_and_cell_errors():
    with pytest.raises(ValueError, match="Invalid layout"):
        mx.gluon.rnn.LSTM(H, layout="NCT")
    net, ctx = _make(mx, lambda p: p.gluon.rnn.GRU(H, input_size=I))
    with pytest.raises(ValueError, match="Invalid recurrent state shape"):
        net(mx.nd.zeros((T, B, I), ctx=ctx),
            [mx.nd.zeros((1, B + 1, H), ctx=ctx)])
    cell, _ = _make(mx, lambda p: _cell(p, "bidirectional"))
    with pytest.raises(NotImplementedError):
        cell(mx.nd.zeros((B, I), ctx=mx.cpu()), [])
