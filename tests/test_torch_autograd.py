"""PyTorch port: ``mx.autograd`` against the JAX package's on the CPU.

The port's autograd is torch's underneath; the JAX package replays its
own tape under ``jax.vjp``.  The same numpy inputs go to both and the
gradients are compared at the f32 bound (rtol 2e-5 / atol 1e-6).
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


def _r(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _arr(pkg, a):
    return pkg.nd.array(a) if pkg is jmx else mx.nd.array(a, ctx=mx.cpu())


def _close(got, ref):
    np.testing.assert_allclose(got.asnumpy(), np.asarray(ref.asnumpy()),
                               rtol=RTOL, atol=ATOL)


def test_flags_are_independent():
    ag = mx.autograd
    assert not ag.is_recording() and not ag.is_training()
    with ag.record():
        assert ag.is_recording() and ag.is_training()
        with ag.pause():
            assert not ag.is_recording() and not ag.is_training()
        with ag.predict_mode():
            assert ag.is_recording() and not ag.is_training()
    with ag.record(train_mode=False):
        assert ag.is_recording() and not ag.is_training()
    with ag.train_mode():
        assert ag.is_training() and not ag.is_recording()
    assert not ag.is_recording() and not ag.is_training()


def _loss(pkg, x, w, lab):
    nd = pkg.nd
    h = nd.relu(nd.dot(x, w)) * 1.5 + nd.exp(x).sum(axis=1, keepdims=True)
    logp = nd.log_softmax(h, axis=-1)
    return -nd.pick(logp, lab, axis=-1)              # per sample


def _grads(pkg, x, w, lab, head_grad=None, reduce=True):
    xs, ws = _arr(pkg, x), _arr(pkg, w)
    xs.attach_grad()
    ws.attach_grad()
    with pkg.autograd.record():
        loss = _loss(pkg, xs, ws, _arr(pkg, lab))
        if reduce:
            loss = loss.mean()
    if head_grad is None:
        loss.backward()
    else:
        loss.backward(_arr(pkg, head_grad))
    return loss, xs.grad, ws.grad


@pytest.mark.parametrize("mode", ["scalar", "vector", "head_grad"])
def test_backward_matches_jax(mode):
    """A scalar head, a non-scalar head (seeded with ones) and a given
    head gradient."""
    rng = np.random.RandomState(1)
    x, w = _r(rng, 4, 6) * 0.5, _r(rng, 6, 5)
    lab = np.array([0, 3, 4, 1], np.float32)
    hg = _r(rng, 4) if mode == "head_grad" else None
    ref = _grads(jmx, x, w, lab, hg, reduce=mode == "scalar")
    got = _grads(mx, x, w, lab, hg, reduce=mode == "scalar")
    for a, b in zip(got, ref):
        _close(a, b)


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_overwrites_and_add_accumulates(req):
    """Two backwards: 'write' leaves the second gradient (torch alone
    would accumulate), 'add' the sum; as the JAX package does."""
    a = np.array([1.0, -2.0, 3.0], np.float32)
    res = []
    for pkg in (jmx, mx):
        x = _arr(pkg, a)
        x.attach_grad(grad_req=req)
        for scale in (1.0, 3.0):
            with pkg.autograd.record():
                y = (x * x * scale).sum()
            y.backward()
        res.append(x.grad)
    _close(res[1], res[0])
    want = 6 * a if req == "write" else 8 * a
    np.testing.assert_allclose(res[1].asnumpy(), want, rtol=RTOL)


def test_grad_returns_without_writing_and_second_order():
    a = np.array([0.5, -1.5, 2.0], np.float32)
    firsts, seconds = [], []
    for pkg in (jmx, mx):
        x = _arr(pkg, a)
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * x * x).sum()
        (g,) = pkg.autograd.grad(y, [x], retain_graph=True)
        firsts.append(g)
        assert float(np.abs(x.grad.asnumpy()).max()) == 0.0   # not written
        with pkg.autograd.record():
            z = (x * x * x).sum()
            (dz,) = pkg.autograd.grad(z, [x], create_graph=True)
            s = dz.sum()
        s.backward()
        seconds.append(x.grad)
    _close(firsts[1], firsts[0])
    _close(seconds[1], seconds[0])
    np.testing.assert_allclose(seconds[1].asnumpy(), 6 * a, rtol=RTOL)


class _Sigmoid:
    """The reference's autograd.Function example, for either package."""

    @staticmethod
    def make(pkg):
        class Sigmoid(pkg.autograd.Function):
            def forward(self, x):
                y = 1 / (1 + pkg.nd.exp(-x))
                self._y = y
                return y

            def backward(self, dy):
                y = self._y
                return dy * y * (1 - y)
        return Sigmoid()


def test_function_matches_jax():
    rng = np.random.RandomState(3)
    a, dy = _r(rng, 3, 4), _r(rng, 3, 4)
    res = []
    for pkg in (jmx, mx):
        x = _arr(pkg, a)
        x.attach_grad()
        with pkg.autograd.record():
            y = _Sigmoid.make(pkg)(x) * 2
        y.backward(_arr(pkg, dy))
        res.append((y, x.grad))
    for got, ref in zip(res[1], res[0]):
        _close(got, ref)
    out = _Sigmoid.make(mx)(mx.nd.array(a, ctx=mx.cpu()))    # not recording
    np.testing.assert_allclose(out.asnumpy(), 1 / (1 + np.exp(-a)),
                               rtol=1e-6)


def test_pause_stops_recording_and_unreached_grads_stay():
    x = mx.nd.array(np.ones(3, np.float32), ctx=mx.cpu())
    w = mx.nd.array(np.full(3, 2.0, np.float32), ctx=mx.cpu())
    x.attach_grad()
    w.attach_grad()
    w.grad[:] = 7.0
    with mx.autograd.record():
        y = x * 3
        with mx.autograd.pause():
            z = x * 5                            # not recorded
        loss = (y + z).sum()
    loss.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 3.0)
    np.testing.assert_allclose(w.grad.asnumpy(), 7.0)   # not reached
    assert not z._data.requires_grad


def test_batchnorm_train_mode_moves_running_stats_like_jax():
    """An imperative BatchNorm under record() reads is_training() and
    writes its new moving statistics into the arrays it was given
    (mutate_inputs); predict mode leaves them."""
    rng = np.random.RandomState(5)
    x = _r(rng, 4, 3, 5, 5)
    g, b = 1 + 0.1 * _r(rng, 3), 0.1 * _r(rng, 3)
    res = []
    for pkg in (jmx, mx):
        ins = [_arr(pkg, a) for a in (x, g, b, np.zeros(3, np.float32),
                                      np.ones(3, np.float32))]
        ins[0].attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.BatchNorm(*ins, fix_gamma=False, eps=1e-5)
        out.backward()
        with pkg.autograd.record(train_mode=False):
            pkg.nd.BatchNorm(*ins, fix_gamma=False, eps=1e-5)
        res.append((out, ins[0].grad, ins[3], ins[4]))
    for got, ref in zip(res[1], res[0]):
        _close(got, ref)
    assert np.abs(res[1][2].asnumpy()).max() > 0      # the mean moved


def test_backward_needs_attached_and_recorded():
    x = mx.nd.array(np.ones(2, np.float32), ctx=mx.cpu())
    x.attach_grad()
    y = (x * 2).sum()                                  # not recorded
    with pytest.raises(mx.MXNetError, match="record"):
        y.backward()
    with pytest.raises(mx.MXNetError):
        mx.nd.array(np.ones(2, np.int32), ctx=mx.cpu()).attach_grad()
