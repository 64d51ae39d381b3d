"""PyTorch port: the fused ``RNN`` op and the ``Sequence*`` ops against
the JAX package on the CPU.

The same numpy inputs and packed parameters go through the JAX op
(``mxnet_tpu/ops/rnn.py``, one ``lax.scan`` a layer and direction) and
the port's (``mxnet_tpu_torch/ops/rnn.py``, a Python time loop of plain
PyTorch ops): the outputs and, through ``jax.vjp`` and torch autograd
with the same cotangents, the gradients of the data, the parameters and
both states agree at rtol 2e-5 / atol 1e-6 in f32, for every mode, one
and two directions, one and two layers, with and without
``state_outputs``, with batch-1 (broadcast) and full-batch states.
Inter-layer dropout is the port's own draw (``random.keep_mask``; the
JAX package draws with ``jax.random.bernoulli``), so it is held to its
keep share and to its determinism under one step seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu.ops.rnn import rnn_param_size as jparam_size

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import random as _random
from mxnet_tpu_torch.ops.registry import get_op
from mxnet_tpu_torch.ops.rnn import rnn_param_size

RTOL, ATOL = 2e-5, 1e-6
S, B, I, H = 5, 3, 6, 4


def _inputs(mode, layers, bi, state_batch, seed):
    rng = np.random.RandomState(seed)
    depth = layers * (2 if bi else 1)
    size = rnn_param_size(layers, I, H, bi, mode)
    x = rng.randn(S, B, I).astype(np.float32)
    p = (rng.randn(size) * 0.3).astype(np.float32)
    h0 = (rng.randn(depth, state_batch, H) * 0.5).astype(np.float32)
    c0 = (rng.randn(depth, state_batch, H) * 0.5).astype(np.float32)
    return [x, p, h0] + ([c0] if mode == "lstm" else [])


def _cotangents(outs, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*o.shape).astype(np.float32) for o in outs]


def _run_both(mode, layers, bi, state_batch, state_outputs, seed=0):
    args = _inputs(mode, layers, bi, state_batch, seed)
    kw = dict(state_size=H, num_layers=layers, mode=mode, bidirectional=bi,
              state_outputs=state_outputs)

    def jfn(*a):
        out = jget_op("RNN").fn(*a, **kw)
        return out if isinstance(out, tuple) else (out,)

    jouts, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    cts = _cotangents(jouts, seed + 1)
    jgrads = vjp(tuple(jnp.asarray(c) for c in cts))

    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    touts = get_op("RNN").fn(*leaves, **kw)
    touts = touts if isinstance(touts, tuple) else (touts,)
    tgrads = torch.autograd.grad(touts, leaves,
                                 [torch.from_numpy(c) for c in cts])
    return jouts, touts, jgrads, tgrads


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("layers,bi", [(1, False), (2, False), (1, True),
                                       (2, True)])
def test_rnn_op_forward_and_gradients_match_jax(mode, layers, bi):
    # batch-1 (broadcast) states without the state outputs, full-batch
    # states with them
    for state_batch, state_outputs in ((1, False), (B, True)):
        jouts, touts, jgrads, tgrads = _run_both(
            mode, layers, bi, state_batch, state_outputs)
        n_out = 1 if not state_outputs else (3 if mode == "lstm" else 2)
        assert len(touts) == len(jouts) == n_out
        assert touts[0].shape == (S, B, H * (2 if bi else 1))
        for j, t in zip(jouts, touts):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                       rtol=RTOL, atol=ATOL)
        # data, packed parameters, h0 (and c0): a batch-1 state's
        # gradient is the sum over the batch it broadcast to
        for j, t in zip(jgrads, tgrads):
            assert t.shape == j.shape
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       rtol=RTOL, atol=ATOL)


def test_batch1_state_gradient_is_the_batch_sum():
    """A (L, 1, H) state broadcasts over the batch; its gradient equals
    the full-batch state's gradient summed over the batch."""
    args = _inputs("lstm", 2, False, B, 3)
    kw = dict(state_size=H, num_layers=2, mode="lstm")
    zeros1 = [np.zeros((2, 1, H), np.float32)] * 2
    zerosB = [np.zeros((2, B, H), np.float32)] * 2
    grads = []
    for states in (zeros1, zerosB):
        leaves = [torch.tensor(a, requires_grad=True)
                  for a in args[:2] + states]
        out = get_op("RNN").fn(*leaves, **kw)
        out.sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    for g1, gB in zip(grads[0][2:], grads[1][2:]):
        torch.testing.assert_close(g1, gB.sum(1, keepdim=True), rtol=1e-6,
                                   atol=1e-6)
    torch.testing.assert_close(grads[0][1], grads[1][1])


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
@pytest.mark.parametrize("layers,bi", [(1, False), (3, True)])
def test_rnn_param_size_matches_jax(mode, layers, bi):
    for isz, hsz in ((6, 4), (200, 200), (1, 7)):
        assert rnn_param_size(layers, isz, hsz, bi, mode) == \
            jparam_size(layers, isz, hsz, bi, mode)


def test_rnn_symbol_shapes_and_bad_state():
    data = mx.sym.Variable("data")
    out = mx.sym.RNN(data, state_size=H, num_layers=2, mode="gru",
                     bidirectional=True, state_outputs=True, name="rnn")
    assert out.list_arguments() == ["data", "rnn_parameters", "rnn_state"]
    args, outs, _ = out.infer_shape(data=(S, B, I))
    assert args[1] == (rnn_param_size(2, I, H, True, "gru"),)
    assert args[2] == (4, B, H)
    assert outs == [(S, B, 2 * H), (4, B, H)]
    with pytest.raises(ValueError, match="state has shape"):
        get_op("RNN").fn(torch.zeros(S, B, I),
                         torch.zeros(rnn_param_size(1, I, H, False, "gru")),
                         torch.zeros(1, 2, H), state_size=H, num_layers=1,
                         mode="gru")


def test_interlayer_dropout_keep_share_and_seed():
    """Dropout between layers (train only) keeps about 1 - p of the
    first layer's outputs, draws the same mask from one step seed and a
    new one from another, and is off at inference."""
    L, p, Hd, Bd, Sd = 2, 0.3, 64, 32, 20
    size = rnn_param_size(L, Hd, Hd, False, "rnn_relu")
    x = torch.ones(Sd, Bd, Hd)
    # layer 1 the identity on positive inputs: R and its bias zero, W the
    # identity, so the output counts the layer-0 units dropout kept
    params = torch.zeros(size)
    w0 = torch.eye(Hd).reshape(-1)
    params[:Hd * Hd] = w0
    params[2 * Hd * Hd:3 * Hd * Hd] = w0
    kw = dict(state_size=Hd, num_layers=L, mode="rnn_relu", p=p)
    h0 = torch.zeros(L, 1, Hd)

    def run(seed, train=True):
        rng = _random.StepRandom(torch.tensor(seed, dtype=torch.int64))
        return get_op("RNN").fn(x, params, h0, is_train=train, rng=rng, **kw)

    a, b, c = run(11), run(11), run(12)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    kept = (a > 0).float().mean().item()
    n = a.numel()
    assert abs(kept - (1 - p)) < 5 * (p * (1 - p) / n) ** 0.5
    np.testing.assert_allclose(a[a > 0].numpy(), 1.0 / (1 - p), rtol=1e-6)
    assert torch.equal(run(11, train=False), torch.ones_like(a))


def _jseq(name, data, lengths, **kw):
    fn = jget_op(name).fn
    if lengths is None:
        return lambda d: fn(d, **kw)
    return lambda d: fn(d, jnp.asarray(lengths), use_sequence_length=True,
                        **kw)


@pytest.mark.parametrize("name", ["SequenceMask", "SequenceLast",
                                  "SequenceReverse"])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_sequence_ops_match_jax(name, axis, with_lengths):
    rng = np.random.RandomState(5)
    seq, batch = 6, 4
    # SequenceReverse reverses axis 0 whatever ``axis`` says, in both
    # packages: its data keeps the (seq, batch) layout
    shape = (seq, batch, 3) if axis == 0 or name == "SequenceReverse" \
        else (batch, seq, 3)
    data = rng.randn(*shape).astype(np.float32)
    lengths = np.array([6, 1, 3, 4], np.float32) if with_lengths else None
    kw = {"axis": axis}
    if name == "SequenceMask":
        kw["value"] = -2.0
    jout, vjp = jax.vjp(_jseq(name, data, lengths, **kw), jnp.asarray(data))
    ct = rng.randn(*jout.shape).astype(np.float32)
    (jgrad,) = vjp(jnp.asarray(ct))
    leaf = torch.tensor(data, requires_grad=True)
    if with_lengths:
        tout = get_op(name).fn(leaf, torch.from_numpy(lengths),
                               use_sequence_length=True, **kw)
    else:
        tout = get_op(name).fn(leaf, **kw)
    (tgrad,) = torch.autograd.grad(tout, [leaf], [torch.from_numpy(ct)])
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=RTOL,
                               atol=ATOL)


def test_sequence_ops_through_nd_and_symbol():
    """``mx.nd`` and a bound symbol run the ops, lengths as an input."""
    data = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
    lens = np.array([2, 4], np.float32)
    x = mx.nd.array(data, ctx=mx.cpu())
    ln = mx.nd.array(lens, ctx=mx.cpu())
    last = mx.nd.SequenceLast(x, sequence_length=ln, use_sequence_length=True)
    np.testing.assert_array_equal(last.asnumpy(), data[[1, 3], [0, 1]])
    sym = mx.sym.SequenceMask(mx.sym.Variable("data"),
                              mx.sym.Variable("lens"),
                              use_sequence_length=True)
    exe = sym.simple_bind(ctx=mx.cpu(), data=(4, 2, 3), lens=(2,))
    out = exe.forward(data=data, lens=lens)[0].asnumpy()
    want = data.copy()
    want[2:, 0] = 0
    np.testing.assert_array_equal(out, want)
    assert mx.sym.SequenceReverse(mx.sym.Variable("d")).list_arguments() \
        == ["d"]
