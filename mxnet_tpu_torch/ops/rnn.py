"""The fused multi-layer RNN operator (RNN, LSTM, GRU, one or two
directions) and the ``Sequence*`` ops.

Counterpart of ``mxnet_tpu/ops/rnn.py`` (reference
src/operator/rnn-inl.h) and of the sequence ops of
``mxnet_tpu/ops/tensor.py:319-360``.  The parameters are cuDNN's packed
flat vector: every layer's weights first (per layer, per direction: the
input projection W, then the recurrent R, gates stacked row-wise), then
every bias in the same order (b_W then b_R).  Gate orders are cuDNN's:
LSTM (i, f, g, o), GRU (r, z, n).

Each layer and direction hoists its input projection out of the time
loop as one product over ``(seq * batch, in)`` (with both biases folded
in, except the GRU's b_R, which the reset gate multiplies:
``n = tanh(x W_n + b_Wn + r * (h R_n^T + b_Rn))``), then walks the time
steps in Python: one ``addmm`` and the cell's elementwise arithmetic a
step, plain PyTorch ops that autograd records.  No cuDNN RNN call: its
dropout keeps state of its own, and its arithmetic cannot be held step
by step against the JAX package's ``lax.scan``.  Nothing in the loop
reads the device back, so a train step with this op captures as one
CUDA graph (the fused fit step).

A batch-1 initial state (the cell zoo's default ``begin_state``)
broadcasts over the batch; its gradient sums over the batch.  Dropout
between layers (``p``, train only) draws from the walk's step seed
(``random.keep_mask`` through ``nn.dropout_mask``): a captured graph
draws new masks at each replay, and the card and the CPU draw the same
bits from one seed.  The JAX package draws with ``jax.random.bernoulli``,
so the two packages agree only at ``p = 0``.  ``lstm_state_clip_*`` and
``projection_size`` are accepted and ignored, as in the JAX package
(``mxnet_tpu/ops/rnn.py:140-142``).
"""
from __future__ import annotations

import torch

from .nn import dropout_mask
from .registry import register

__all__ = ["rnn_param_size", "unpack_params"]

_NGATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """The packed parameter count (reference GetRnnParamSize,
    src/operator/rnn-inl.h:88)."""
    ngates = _NGATES[mode]
    ndir = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * ndir
        size += ndir * ngates * state_size * (isz + state_size + 2)
    return size


def unpack_params(params, num_layers, input_size, state_size, bidirectional,
                  mode):
    """Views of the packed vector: ``[(W, R)]`` and ``[(b_W, b_R)]``, one
    pair per layer and direction, layer-major."""
    ngates = _NGATES[mode]
    ndir = 2 if bidirectional else 1
    rows = ngates * state_size
    ws, bs, off = [], [], 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * ndir
        for _ in range(ndir):
            w = params[off:off + rows * isz].view(rows, isz)
            off += rows * isz
            r = params[off:off + rows * state_size].view(rows, state_size)
            off += rows * state_size
            ws.append((w, r))
    for _ in range(num_layers * ndir):
        bs.append((params[off:off + rows], params[off + rows:off + 2 * rows]))
        off += 2 * rows
    return ws, bs


def _run_layer(x, w, r, bw, br, h0, c0, mode, reverse):
    """One layer and direction over ``x`` (seq, batch, in): the output
    sequence (seq, batch, state) and the last states."""
    seq, batch = x.shape[0], x.shape[1]
    H = r.shape[1]
    # the input projection of every step in one product; GRU keeps b_R
    # for the reset gate's product
    bias = bw if mode == "gru" else bw + br
    xg = torch.addmm(bias, x.reshape(seq * batch, x.shape[2]),
                     w.t()).view(seq, batch, -1)
    rt = r.t()
    h, c = h0, c0
    outs = [None] * seq
    steps = range(seq - 1, -1, -1) if reverse else range(seq)
    for t in steps:
        if mode == "lstm":
            gates = torch.addmm(xg[t], h, rt)
            s = torch.sigmoid(gates)
            g = torch.tanh(gates[:, 2 * H:3 * H])
            c = torch.addcmul(s[:, H:2 * H] * c, s[:, :H], g)
            h = s[:, 3 * H:] * torch.tanh(c)
        elif mode == "gru":
            hp = torch.addmm(br, h, rt)
            xt = xg[t]
            rz = torch.sigmoid(xt[:, :2 * H] + hp[:, :2 * H])
            n = torch.tanh(torch.addcmul(xt[:, 2 * H:], rz[:, :H],
                                         hp[:, 2 * H:]))
            z = rz[:, H:]
            h = torch.addcmul((1.0 - z) * n, z, h)
        else:
            pre = torch.addmm(xg[t], h, rt)
            h = torch.tanh(pre) if mode == "rnn_tanh" else torch.relu(pre)
        outs[t] = h
    return torch.stack(outs), h, c


def _rnn_num_outputs(attrs):
    if not attrs.get("state_outputs", False):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


@register("RNN", num_outputs=_rnn_num_outputs,
          num_visible_outputs=_rnn_num_outputs,
          unused_inputs=lambda a: () if a.get("mode", "lstm") == "lstm"
          else ("state_cell",),
          draws=lambda a: float(a.get("p", 0.0)) > 0.0)
def rnn(data, parameters, state, state_cell=None, *, state_size, num_layers,
        mode="lstm", bidirectional=False, p=0.0, state_outputs=False,
        lstm_state_clip_min=None, lstm_state_clip_max=None,
        lstm_state_clip_nan=False, projection_size=None, is_train=False,
        rng=None):
    """data (seq, batch, input), parameters packed (see the module),
    state (and, for LSTM, state_cell) (layers * directions, batch or 1,
    state_size).  Returns the last layer's output sequence (seq, batch,
    state_size * directions) and, with ``state_outputs``, the last
    states (h, and c for LSTM)."""
    if mode not in _NGATES:
        raise ValueError("RNN: unknown mode %r" % (mode,))
    ndir = 2 if bidirectional else 1
    L, H = int(num_layers), int(state_size)
    full = (L * ndir, data.shape[1], H)

    def fit(s, what):
        if tuple(s.shape) == full:
            return s
        if tuple(s.shape) == (full[0], 1, full[2]):
            return s.expand(full)
        raise ValueError("RNN %s has shape %s; expected %s or (%d, 1, %d)"
                         % (what, tuple(s.shape), full, full[0], full[2]))

    state = fit(state, "state")
    if mode == "lstm":
        if state_cell is None:
            raise ValueError("RNN mode 'lstm' needs state_cell")
        state_cell = fit(state_cell, "state_cell")
    ws, bs = unpack_params(parameters, L, data.shape[2], H, bidirectional,
                           mode)
    x = data
    h_outs, c_outs = [], []
    for layer in range(L):
        outs = []
        for d in range(ndir):
            i = layer * ndir + d
            out, hT, cT = _run_layer(
                x, ws[i][0], ws[i][1], bs[i][0], bs[i][1], state[i],
                state_cell[i] if mode == "lstm" else None, mode, d == 1)
            outs.append(out)
            h_outs.append(hT)
            if cT is not None:
                c_outs.append(cT)
        x = outs[0] if ndir == 1 else torch.cat(outs, dim=2)
        if p > 0.0 and is_train and layer < L - 1:
            x = x * dropout_mask(x, p, (), rng)
    if not state_outputs:
        return x
    if mode == "lstm":
        return x, torch.stack(h_outs), torch.stack(c_outs)
    return x, torch.stack(h_outs)


# ----------------------------------------------------------------------
# sequence ops (ref src/operator/sequence_*.cc; mxnet_tpu/ops/tensor.py)
# ----------------------------------------------------------------------
def _seq_unused(a):
    return () if a.get("use_sequence_length") else ("sequence_length",)


@register("SequenceMask", unused_inputs=_seq_unused)
def sequence_mask(data, sequence_length=None, *, use_sequence_length=False,
                  value=0.0, axis=0):
    """``data`` with every step at or past its sequence's length set to
    ``value``; the sequence axis is ``axis`` (0 or 1), the batch the
    other of the two."""
    if not use_sequence_length or sequence_length is None:
        return data
    ax = int(axis)
    steps = torch.arange(data.shape[ax], device=data.device)
    lens = sequence_length.to(device=data.device, dtype=torch.int64)
    mask = steps[:, None] < lens[None, :]             # (seq, batch)
    if ax == 1:
        mask = mask.t()
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.full((), float(value),
                                              dtype=data.dtype,
                                              device=data.device))


@register("SequenceLast", unused_inputs=_seq_unused)
def sequence_last(data, sequence_length=None, *, use_sequence_length=False,
                  axis=0):
    """Each sequence's last step (its length's, with
    ``use_sequence_length``; a length of 0 takes the last step, as the
    JAX package's index -1 does)."""
    ax = int(axis)
    if not use_sequence_length or sequence_length is None:
        return data.select(ax, data.shape[ax] - 1)
    x = data.movedim(ax, 0)                            # (seq, batch, ...)
    seq = x.shape[0]
    idx = sequence_length.to(device=data.device, dtype=torch.int64) - 1
    idx = torch.where(idx < 0, idx + seq, idx).clamp(0, seq - 1)
    return x[idx, torch.arange(x.shape[1], device=data.device)]


@register("SequenceReverse", unused_inputs=_seq_unused)
def sequence_reverse(data, sequence_length=None, *,
                     use_sequence_length=False, axis=0):
    """The first ``length`` steps of each sequence reversed in place,
    the rest kept; every step reversed without lengths.  The sequence
    axis is 0 whatever ``axis`` says, as in the JAX package."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    seq = data.shape[0]
    steps = torch.arange(seq, device=data.device)[:, None]
    lens = sequence_length.to(device=data.device, dtype=torch.int64)[None, :]
    rev = torch.where(steps < lens, lens - 1 - steps, steps).clamp(0, seq - 1)
    return data[rev, torch.arange(data.shape[1], device=data.device)[None, :]]


# ----------------------------------------------------------------------
# constant fills (ref src/operator/tensor/init_op.cc): the cell zoo's
# begin states (``sym.zeros``)
# ----------------------------------------------------------------------
def _fill(value, shape, dtype, ctx, device):
    from ..base import torch_dtype
    from ..context import current_context
    dev = ctx.torch_device if ctx is not None else (
        device if device is not None else current_context().torch_device)
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype or
                                                             "float32"),
                      device=dev)


@register("_zeros", aliases=("zeros_op",))
def zeros_op(*, shape=(), dtype="float32", ctx=None, device=None):
    """Zeros of ``shape`` on ``ctx`` (in a graph: the walk's device)."""
    return _fill(0.0, shape, dtype, ctx, device)


@register("_ones")
def ones_op(*, shape=(), dtype="float32", ctx=None, device=None):
    """Ones of ``shape`` on ``ctx`` (in a graph: the walk's device)."""
    return _fill(1.0, shape, dtype, ctx, device)
