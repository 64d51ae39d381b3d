"""PyTorch port: the ``mx.rnn`` cell zoo against the JAX package on the
CPU.

Each cell's ``unroll`` (NTC and TNC, merged and not) builds the same
graph in both packages: the same node names letter for letter (the
``{prefix}t{N}_`` step counters, ``reset()``), the same arguments; bound
on the same numpy weights, its outputs and every gradient agree at rtol
2e-5 / atol 1e-6 in f32.  ``FusedRNNCell`` (the fused ``RNN`` op) equals
its ``unfuse()`` stack once the packed vector is unpacked into the
stack's per-gate weights and packed again (``weights.
convert_symbol_params(from_cells=..., to_cells=...)``), and the
pack/unpack round trip is exact.  RNN checkpoints that either package
writes load into the other and give the same outputs.
"""
import json
import random

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.weights import convert_symbol_params

RTOL, ATOL = 2e-5, 1e-6
B, T, I, H = 3, 4, 5, 6


def _cells(pkg, kind):
    r = pkg.rnn
    if kind == "rnn":
        return r.RNNCell(H, prefix="rnn_")
    if kind == "lstm":
        return r.LSTMCell(H, prefix="lstm_")
    if kind == "gru":
        return r.GRUCell(H, prefix="gru_")
    if kind == "stack":
        s = r.SequentialRNNCell()
        s.add(r.LSTMCell(H, prefix="l0_"))
        s.add(r.GRUCell(H, prefix="l1_"))
        return s
    if kind == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(H, prefix="fwd_"),
                                   r.GRUCell(H, prefix="bwd_"))
    if kind == "residual":
        return r.ResidualCell(r.GRUCell(I, prefix="res_"))
    if kind == "zoneout":
        return r.ZoneoutCell(r.LSTMCell(H, prefix="zo_"), 0.0, 0.0)
    if kind == "dropout":
        s = r.SequentialRNNCell()
        s.add(r.LSTMCell(H, prefix="d0_"))
        s.add(r.DropoutCell(0.0, prefix="drop_"))
        s.add(r.RNNCell(H, prefix="d1_"))
        return s
    if kind == "fused":
        return r.FusedRNNCell(H, num_layers=2, mode="lstm", prefix="f_",
                              bidirectional=True)
    raise ValueError(kind)


def _graph(pkg, kind, layout, merge):
    """The cell's unrolled graph, its outputs and last states grouped,
    built in a fresh name scope (auto-named nodes count from 0)."""
    cell = _cells(pkg, kind)
    data = pkg.sym.Variable("data")
    with pkg.base.NameManager():
        outs, states = cell.unroll(T, inputs=data, layout=layout,
                                   merge_outputs=merge)
    flat = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    flat_states = []
    for s in states:
        flat_states.extend(s if isinstance(s, (list, tuple)) else [s])
    return cell, pkg.sym.Group(flat + flat_states)


def _shape(layout):
    return (B, T, I) if layout == "NTC" else (T, B, I)


def _weights(sym, layout, seed):
    rng = np.random.RandomState(seed)
    shapes, _, _ = sym.infer_shape(data=_shape(layout))
    return {n: (rng.randn(*s) * 0.4).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)}


def _run(pkg, sym, values, layout, ctx, seed):
    exe = sym.simple_bind(ctx=ctx, grad_req="write", data=_shape(layout))
    for n, v in values.items():
        exe.arg_dict[n][:] = v
    outs = exe.forward(is_train=True)
    rng = np.random.RandomState(seed)
    cts = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    exe.backward([pkg.nd.array(c, ctx=ctx) for c in cts])
    return ([o.asnumpy() for o in outs],
            {n: g.asnumpy() for n, g in exe.grad_dict.items()
             if g is not None})


def _names(sym):
    return [n["name"] for n in json.loads(sym.tojson())["nodes"]]


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "stack",
                                  "bidirectional", "residual", "zoneout",
                                  "dropout", "fused"])
@pytest.mark.parametrize("layout,merge", [("NTC", True), ("NTC", False),
                                          ("TNC", True), ("TNC", False)])
def test_unroll_matches_jax(kind, layout, merge):
    if kind == "fused" and not merge:
        merge = None         # the fused op's output split per step
    _, jsym = _graph(jmx, kind, layout, merge)
    _, tsym = _graph(mx, kind, layout, merge)
    assert _names(tsym) == _names(jsym)
    assert tsym.list_arguments() == jsym.list_arguments()
    values = _weights(tsym, layout, 3)
    jouts, jgrads = _run(jmx, jsym, values, layout, jmx.cpu(), 4)
    touts, tgrads = _run(mx, tsym, values, layout, mx.cpu(), 4)
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    assert sorted(tgrads) == sorted(jgrads)
    for n in jgrads:
        np.testing.assert_allclose(tgrads[n], jgrads[n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def test_unrolled_lm_json_is_the_jax_string_and_reset_repeats_names():
    def lm(pkg):
        stack = pkg.rnn.SequentialRNNCell()
        for i in range(2):
            stack.add(pkg.rnn.LSTMCell(H, prefix="lstm_l%d_" % i))
        graphs = []
        for seq_len in (3, 5, 3):
            stack.reset()
            emb = pkg.sym.Embedding(pkg.sym.Variable("data"), input_dim=11,
                                    output_dim=I, name="embed")
            out, _ = stack.unroll(seq_len, inputs=emb, merge_outputs=True)
            graphs.append(out)
        return graphs
    with jmx.base.NameManager():
        jg = lm(jmx)
    with mx.base.NameManager():
        tg = lm(mx)
    for j, t in zip(jg, tg):
        assert t.tojson() == j.tojson()
    # reset() restarts the step counters: the cells' nodes of the two
    # 3-step graphs carry the same names
    cells = [[n for n in _names(g) if n.startswith("lstm_")] for g in tg]
    assert cells[0] == cells[2] and cells[0] != cells[1]
    assert "lstm_l1_t2_out" in cells[0] and "lstm_l1_t3_out" not in cells[0]


def test_begin_state_is_batch1_zeros_and_h2h_bias_grad_sums_the_batch():
    cell = mx.rnn.LSTMCell(H, prefix="b_")
    out, _ = cell.unroll(1, inputs=mx.sym.Variable("data"),
                         merge_outputs=True)
    exe = out.simple_bind(ctx=mx.cpu(), grad_req="write", data=(B, 1, I))
    rng = np.random.RandomState(0)
    for n in ("b_i2h_weight", "b_h2h_weight", "b_i2h_bias", "b_h2h_bias"):
        exe.arg_dict[n][:] = rng.randn(*exe.arg_dict[n].shape) * 0.3
    exe.forward(is_train=True, data=rng.randn(B, 1, I).astype(np.float32))
    exe.backward()
    # step 0's h2h reads batch-1 zeros: no weight gradient, and its bias
    # gradient is the i2h bias's (both summed over the broadcast batch)
    assert not exe.grad_dict["b_h2h_weight"].asnumpy().any()
    np.testing.assert_allclose(exe.grad_dict["b_h2h_bias"].asnumpy(),
                               exe.grad_dict["b_i2h_bias"].asnumpy(),
                               rtol=1e-6)
    assert exe.grad_dict["b_h2h_bias"].asnumpy().any()
    assert [s.list_outputs() for s in cell.begin_state()] \
        == [["b_begin_state_2_output"], ["b_begin_state_3_output"]]


@pytest.mark.parametrize("mode,bi", [("lstm", False), ("gru", True),
                                     ("rnn_tanh", True), ("rnn_relu", False)])
def test_fused_equals_unfused_and_weights_cross(mode, bi):
    fused = mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode, bidirectional=bi,
                                prefix="m_")
    fsym, _ = fused.unroll(T, inputs=mx.sym.Variable("data"), layout="TNC",
                           merge_outputs=True)
    stack = fused.unfuse()
    usym, _ = stack.unroll(T, inputs=mx.sym.Variable("data"), layout="TNC",
                           merge_outputs=True)
    shapes = dict(data=(T, B, I))
    rng = np.random.RandomState(1)
    (psize,), = [s for n, s in zip(fsym.list_arguments(),
                                    fsym.infer_shape(**shapes)[0])
                 if n == "m_parameters"]
    packed = {"m_parameters": (rng.randn(psize) * 0.3).astype(np.float32)}
    # fused -> unfused and back, through per-gate arrays
    uargs, _ = convert_symbol_params(packed, {}, mx.cpu(), usym,
                                     from_cells=[fused], to_cells=[stack],
                                     **shapes)
    back, _ = convert_symbol_params(
        {k: v.asnumpy() for k, v in uargs.items()}, {}, mx.cpu(), fsym,
        from_cells=[stack], to_cells=[fused], **shapes)
    np.testing.assert_array_equal(back["m_parameters"].asnumpy(),
                                  packed["m_parameters"])
    x = rng.randn(T, B, I).astype(np.float32)
    outs = []
    for sym, args in ((fsym, packed), (usym, uargs)):
        exe = sym.simple_bind(ctx=mx.cpu(), **shapes)
        exe.copy_params_from(args)
        outs.append(exe.forward(data=x)[0].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["lstm", "gru", "stack", "fused"])
def test_pack_unpack_round_trip_matches_jax(kind):
    tcell, tsym = _graph(mx, kind, "TNC", True)
    jcell, _ = _graph(jmx, kind, "TNC", True)
    args = {n: v for n, v in _weights(tsym, "TNC", 7).items()
            if n != "data"}
    tun = tcell.unpack_weights({k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in args.items()})
    jun = jcell.unpack_weights({k: jmx.nd.array(v) for k, v in args.items()})
    assert sorted(tun) == sorted(jun)
    for k in jun:
        np.testing.assert_array_equal(tun[k].asnumpy(), jun[k].asnumpy())
    # numpy arrays pack and unpack too
    nun = tcell.unpack_weights(args)
    for k in jun:
        np.testing.assert_array_equal(nun[k], jun[k].asnumpy())
    back = tcell.pack_weights(tun)
    assert sorted(back) == sorted(args)
    for k, v in args.items():
        np.testing.assert_array_equal(back[k].asnumpy(), v)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rnn_checkpoints_cross_packages(tmp_path, writer):
    """save_rnn_checkpoint of one package, load_rnn_checkpoint of the
    other: the same per-gate file, the same packed weights, the same
    outputs."""
    def build(pkg):
        cell = pkg.rnn.SequentialRNNCell()
        cell.add(pkg.rnn.LSTMCell(H, prefix="c0_"))
        cell.add(pkg.rnn.GRUCell(H, prefix="c1_"))
        out, _ = cell.unroll(T, inputs=pkg.sym.Variable("data"),
                             merge_outputs=True)
        return cell, out
    # fresh name scopes: the auto-named nodes (activation0, ...) count
    # from 0 in both packages
    with jmx.base.NameManager():
        jcell, jsym = build(jmx)
    with mx.base.NameManager():
        tcell, tsym = build(mx)
    args = {n: v for n, v in _weights(tsym, "NTC", 9).items() if n != "data"}
    prefix = str(tmp_path / "rnn")
    if writer == "jax":
        jmx.rnn.save_rnn_checkpoint(jcell, prefix, 3, jsym,
                                    {k: jmx.nd.array(v)
                                     for k, v in args.items()}, {})
        sym, loaded, _ = mx.rnn.load_rnn_checkpoint(tcell, prefix, 3)
        other = jmx.rnn.load_rnn_checkpoint(jcell, prefix, 3)[1]
    else:
        mx.rnn.save_rnn_checkpoint(tcell, prefix, 3, tsym,
                                   {k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in args.items()}, {})
        sym, other, _ = mx.rnn.load_rnn_checkpoint(tcell, prefix, 3)
        loaded = jmx.rnn.load_rnn_checkpoint(jcell, prefix, 3)[1]
    saved = (jmx if writer == "jax" else mx).nd.load(prefix + "-0003.params")
    assert "arg:c0_i2h_f_weight" in saved and "arg:c0_i2h_weight" not in saved
    assert sorted(loaded) == sorted(other) == sorted(args)
    x = np.random.RandomState(2).randn(B, T, I).astype(np.float32)
    outs = []
    for pkg, s, params, ctx in ((mx, tsym, loaded if writer == "jax"
                                 else other, mx.cpu()),
                                (jmx, jsym, other if writer == "jax"
                                 else loaded, jmx.cpu())):
        exe = s.simple_bind(ctx=ctx, data=(B, T, I))
        for k, v in params.items():
            exe.arg_dict[k][:] = v.asnumpy()
        outs.append(exe.forward(data=x)[0].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=RTOL, atol=ATOL)
    assert [n["name"] for n in json.loads(sym.tojson())["nodes"]] \
        == _names(jsym)


def test_do_rnn_checkpoint_period(tmp_path):
    cell = mx.rnn.LSTMCell(H, prefix="p_")
    out, _ = cell.unroll(2, inputs=mx.sym.Variable("data"),
                         merge_outputs=True)
    rng = random.Random(0)
    args = {n: mx.nd.array(np.full(s, rng.random(), np.float32),
                           ctx=mx.cpu())
            for n, s in zip(out.list_arguments(),
                            out.infer_shape(data=(B, 2, I))[0])
            if n != "data"}
    cb = mx.rnn.do_rnn_checkpoint(cell, str(tmp_path / "ck"), period=2)
    for epoch in range(4):
        cb(epoch, out, args, {})
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.suffix == ".params") == ["ck-0002.params",
                                                "ck-0004.params"]


def test_cell_errors():
    base = mx.rnn.LSTMCell(H, prefix="e_")
    mx.rnn.ZoneoutCell(base, 0.1, 0.1)
    with pytest.raises(RuntimeError, match="modifier"):
        base.begin_state()
    with pytest.raises(TypeError, match="unfuse"):
        mx.rnn.ZoneoutCell(mx.rnn.FusedRNNCell(H), 0.1)
    with pytest.raises(NotImplementedError):
        mx.rnn.FusedRNNCell(H)(mx.sym.Variable("x"), [])
    with pytest.raises(ValueError, match="unroll"):
        mx.rnn.LSTMCell(H).unroll(2, None)
