"""PyTorch port: bucketed LM training against the JAX package on the CPU.

``encode_sentences`` and ``BucketSentenceIter`` give the JAX package's
ids and batches (one seed of Python's and numpy's global streams);
``LSTMBias`` and ``FusedRNN`` fill the JAX package's arrays;
``bind(shared_module=...)`` shares the arrays themselves and gives a
name whose shape differs zeros of its own; and ``BucketingModule.fit``
over three buckets in a mixed order, through ``kvstore='device'`` with
and without 2-bit compression, ends every batch on the JAX
``BucketingModule``'s weights from the same initial weights, at rtol
2e-5 / atol 1e-6, in both the graph arm (the fused fit step: on the CPU
its body runs eagerly, one program a bucket) and the eager arm
(``MXNET_FIT_FUSED=0``), with the step cells and with the fused ``RNN``
op (``FusedRNNCell``).  The JAX side's 2-bit quantizer runs its Pallas
kernel in interpret mode (``MXNET_Q2BIT_IMPL=pallas``).
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.module import fused_fit

RTOL, ATOL = 2e-5, 1e-6
V, E, H, B = 13, 6, 8, 4
BUCKETS = (4, 6, 8)
ORDER = (8, 4, 8, 6, 4, 6, 8)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("MXNET_FIT_FUSED", "MXNET_FIT_SYNC_EVERY",
              "MXNET_SENTINEL_NUMERICS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXNET_Q2BIT_IMPL", "pallas")


def _sentences(n=60, seed=3):
    rng = np.random.RandomState(seed)
    words = ["w%d" % i for i in range(20)]
    return [[words[j] for j in rng.randint(0, 20, rng.randint(2, 9))]
            for _ in range(n)]


def test_encode_sentences_matches_jax():
    sents = _sentences()
    for kw in (dict(invalid_label=0, invalid_key="\n", start_label=1),
               dict(invalid_label=-1, start_label=0)):
        got = mx.rnn.encode_sentences(sents, **kw)
        want = jmx.rnn.encode_sentences(sents, **kw)
        assert got == want
    vocab = got[1]
    assert mx.rnn.encode_sentences(sents[:3], vocab=vocab)[0] == got[0][:3]
    with pytest.raises(ValueError, match="unknown token"):
        mx.rnn.encode_sentences([["nope"]], vocab=vocab)


@pytest.mark.parametrize("buckets", [[4, 6, 8], None])
def test_bucket_sentence_iter_gives_the_jax_batches(buckets):
    encoded, _ = mx.rnn.encode_sentences(_sentences(), invalid_label=0,
                                         start_label=1)
    batches = {}
    for name, pkg in (("port", mx), ("jax", jmx)):
        random.seed(11)
        np.random.seed(11)
        it = pkg.rnn.BucketSentenceIter(encoded, B, buckets=buckets,
                                        invalid_label=0)
        out = []
        for epoch in range(2):
            for b in it:
                out.append((b.bucket_key, b.data[0].asnumpy(),
                            b.label[0].asnumpy(),
                            [tuple(d.shape) for d in b.provide_data],
                            [tuple(d.shape) for d in b.provide_label]))
            it.reset()
        batches[name] = (out, it.default_bucket_key,
                         [tuple(d.shape) for d in it.provide_data])
    got, want = batches["port"], batches["jax"]
    assert got[1:] == want[1:]
    assert len(got[0]) == len(want[0]) > 4
    for g, w in zip(got[0], want[0]):
        assert g[0] == w[0] and g[3:] == w[3:]
        assert g[1].dtype == w[1].dtype == np.float32
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        # labels: the data shifted left by one, the pad label last
        np.testing.assert_array_equal(g[2][:, :-1], g[1][:, 1:])
        assert (g[2][:, -1] == 0).all()


def test_lstm_bias_and_fused_rnn_match_jax():
    for fb in (1.0, 2.5):
        got = mx.nd.zeros((4 * 5,), ctx=mx.cpu())
        want = jmx.nd.zeros((4 * 5,))
        mx.init.LSTMBias(forget_bias=fb)("x_i2h_bias", got)
        jmx.init.LSTMBias(forget_bias=fb)("x_i2h_bias", want)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert mx.initializer.create("lstmbias", forget_bias=2.0).forget_bias \
        == 2.0
    for mode, layers, bi in (("lstm", 2, False), ("gru", 1, True),
                             ("rnn_tanh", 2, True)):
        size = mx.ops.rnn.rnn_param_size(layers, 7, 5, bi, mode)
        got = mx.nd.zeros((size,), ctx=mx.cpu())
        want = jmx.nd.zeros((size,))
        np.random.seed(21)
        mx.init.FusedRNN(None, 5, layers, mode, bi, 1.5)._init_weight(
            "p_parameters", got)
        np.random.seed(21)
        jmx.init.FusedRNN(None, 5, layers, mode, bi, 1.5)._init_weight(
            "p_parameters", want)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    # the port's FusedRNN keeps its arguments, so the variable's
    # __init__ attribute resolves (the JAX package's writes {})
    cell = mx.rnn.FusedRNNCell(5, num_layers=2, prefix="f_")
    out, _ = cell.unroll(3, inputs=mx.sym.Variable("data"),
                         merge_outputs=True)
    mod = mx.mod.Module(out, label_names=None, context=mx.cpu())
    mod.bind(data_shapes=[("data", (2, 3, 7))])
    np.random.seed(4)
    mod.init_params(mx.init.Xavier())
    packed = mod.get_params()[0]["f_parameters"].asnumpy()
    want = jmx.nd.zeros(packed.shape)
    np.random.seed(4)
    jmx.init.FusedRNN(None, 5, 2, "lstm")._init_weight("f_parameters", want)
    np.testing.assert_array_equal(packed, want.asnumpy())


def test_bind_shared_module_shares_arrays_and_zeros_a_reshaped_name():
    def net(width):
        data = mx.sym.Variable("data")
        fc = mx.sym.FullyConnected(data, num_hidden=5, name="fc")
        return mx.sym.FullyConnected(fc, num_hidden=3, name="out")
    a = mx.mod.Module(net(8), label_names=None, context=mx.cpu())
    a.bind(data_shapes=[("data", (4, 8))])
    a.init_params(mx.init.Uniform(0.5))
    b = mx.mod.Module(net(3), label_names=None, context=mx.cpu())
    b.bind(data_shapes=[("data", (4, 3))], shared_module=a)
    assert b.params_initialized and b._fit_family() is a
    ea, eb = a._exec_group._exec, b._exec_group._exec
    for name in ("fc_bias", "out_weight", "out_bias"):
        assert eb.arg_dict[name] is ea.arg_dict[name]
        assert eb.grad_dict[name] is ea.grad_dict[name]
    # fc_weight is (5, 8) in a and (5, 3) in b: b's own zeros, as the
    # JAX executor gives (mxnet_tpu/executor.py:887-891)
    assert eb.arg_dict["fc_weight"] is not ea.arg_dict["fc_weight"]
    assert eb.arg_dict["fc_weight"].shape == (5, 3)
    assert not eb.arg_dict["fc_weight"].asnumpy().any()
    jd = {}
    for pkg, ctx in ((jmx, jmx.cpu()),):
        data = pkg.sym.Variable("data")
        sym = pkg.sym.FullyConnected(pkg.sym.FullyConnected(
            data, num_hidden=5, name="fc"), num_hidden=3, name="out")
        ja = pkg.mod.Module(sym, label_names=None, context=ctx)
        ja.bind(data_shapes=[("data", (4, 8))])
        ja.init_params(pkg.init.Uniform(0.5))
        jb = pkg.mod.Module(sym, label_names=None, context=ctx)
        jb.bind(data_shapes=[("data", (4, 3))], shared_module=ja)
        jd = jb._exec_group.execs[0].arg_dict
    assert not jd["fc_weight"].asnumpy().any()
    with pytest.raises(mx.MXNetError, match="bound Module"):
        b2 = mx.mod.Module(net(3), label_names=None, context=mx.cpu())
        b2.bind(data_shapes=[("data", (4, 3))], shared_module=object())
    # a is given an optimizer: a module bound over it later borrows it
    a.init_optimizer(optimizer="sgd")
    c = mx.mod.Module(net(8), label_names=None, context=mx.cpu())
    c.bind(data_shapes=[("data", (2, 8))], shared_module=a)
    assert c.optimizer_initialized and c._updater is a._updater


# ----------------------------------------------------------------------
# BucketingModule.fit against the JAX package
# ----------------------------------------------------------------------
class _Batches:
    """Fixed bucketed batches (the data's ids, labels shifted by one)."""

    def __init__(self, pkg, batches):
        self.pkg, self.batches, self.i = pkg, batches, 0
        self.batch_size = B
        self.default_bucket_key = max(BUCKETS)
        self.provide_data = [("data", (B, max(BUCKETS)))]
        self.provide_label = [("softmax_label", (B, max(BUCKETS)))]

    def __iter__(self):
        return self

    def reset(self):
        self.i = 0

    def __next__(self):
        if self.i == len(self.batches):
            raise StopIteration
        key, x, y = self.batches[self.i]
        self.i += 1
        kw = {} if self.pkg is jmx else {"ctx": mx.cpu()}
        return self.pkg.io.DataBatch(
            data=[self.pkg.nd.array(x, **kw)],
            label=[self.pkg.nd.array(y, **kw)], bucket_key=key, pad=0,
            provide_data=[self.pkg.io.DataDesc("data", (B, key))],
            provide_label=[self.pkg.io.DataDesc("softmax_label", (B, key))])

    next = __next__


def _batches(seed):
    rng = np.random.RandomState(seed)
    out = []
    for key in ORDER:
        x = rng.randint(1, V, (B, key)).astype(np.float32)
        for row in range(B):          # pads at the ends of some rows
            x[row, key - rng.randint(0, 3):] = 0
        y = np.zeros_like(x)
        y[:, :-1] = x[:, 1:]
        out.append((key, x, y))
    return out


def _sym_gen(pkg, fused):
    if fused:
        cell = pkg.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                    prefix="lstm_")
    else:
        cell = pkg.rnn.SequentialRNNCell()
        for i in range(2):
            cell.add(pkg.rnn.LSTMCell(H, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=V, output_dim=E,
                                  name="embed")
        cell.reset()
        out, _ = cell.unroll(seq_len, inputs=embed, layout="NTC",
                             merge_outputs=True)
        pred = pkg.sym.FullyConnected(pkg.sym.Reshape(out, shape=(-1, H)),
                                      num_hidden=V, name="pred")
        pred = pkg.sym.SoftmaxOutput(pred, pkg.sym.Reshape(label,
                                                           shape=(-1,)),
                                     use_ignore=True, ignore_label=0,
                                     name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def _initial(fused, seed=5):
    sym = _sym_gen(mx, fused)(max(BUCKETS))[0]
    shapes, _, _ = sym.infer_shape(data=(B, max(BUCKETS)),
                                   softmax_label=(B, max(BUCKETS)))
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _fit(pkg, fused, threshold, initial, batches):
    comp = None if threshold is None else {"type": "2bit",
                                           "threshold": threshold}
    ctx = jmx.cpu() if pkg is jmx else mx.cpu()
    mod = pkg.mod.BucketingModule(_sym_gen(pkg, fused),
                                  default_bucket_key=max(BUCKETS),
                                  context=ctx, compression_params=comp)
    arr = {k: (pkg.nd.array(v) if pkg is jmx
               else mx.nd.array(v, ctx=mx.cpu()))
           for k, v in initial.items()}
    seen = []

    def on_batch(_param):
        seen.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})

    metric = pkg.metric.Perplexity(ignore_label=0)
    mod.fit(_Batches(pkg, batches), eval_metric=metric,
            kvstore=pkg.kv.create("device"), optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params=arr, num_epoch=1, batch_end_callback=on_batch)
    return mod, seen, metric.get()[1]


@pytest.mark.parametrize("fused_op", [False, True], ids=["cells", "rnn_op"])
@pytest.mark.parametrize("threshold", [None, 0.5], ids=["dense", "2bit"])
@pytest.mark.parametrize("arm", ["graph", "eager"])
def test_bucketing_fit_matches_jax(monkeypatch, arm, threshold, fused_op):
    if arm == "eager":
        monkeypatch.setenv("MXNET_FIT_FUSED", "0")
    initial = _initial(fused_op)
    batches = _batches(7)
    traces = fused_fit.TRACE_COUNT
    tmod, tseen, tppl = _fit(mx, fused_op, threshold, initial, batches)
    monkeypatch.delenv("MXNET_FIT_FUSED", raising=False)
    _, jseen, jppl = _fit(jmx, fused_op, threshold, initial, batches)
    assert len(tseen) == len(jseen) == len(ORDER)
    for step, (t, j) in enumerate(zip(tseen, jseen)):
        assert sorted(t) == sorted(j)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL, atol=ATOL,
                                       err_msg="batch %d %s" % (step, k))
    assert np.isfinite(tppl)
    np.testing.assert_allclose(tppl, jppl, rtol=1e-5)
    buckets = tmod.buckets
    assert sorted(buckets) == sorted(BUCKETS)
    default = buckets[max(BUCKETS)]
    for key, m in buckets.items():
        assert m._fit_family() is default
        assert m._kvstore is default._kvstore
    fused = default._fused_fit
    if arm == "graph":
        # every batch ran in the default bucket's step, one program a
        # bucket, all in one graph pool
        assert fused is not None and fused.launches == len(ORDER)
        assert fused_fit.TRACE_COUNT - traces == len(BUCKETS)
        assert len({id(p.program.pool) for p in fused._programs.values()}) \
            == 1
    else:
        assert fused is None and fused_fit.TRACE_COUNT == traces


def test_bucketing_arms_agree_and_weights_move_once_a_step(monkeypatch):
    """The graph arm and the eager arm leave the same weights, and the
    optimizer's update count is one a batch, whatever the bucket."""
    initial = _initial(False)
    batches = _batches(8)
    runs = {}
    for arm in ("graph", "eager"):
        if arm == "eager":
            monkeypatch.setenv("MXNET_FIT_FUSED", "0")
        mod, seen, _ = _fit(mx, False, 0.5, initial, batches)
        runs[arm] = seen[-1]
        opt = mod.buckets[max(BUCKETS)]._optimizer
        assert opt.num_update == len(ORDER)
    for k, v in runs["eager"].items():
        np.testing.assert_allclose(runs["graph"][k], v, rtol=1e-6,
                                   atol=1e-7)


def test_bucketing_module_surface():
    sym_gen = _sym_gen(mx, False)
    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                 context=mx.cpu())
    assert mod.data_names == ("data",)
    with pytest.raises(ValueError, match="default_bucket_key"):
        mx.mod.BucketingModule(sym_gen)
    with pytest.raises(mx.MXNetError, match="switching"):
        mod.switch_bucket(4, [("data", (B, 4))])
    mod.bind(data_shapes=[("data", (B, 8))],
             label_shapes=[("softmax_label", (B, 8))])
    mod.init_params(mx.init.Xavier())
    batch = next(iter(_Batches(mx, _batches(2))))
    mod.prepare(_Batches(mx, [(4,) + _batches(2)[1][1:]]).__next__())
    assert sorted(mod.buckets) == [4, 8] and mod._active_key == 8
    mod.forward(batch, is_train=False)
    assert mod.get_outputs()[0].shape == (B * 8, V)
    assert mod.output_shapes == [("softmax_output", (B * 8, V))]
    args, _ = mod.get_params()
    mod.set_params({k: v * 0 for k, v in args.items()}, {})
    assert not mod.get_params()[0]["pred_weight"].asnumpy().any()
    with pytest.raises(mx.MXNetError, match="ROADMAP A.9"):
        mod.install_monitor(object())
    with pytest.raises(mx.MXNetError, match="ROADMAP A.8"):
        mx.mod.BucketingModule(sym_gen, default_bucket_key=8,
                               group2ctxs=[{}])
