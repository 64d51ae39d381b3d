"""PyTorch port: gradient mirroring (``MXNET_BACKWARD_DO_MIRROR``).

With the variable set, an executor's train forward keeps only the
walk's inputs and its backward runs the forward again before taking the
gradients, and the fused fit step runs the forward twice inside its
body, as the JAX package's ``jax.checkpoint`` of the whole forward
does.  On the CPU the mirrored and unmirrored runs are equal bit for
bit: the transformer LM with dropout (the masks replay from the step
seed), and a BatchNorm net whose moving statistics move once a step;
the recompute really runs (each kernel's plain version is called once
more); the executor snapshots the variable at bind (two binds of one
symbol around a flip differ, and a flip after a bind changes nothing),
the fused step reads it at each step and keeps a program for each
setting; the port's mirrored steps end on the JAX package's mirrored
ones at 2e-5 / 1e-6.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.models import transformer as jtransformer

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.module import fused_fit
from mxnet_tpu_torch.weights import param_shapes

CFG = dict(num_classes=61, num_layers=2, d_model=32, num_heads=4, seq_len=12)
B, S = 4, 12
MIRROR = "MXNET_BACKWARD_DO_MIRROR"


def _lm_params(seed=41):
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in param_shapes(CFG).items():
        a = (rng.randn(*s) * 0.1).astype(np.float32)
        out[n] = a + 1 if n.endswith("_gamma") else a
    return out


def _tokens(n=2 * B, seed=61):
    x = np.random.RandomState(seed).randint(
        0, CFG["num_classes"], (n, S)).astype(np.float32)
    return x, np.roll(x, -1, axis=1)


def _bn_sym(pkg):
    d = pkg.sym.Variable("data")
    x = pkg.sym.Convolution(d, kernel=(3, 3), num_filter=6, pad=(1, 1),
                            name="conv")
    x = pkg.sym.BatchNorm(x, fix_gamma=False, name="bn")
    x = pkg.sym.Activation(x, act_type="relu")
    x = pkg.sym.Pooling(x, global_pool=True, kernel=(1, 1), pool_type="avg")
    x = pkg.sym.FullyConnected(pkg.sym.Flatten(x), num_hidden=3, name="fc")
    return pkg.sym.SoftmaxOutput(x, name="softmax")


def _bn_params(seed=5):
    rng = np.random.RandomState(seed)
    return {"conv_weight": rng.randn(6, 2, 3, 3) * 0.3,
            "conv_bias": rng.randn(6) * 0.1, "bn_gamma": 1 + rng.randn(6) * 0.1,
            "bn_beta": rng.randn(6) * 0.1, "fc_weight": rng.randn(3, 6) * 0.5,
            "fc_bias": np.zeros(3)}


def _f32(d):
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


def _bn_data(seed=7, n=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 2, 6, 6).astype(np.float32),
            rng.randint(0, 3, (n,)).astype(np.float32))


def _exe_run(monkeypatch, sym, shapes, params, feeds, mirror, seed=3):
    monkeypatch.setenv(MIRROR, mirror)
    exe = sym.simple_bind(ctx=mx.cpu(), grad_req="write", **shapes)
    monkeypatch.delenv(MIRROR)
    exe.copy_params_from(params, {"bn_moving_var": np.ones(6, np.float32)}
                         if "bn_moving_var" in exe.aux_dict else None)
    mx.random.seed(seed)
    out = exe.forward(is_train=True, **feeds)[0].asnumpy()
    exe.backward()
    return exe, out


@pytest.mark.parametrize("net", ["lm_dropout", "batchnorm"])
def test_mirrored_executor_equals_unmirrored(monkeypatch, net):
    """Outputs, every gradient and the auxiliary states of one mirrored
    train step equal the unmirrored step's bit for bit; the mirrored
    backward ran the forward again (the LM's LayerNorm and flash
    forwards once more each), and BatchNorm's moving statistics moved
    once: ``0.9 * init + 0.1 * batch statistic``."""
    if net == "lm_dropout":
        sym = transformer.get_symbol(dropout=0.1, **CFG)
        x, y = _tokens(B)
        shapes = dict(data=(B, S), softmax_label=(B * S,))
        params, feeds = _lm_params(), dict(data=x, softmax_label=y.ravel())
    else:
        sym = _bn_sym(mx)
        x, y = _bn_data()
        shapes = dict(data=x.shape, softmax_label=y.shape)
        params, feeds = _f32(_bn_params()), dict(data=x, softmax_label=y)
    plain, out0 = _exe_run(monkeypatch, sym, shapes, params, feeds, "0")
    before = dict(kernels.PLAIN_CALLS)
    mirrored, out1 = _exe_run(monkeypatch, sym, shapes, params, feeds, "1")
    assert not plain._mirror and mirrored._mirror
    np.testing.assert_array_equal(out0, out1)
    for n, g in plain.grad_dict.items():
        np.testing.assert_array_equal(g.asnumpy(),
                                      mirrored.grad_dict[n].asnumpy(), n)
    for n, a in plain.aux_dict.items():
        np.testing.assert_array_equal(a.asnumpy(),
                                      mirrored.aux_dict[n].asnumpy(), n)
    if net == "lm_dropout":
        # each layer's two LayerNorms and attention, forward and recompute
        L = CFG["num_layers"]
        for k, n in (("layernorm_fused", 2 * (2 * L + 1)),
                     ("flash_attention_fwd", 2 * L)):
            assert kernels.PLAIN_CALLS[k] - before.get(k, 0) == n, k
    else:
        # the batch mean of the convolution's output, per channel
        c = torch.nn.functional.conv2d(
            torch.from_numpy(x), torch.from_numpy(params["conv_weight"]),
            torch.from_numpy(params["conv_bias"]), padding=1)
        conv = c.double().mean(dim=(0, 2, 3)).numpy()
        np.testing.assert_allclose(mirrored.aux_dict["bn_moving_mean"]
                                   .asnumpy(), 0.1 * conv, rtol=1e-5,
                                   atol=1e-7)


def test_bind_snapshots_the_variable(monkeypatch):
    """Two binds of one symbol around a flip of the variable differ, a
    flip after a bind leaves the executor as it was, and the two give
    the same gradients (the JAX package's
    test_backward_do_mirror_is_a_fwd_bwd_cache_key)."""
    sym = _bn_sym(mx)
    x, y = _bn_data()
    shapes = dict(data=x.shape, softmax_label=y.shape)
    monkeypatch.delenv(MIRROR, raising=False)
    e0 = sym.simple_bind(ctx=mx.cpu(), grad_req="write", **shapes)
    monkeypatch.setenv(MIRROR, "1")
    e1 = sym.simple_bind(ctx=mx.cpu(), grad_req="write", **shapes)
    assert e0._mirror is False and e1._mirror is True
    monkeypatch.setenv(MIRROR, "0")
    assert e1._mirror is True
    for e in (e0, e1):
        e.copy_params_from(_f32(_bn_params()))
        e.forward(is_train=True, data=x, softmax_label=y)
        assert (e._recompute is not None) == e._mirror
        assert (e._heads is not None) != e._mirror
        e.backward()
        assert e._recompute is None and e._heads is None
    for n, g in e0.grad_dict.items():
        np.testing.assert_array_equal(g.asnumpy(), e1.grad_dict[n].asnumpy())
    with pytest.raises(mx.MXNetError):
        e1.backward()


def test_inference_forward_keeps_nothing_for_a_backward(monkeypatch):
    """A mirrored executor's inference forward records nothing."""
    monkeypatch.setenv(MIRROR, "1")
    sym = _bn_sym(mx)
    x, y = _bn_data()
    exe = sym.simple_bind(ctx=mx.cpu(), grad_req="write", data=x.shape,
                          softmax_label=y.shape)
    exe.forward(is_train=False, data=x, softmax_label=y)
    assert exe._recompute is None
    with pytest.raises(mx.MXNetError):
        exe.backward()


class _Flat:
    def __init__(self, it):
        self.it = it

    @property
    def provide_data(self):
        return self.it.provide_data

    @property
    def provide_label(self):
        return [mx.io.DataDesc(d.name, (int(np.prod(d.shape)),))
                for d in self.it.provide_label]

    def __iter__(self):
        return self

    def __next__(self):
        b = next(self.it)
        return mx.io.DataBatch(data=b.data, label=[
            mx.nd.NDArray(x._data.reshape(-1)) for x in b.label], pad=b.pad)

    def reset(self):
        self.it.reset()


def _fit(monkeypatch, net, mirror, fused=True, pkg=mx, dropout=0.1):
    monkeypatch.setenv(MIRROR, mirror)
    arr = (lambda v: pkg.nd.array(v, ctx=pkg.cpu())) if pkg is mx \
        else pkg.nd.array
    pkg.random.seed(3)
    if net == "lm":
        x, y = _tokens()
        sym = (transformer if pkg is mx else jtransformer).get_symbol(
            dropout=dropout, **CFG)
        it = pkg.io.NDArrayIter(x, y, batch_size=B)
        it = _Flat(it) if pkg is mx else _JFlat(it)
        params, aux = _lm_params(), {}
    else:
        x, y = _bn_data(n=16)
        sym = _bn_sym(pkg)
        it = pkg.io.NDArrayIter(x, y, batch_size=8)
        params = _f32(_bn_params())
        aux = {"bn_moving_mean": np.zeros(6, np.float32),
               "bn_moving_var": np.ones(6, np.float32)}
    mod = pkg.Module(sym, context=pkg.cpu())
    mod._fused_fit_enabled = fused
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.2, "momentum": 0.9,
                              "wd": 1e-3},
            arg_params={k: arr(v) for k, v in params.items()},
            aux_params={k: arr(v) for k, v in aux.items()},
            eval_metric="acc")
    monkeypatch.delenv(MIRROR)
    args, auxs = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()}, mod)


class _JFlat(_Flat):
    def __next__(self):
        b = next(self.it)
        return jmx.io.DataBatch(data=b.data, label=[
            jmx.nd.array(x.asnumpy().reshape(-1)) for x in b.label],
            pad=b.pad)


@pytest.mark.parametrize("net", ["lm", "batchnorm"])
def test_mirrored_fused_fit_equals_unmirrored(monkeypatch, net):
    """Module.fit's fused step under the variable (the LM with dropout,
    the BatchNorm net) ends bit-equal to the unmirrored fused step and
    to the mirrored eager pair: one program each (the setting is part of
    its key), the masks replayed, the moving statistics moved once a
    step."""
    before = fused_fit.TRACE_COUNT
    a0, x0, m0 = _fit(monkeypatch, net, "0")
    a1, x1, m1 = _fit(monkeypatch, net, "1")
    e1, y1, _ = _fit(monkeypatch, net, "1", fused=False)
    assert fused_fit.TRACE_COUNT - before == 2
    assert m0._fused_fit.launches == m1._fused_fit.launches == 4
    assert [k[-1] for k in m1._fused_fit._programs] == [True]
    for ref in ((a0, x0), (e1, y1)):
        for got, want in zip((a1, x1), ref):
            for k, v in want.items():
                assert np.isfinite(got[k]).all(), k
                np.testing.assert_array_equal(got[k], v, k)


def test_flipping_the_variable_mid_fit_takes_another_program(monkeypatch):
    """The fused step reads the variable at each step (as the JAX
    package's does): a flip between two fit calls on one module builds a
    second program, and the steps go on from where they were."""
    _, _, mod = _fit(monkeypatch, "batchnorm", "0")
    x, y = _bn_data(n=8, seed=9)
    monkeypatch.setenv(MIRROR, "1")
    before = fused_fit.TRACE_COUNT
    mod.fit_step(mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                                 label=[mx.nd.array(y, ctx=mx.cpu())]))
    assert fused_fit.TRACE_COUNT - before == 1
    assert sorted(k[-1] for k in mod._fused_fit._programs) == [False, True]


@pytest.mark.parametrize("net", ["lm", "batchnorm"])
def test_mirrored_fit_matches_the_jax_package(monkeypatch, net):
    """The port's mirrored fused steps against the JAX package's mirrored
    fused program (``jax.checkpoint``), f32, no dropout (the packages'
    random streams differ): weights and moving statistics at 2e-5 /
    1e-6."""
    args, auxs, _ = _fit(monkeypatch, net, "1", dropout=0.0)
    jargs, jauxs, _ = _fit(monkeypatch, net, "1", pkg=jmx, dropout=0.0)
    for got, want in ((args, jargs), (auxs, jauxs)):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=2e-5, atol=1e-6,
                                       err_msg=k)
