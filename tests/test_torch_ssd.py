"""PyTorch port: SSD (BASELINE config 5) against the JAX package, and the
repaired symbol indexing.

- ``Symbol[name]``, ``Symbol[slice]`` and ``get_internals()`` give the
  JAX package's entries (the parent took positions only: a name raised
  ``TypeError``, and ``get_internals`` did not exist).
- The example's SSD symbol (example/ssd, example/torch/ssd) trained two
  ``Module.fit`` steps in both packages from the same numpy weights:
  before each step the MultiBoxTarget classes of both packages are
  equal (where they are not, the message gives each differing image's
  gap between the k-th and (k+1)-th mining scores, so a near-tie can be
  told from a fault), the losses within rtol 2e-5 / atol 1e-6 and every
  weight's move within rtol 2e-5 of the JAX package's, plus four ulps of
  the weight (a move is the difference of two rounded weights).
- SSD300 (``chip_smoke.ssd300_symbol``) composed in both packages: the
  same arguments, internals and inferred shapes (8732 anchors), the
  scale variable's ``__init__`` and ``__wd_mult__`` honoured by both
  initializers and optimizers, its weights carried by
  ``weights.convert_symbol_params``; its head (normalization, scale,
  predictions, anchors, target, losses, detection) on random features at
  the six maps' shapes, forward and backward, at rtol 2e-5 / atol 1e-6.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.base import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError, NameManager
from mxnet_tpu_torch.weights import convert_symbol_params, symbol_shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

RTOL, ATOL = 2e-5, 1e-6


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JEX = _load("example/ssd/train_ssd.py", "jax_train_ssd")
PEX = _load("example/torch/ssd/train_ssd.py", "port_train_ssd")


# ----------------------------------------------------------------------
# symbol indexing
# ----------------------------------------------------------------------
def test_symbol_indexing_by_name_and_slice_matches_jax():
    with JNameManager():
        jnet = chip_smoke.ssd300_symbol(jmx)
    with NameManager():
        pnet = chip_smoke.ssd300_symbol(mx)
    ji, pi = jnet.get_internals(), pnet.get_internals()
    assert pi.list_outputs() == ji.list_outputs()
    assert "relu4_3_output" in pi.list_outputs()
    shapes = dict(data=(1, 3, 300, 300))
    j43, p43 = ji["relu4_3_output"], pi["relu4_3_output"]
    assert p43.list_outputs() == j43.list_outputs() == ["relu4_3_output"]
    assert p43.list_arguments() == j43.list_arguments()
    assert p43.infer_shape(**shapes)[1] == [(1, 512, 38, 38)]
    assert pnet[1:3].list_outputs() == jnet[1:3].list_outputs() \
        == ["loc_loss_output", "cls_label_output"]
    assert pnet["cls_prob_output"].list_outputs() == ["cls_prob_output"]
    assert pnet[-1].list_outputs() == jnet[-1].list_outputs()
    with pytest.raises(MXNetError, match="output 'relu9_output' not found"):
        pnet["relu9_output"]
    # the parent indexed its entry list with the name itself
    with pytest.raises(TypeError):
        pnet._entries["relu4_3_output"]


def test_feature_extractor_binds_from_internals():
    """A classifier's inner layer as a network of its own, bound and run
    (the MXNet feature-extraction idiom) on the same weights in both
    packages."""
    from mxnet_tpu import models as jmodels
    from mxnet_tpu_torch import models
    with JNameManager():
        jfeat = jmodels.get_symbol("vgg", num_classes=10, num_layers=11) \
            .get_internals()["relu4_2_output"]
    with NameManager():
        pfeat = models.get_symbol("vgg", num_classes=10, num_layers=11) \
            .get_internals()["relu4_2_output"]
    shapes = dict(data=(2, 3, 32, 32))
    arg_shapes = dict(zip(pfeat.list_arguments(),
                          pfeat.infer_shape(**shapes)[0]))
    arrays = chip_smoke.seeded_weights(arg_shapes, seed=0)
    arrays["data"] = np.random.RandomState(1).rand(*shapes["data"]) \
        .astype(np.float32)
    jexe = jfeat.simple_bind(ctx=jmx.cpu(), **shapes)
    for k, v in jexe.arg_dict.items():
        v[:] = arrays[k]
    pexe = pfeat.simple_bind(ctx=mx.cpu(), **shapes)
    pexe.copy_params_from({k: mx.nd.array(v, ctx=mx.cpu())
                           for k, v in arrays.items() if k != "data"})
    want = jexe.forward()[0].asnumpy()
    got = pexe.forward(data=mx.nd.array(arrays["data"],
                                        ctx=mx.cpu()))[0].asnumpy()
    assert got.shape == (2, 512, 4, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * float(np.abs(want).max()))


# ----------------------------------------------------------------------
# the example's SSD, two Module.fit steps
# ----------------------------------------------------------------------
def _target_node(sym):
    return next(n for n in sym._topo()
                if not n.is_var and n.op.name == "_contrib_MultiBoxTarget")


def _internal_runs(pkg, sym, ctx, params, batch):
    """The example's class predictions and MultiBoxTarget classes from
    ``params`` on ``batch`` (data, label), by ``get_internals``."""
    node = _target_node(sym)
    pred_node, idx = node.inputs[2]
    names = [pred_node.output_name(idx), node.output_name(2)]
    out = pkg.sym.Group([sym.get_internals()[n] for n in names])
    x, y = batch
    exe = out.simple_bind(ctx=ctx, data=x.shape, label=y.shape)
    kw = {} if ctx is None else {"ctx": ctx}
    exe.copy_params_from({k: pkg.nd.array(v, **kw)
                          for k, v in params.items() if k in exe.arg_dict})
    outs = exe.forward(data=pkg.nd.array(x, **kw),
                       label=pkg.nd.array(y, **kw))
    return [o.asnumpy() for o in outs]


def _mining_gaps(pred, cls_t, labels, anchors, ratio=3.0, thresh=0.5):
    """Per image: the gap between the k-th and (k+1)-th scores of the
    eligible anchors (k = ratio x positives), the scores as MultiBoxTarget
    ranks them (1 - softmax(pred)[0])."""
    e = np.exp(pred - pred.max(1, keepdims=True))
    score = 1.0 - e[:, 0] / e.sum(1)
    gaps = []
    for b in range(len(cls_t)):
        lab = labels[b][labels[b][:, 0] >= 0]
        best = chip_smoke._box_iou(anchors, lab[:, 1:5]).max(1)
        eligible = (cls_t[b] <= 0) & (best < thresh)
        s = np.sort(score[b][eligible])[::-1]
        k = int(ratio * (cls_t[b] > 0).sum())
        gaps.append(float(s[k - 1] - s[k]) if 0 < k < len(s) else None)
    return gaps


def test_example_ssd_two_fit_steps_match_jax():
    X, Y = JEX.make_dataset(32)
    PX, PY = PEX.make_dataset(32)
    np.testing.assert_array_equal(X, PX)
    np.testing.assert_array_equal(Y, PY)
    with JNameManager():
        jsym = JEX.ssd_symbol()
    with NameManager():
        psym = PEX.ssd_symbol()
    assert psym.list_arguments() == jsym.list_arguments()
    assert psym.list_outputs() == jsym.list_outputs()
    shapes = dict(data=(16,) + X.shape[1:], label=(16,) + Y.shape[1:])
    params = chip_smoke.seeded_weights(symbol_shapes(psym, **shapes)[0],
                                         seed=11)
    opt = {"learning_rate": 0.01, "momentum": 0.9}
    fit = dict(num_epoch=1, optimizer="sgd", optimizer_params=opt)
    batches = [(X[:16], Y[:16]), (X[16:], Y[16:])]
    jmod = jmx.Module(jsym, data_names=("data",), label_names=("label",),
                      context=jmx.cpu())
    pmod = mx.Module(psym, data_names=("data",), label_names=("label",),
                     context=mx.cpu())
    jstate, pstate = [dict(params)], [dict(params)]
    jloss, ploss = [], []

    def jcb(_):
        jstate.append({k: v.asnumpy() for k, v in
                       jmod.get_params()[0].items()})
        jloss.append(jmod.get_outputs()[1].asnumpy())

    def pcb(_):
        pstate.append({k: v.asnumpy() for k, v in
                       pmod.get_params()[0].items()})
        ploss.append(pmod.get_outputs()[1].asnumpy())

    jmod.fit(jmx.io.NDArrayIter({"data": X}, {"label": Y}, batch_size=16),
             arg_params={k: jmx.nd.array(v) for k, v in params.items()},
             eval_metric=jmx.metric.Loss(output_names=["loc_loss_output"]),
             batch_end_callback=jcb, **fit)
    pmod.fit(mx.io.NDArrayIter({"data": X}, {"label": Y}, batch_size=16),
             arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                         for k, v in params.items()},
             eval_metric=mx.metric.Loss(output_names=["loc_loss_output"]),
             batch_end_callback=pcb, **fit)
    assert len(jstate) == len(pstate) == 3
    for step, batch in enumerate(batches):
        jpred, jcls = _internal_runs(jmx, jsym, None, jstate[step], batch)
        ppred, pcls = _internal_runs(mx, psym, mx.cpu(), pstate[step], batch)
        if not np.array_equal(pcls, jcls):
            anc = _example_anchors(batch[0])
            bad = np.nonzero((pcls != jcls).any(1))[0]
            gaps = _mining_gaps(jpred, jcls, batch[1], anc)
            pytest.fail("step %d: MultiBoxTarget classes differ in images %s;"
                        " k-th to (k+1)-th mining score gaps %s"
                        % (step + 1, bad.tolist(), [gaps[i] for i in bad]))
        assert (pcls > 0).any() and (pcls == 0).any() and (pcls == -1).any()
        np.testing.assert_allclose(ploss[step], jloss[step], rtol=RTOL,
                                   atol=ATOL)
        for k in params:
            jmove = jstate[step + 1][k] - jstate[step][k]
            pmove = pstate[step + 1][k] - pstate[step][k]
            # a move is the difference of two rounded weights: four
            # ulps of the largest weight besides the relative bound
            ulp = float(np.spacing(np.abs(jstate[step + 1][k]).max()))
            np.testing.assert_allclose(
                pmove, jmove, rtol=RTOL,
                atol=max(ATOL * float(np.abs(jmove).max()), 4 * ulp),
                err_msg="step %d %s" % (step + 1, k))


def _example_anchors(x):
    """The example's anchors (A, 4) for images ``x``: its 4 x 4 map."""
    import torch
    from mxnet_tpu_torch.ops.registry import get_op
    feat = torch.zeros(1, 1, x.shape[2] // 8, x.shape[3] // 8)
    return get_op("MultiBoxPrior").fn(feat, sizes=(0.4, 0.6),
                                      ratios=(1.0,))[0].numpy()


# ----------------------------------------------------------------------
# SSD300
# ----------------------------------------------------------------------
SSD300_SHAPES = dict(data=(2, 3, 300, 300), label=(2, 8, 5))


def test_ssd300_composes_as_in_jax():
    with JNameManager():
        jnet = chip_smoke.ssd300_symbol(jmx)
    with NameManager():
        pnet = chip_smoke.ssd300_symbol(mx)
    assert pnet.list_arguments() == jnet.list_arguments()
    assert pnet.list_outputs() == jnet.list_outputs()
    assert pnet.list_auxiliary_states() == jnet.list_auxiliary_states() == []
    ja, jo, _ = jnet.infer_shape(**SSD300_SHAPES)
    pa, po, _ = pnet.infer_shape(**SSD300_SHAPES)
    assert [tuple(s) for s in pa] == [tuple(s) for s in ja]
    assert [tuple(s) for s in po] == [tuple(s) for s in jo] == [
        (2, 21, 8732), (2, 8732 * 4), (2, 8732), (2, 8732, 6)]
    anchors = pnet.get_internals()["multibox_anchors_output"]
    assert anchors.infer_shape(data=(2, 3, 300, 300))[1] == [(1, 8732, 4)]
    maps = [pnet.get_internals()[n + "_output"].infer_shape(
        data=(2, 3, 300, 300))[1][0][2] for n in
        ["relu4_3", "relu7"] + ["multi_feat_%d_conv_3x3_relu" % k
                                for k in range(2, 6)]]
    assert maps == list(chip_smoke.SSD300["maps"])
    assert pnet.attr_dict()["relu4_3_scale"] == \
        jnet.attr_dict()["relu4_3_scale"]


def test_ssd300_scale_init_wd_mult_and_weights():
    """The scale variable's ``__init__`` (20) through each package's
    ``init_params``, its ``__wd_mult__`` (0.1) in each optimizer, and
    every weight carried by ``convert_symbol_params``."""
    with JNameManager():
        jnet = chip_smoke.ssd300_symbol(jmx)
    with NameManager():
        pnet = chip_smoke.ssd300_symbol(mx)
    shapes = dict(data=(1, 3, 300, 300), label=(1, 8, 5))
    for pkg, net, ctx in ((jmx, jnet, jmx.cpu()), (mx, pnet, mx.cpu())):
        mod = pkg.Module(net, data_names=("data",), label_names=("label",),
                         context=ctx)
        mod.bind(data_shapes=[("data", shapes["data"])],
                 label_shapes=[("label", shapes["label"])])
        mod.init_params(pkg.init.Xavier())
        scale = mod.get_params()[0]["relu4_3_scale"].asnumpy()
        np.testing.assert_array_equal(scale, np.full((1, 512, 1, 1), 20.0))
        opt = pkg.optimizer.SGD(learning_rate=0.1, wd=5e-4,
                                sym=net, param_idx2name=dict(
                                    enumerate(net.list_arguments())))
        assert opt.wd_mult["relu4_3_scale"] == 0.1
    np_args = chip_smoke.seeded_weights(symbol_shapes(pnet, **shapes)[0],
                                          seed=3)
    args, aux = convert_symbol_params(np_args, {}, mx.cpu(), pnet, **shapes)
    assert sorted(args) == sorted(n for n in pnet.list_arguments()
                                  if n not in shapes) and not aux
    np.testing.assert_array_equal(args["relu4_3_scale"].asnumpy(),
                                  np_args["relu4_3_scale"])


HEAD_MAPS = ((512, 38), (1024, 19), (512, 10), (256, 5), (256, 3), (256, 1))


def _head(pkg):
    feats = [pkg.sym.Variable("feat%d" % k) for k in range(6)]
    return chip_smoke._ssd300_head(pkg, feats, pkg.sym.Variable("label"))


def test_ssd300_head_matches_jax():
    """The head on random features at the six maps' shapes (batch 2, 20
    classes), forward and backward with respect to every feature and
    head weight."""
    with JNameManager():
        jhead = _head(jmx)
    with NameManager():
        phead = _head(mx)
    assert phead.list_arguments() == jhead.list_arguments()
    B = 2
    shapes = {"feat%d" % k: (B, c, m, m) for k, (c, m) in enumerate(HEAD_MAPS)}
    shapes["label"] = (B, 8, 5)
    rng = np.random.RandomState(7)
    arrays = chip_smoke.seeded_weights(
        symbol_shapes(phead, **shapes)[0], seed=8)
    for k, (c, m) in enumerate(HEAD_MAPS):
        arrays["feat%d" % k] = np.maximum(
            rng.randn(B, c, m, m), 0).astype(np.float32)
    arrays["label"] = chip_smoke.ssd_labels(rng, B, 20, 8)
    jexe = jhead.simple_bind(ctx=jmx.cpu(), grad_req="write", **shapes)
    for k, v in jexe.arg_dict.items():
        v[:] = arrays[k]
    jouts = [o.asnumpy() for o in jexe.forward(is_train=True)]
    jexe.backward()
    jgrads = {k: g.asnumpy() for k, g in jexe.grad_dict.items()
              if g is not None and k != "label"}
    pexe = phead.simple_bind(ctx=mx.cpu(), grad_req="write", **shapes)
    for k, v in pexe.arg_dict.items():
        v[:] = mx.nd.array(arrays[k], ctx=mx.cpu())
    pouts = [o.asnumpy() for o in pexe.forward(is_train=True)]
    pexe.backward()
    pgrads = {k: g.asnumpy() for k, g in pexe.grad_dict.items()
              if k != "label"}
    cls_prob, loc_loss, cls_t, det = pouts
    assert cls_t.shape == (B, 8732) and det.shape == (B, 8732, 6)
    np.testing.assert_array_equal(cls_t, jouts[2])
    assert (cls_t > 0).any() and (cls_t == 0).any()
    np.testing.assert_array_equal(det[..., 0], jouts[3][..., 0])
    assert (det[:, 400:, 0] == -1).all()
    for got, want in ((cls_prob, jouts[0]), (loc_loss, jouts[1]),
                      (det[..., 1:], jouts[3][..., 1:])):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert pgrads.keys() == jgrads.keys()
    for k in jgrads:
        scale = float(np.abs(jgrads[k]).max())
        np.testing.assert_allclose(pgrads[k], jgrads[k], rtol=RTOL,
                                   atol=ATOL * max(1.0, scale), err_msg=k)
