"""PyTorch port: the symbolic model zoo (``models/``) against the JAX
package (the Gluon vision zoo: ``test_torch_gluon_zoo.py``, which takes
this file's helpers).

Each family is built in both packages under a fresh name scope (the
same node and parameter names), given the same numpy weights
(``chip_smoke.seeded_weights``: He-scaled weights, BatchNorm statistics
and affine terms near 1 and 0, so the activations stay of order one),
and run at a small input: the smallest each accepts where its
classifier fixes the size (the Gluon DenseNet at 221, Inception v3 at
299; the symbolic nets pool globally).

Predict mode (BatchNorm on its fixed statistics) holds the port's
logits, the output before the SoftmaxOutput, against the JAX
package's directly (``_hold_predict``).

Train mode holds the gradient (input and every parameter) of a fixed
random projection of Dropout-free features (a symbolic net's
``get_internals()`` entry, a Gluon net's first children of
``features``; Dropout masks cannot match across the packages, ROADMAP
C).  Deep nets at batch 2 are chaotic there: BatchNorm's scale
invariance makes some gradients sums that cancel to rounding level, and
a ReLU or max-pool choice that flips between two f32 runs moves every
gradient upstream of it (one flip in Inception v3's first mixed block
moves a 1x1 convolution's weight gradient, a sum over 2 x 35 x 35
positions, by 9e-3 of its norm).  An element bound between two f32
results cannot hold there, so ``_hold_train`` measures both packages'
f32 gradients against the port's float64 result on the same inputs:
the JAX package's within 2e-2 of its norm (so the port's float64 graph
computes what the JAX package does: a wrong op is off by order one),
and the port's within that, or within four times the JAX package's
distance.
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu.base import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models
from mxnet_tpu_torch.base import MXNetError, NameManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import seeded_weights  # noqa: E402

def _hold_predict(what, got, want):
    """The port's f32 predict-mode output against the JAX package's:
    rtol 2e-5, atol 1e-6.  An element that is a sum cancelled to near
    zero keeps the rounding noise of its largest terms, which scales
    with the output: up to 1.1e-6 of the largest element measured (the
    symbolic resnext, inception-bn and vgg_bn), so the atol is 4e-6 of
    the largest element where that is more than 1e-6."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = max(1e-6, 4e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=atol,
                               err_msg=what)


def _hold_train(what, got, want, exact):
    """``got`` (the port's f32 tensors) and ``want`` (the JAX package's)
    against ``exact`` (the port's f64 ones) by each tensor's L2
    distance.  The bound is 2e-2 of the exact tensor's norm plus a floor
    of 1e-6 of the largest element of its kind (output or gradient) per
    element: the rounding noise of a sum that cancels, which is all an
    f32 run can give where the exact gradient is zero (a convolution's
    bias feeding a train-mode BatchNorm: up to 6e-7 measured).  The JAX
    package's distance is within the bound; the port's within it, or
    within four times the JAX package's plus 1e-5 of the norm."""
    assert got.keys() == want.keys() == exact.keys()
    scale = max(float(np.abs(v).max()) for v in exact.values())
    for k, ref in exact.items():
        floor = 1e-6 * scale * np.sqrt(ref.size)
        norm = float(np.linalg.norm(ref))
        bound = 2e-2 * norm + floor
        d_port = np.linalg.norm(got[k].astype(np.float64) - ref)
        d_jax = np.linalg.norm(want[k].astype(np.float64) - ref)
        assert d_jax <= bound, (what, k, d_jax / bound)
        assert d_port <= max(4 * d_jax + 1e-5 * (norm + floor), bound), \
            (what, k, d_port / bound, d_jax / bound)


# ----------------------------------------------------------------------
# the symbolic zoo
# ----------------------------------------------------------------------
# family: (get_symbol's arguments, input size, the internal output whose
# train-mode gradient is held: the first stage or block that holds the
# family's own ops (LRN, a fire module, an inception or dense block, a
# grouped-convolution unit), a short backward for the JAX package to
# compile; predict mode runs the whole net)
SYMBOLIC = {
    "vgg": (dict(num_layers=11), 32, "pool2_output"),
    "vgg_bn": (dict(num_layers=11, batch_norm=True), 32, "relu2_1_output"),
    "alexnet": ({}, 67, "pooling1_output"),
    "googlenet": ({}, 32, "concat_3a_output"),
    "inception-bn": ({}, 64, "ch_concat_3a_chconcat_output"),
    "densenet": (dict(num_layers=121, growth_rate=8), 32,
                 "block1_unit2_concat_output"),
    "mobilenet": (dict(alpha=0.25), 64, "sep3_pw_relu_output"),
    "resnext": (dict(num_layers=50), 32, "stage1_unit1_relu_output"),
    "squeezenet": ({}, 32, "fire3_concat_output"),
}


def _logits(sym):
    """The entry the SoftmaxOutput reads: the last FullyConnected's
    output (squeezenet: its last Flatten's)."""
    names = sym.get_internals().list_outputs()
    assert names[-2:] == ["softmax_label", "softmax_output"], names[-2:]
    return names[-3]


def _jax_run(sym, arrays, shapes, xs, out_grad=None):
    """Outputs (and gradients with ``out_grad``) for each input of
    ``xs``, from one bound executor."""
    exe = sym.simple_bind(ctx=jmx.cpu(), grad_req="write"
                          if out_grad is not None else "null", **shapes)
    for k, v in exe.arg_dict.items():
        if k != "data":
            v[:] = arrays[k]
    for k, v in exe.aux_dict.items():
        v[:] = arrays[k]
    runs = []
    for x in xs:
        exe.arg_dict["data"][:] = x
        out = exe.forward(is_train=out_grad is not None)[0].asnumpy()
        if out_grad is None:
            runs.append((out, None))
            continue
        exe.backward([jmx.nd.array(out_grad)])
        runs.append((out, {k: g.asnumpy() for k, g in exe.grad_dict.items()
                           if g is not None}))
    return runs


def _port_run(sym, arrays, shapes, x, out_grad=None, dtype="float32"):
    exe = sym.simple_bind(ctx=mx.cpu(), grad_req="write"
                          if out_grad is not None else "null",
                          type_dict={"data": dtype}, **shapes)

    def nd(a):
        return mx.nd.array(a.astype(dtype), ctx=mx.cpu(), dtype=dtype)
    exe.copy_params_from({k: nd(arrays[k]) for k in exe.arg_dict
                          if k != "data"},
                         {k: nd(arrays[k]) for k in exe.aux_dict})
    out = exe.forward(is_train=out_grad is not None,
                      data=nd(x))[0].asnumpy()
    if out_grad is None:
        return out, None
    exe.backward([nd(out_grad)])
    return out, {k: g.asnumpy() for k, g in exe.grad_dict.items()}


@pytest.mark.parametrize("family", sorted(SYMBOLIC))
def test_symbolic_family_matches_jax(family):
    kw, size, name = SYMBOLIC[family]
    network = family.replace("_bn", "")
    with JNameManager():
        jsym = jmodels.get_symbol(network, num_classes=10, **kw)
    with NameManager():
        psym = models.get_symbol(network, num_classes=10, **kw)
    assert psym.list_arguments() == jsym.list_arguments()
    assert psym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert psym.get_internals().list_outputs() == \
        jsym.get_internals().list_outputs()
    shapes = dict(data=(2, 3, size, size))
    jargs, jouts, jauxs = jsym.infer_shape(**shapes)
    pargs, pouts, pauxs = psym.infer_shape(**shapes)
    assert [tuple(s) for s in pargs] == [tuple(s) for s in jargs]
    assert [tuple(s) for s in pouts] == [tuple(s) for s in jouts]
    assert [tuple(s) for s in pauxs] == [tuple(s) for s in jauxs]
    arrays = seeded_weights(dict(
        list(zip(psym.list_arguments(), pargs))
        + list(zip(psym.list_auxiliary_states(), pauxs))), seed=0)
    rng = np.random.RandomState(1)
    x = rng.rand(*shapes["data"]).astype(np.float32)
    # predict mode: the logits
    logits = _logits(psym)
    (want, _), = _jax_run(jsym.get_internals()[logits], arrays, shapes, [x])
    got, _ = _port_run(psym.get_internals()[logits], arrays, shapes, x)
    assert got.shape == (2, 10)
    _hold_predict(family, got, want)

    # train mode: the gradient of a projection of the features
    jfeat, pfeat = jsym.get_internals()[name], psym.get_internals()[name]
    w = rng.randn(*pfeat.infer_shape(**shapes)[1][0]).astype(np.float32)
    (_, jg), = _jax_run(jfeat, arrays, shapes, [x], w)
    _, pg = _port_run(pfeat, arrays, shapes, x, w)
    _, eg = _port_run(pfeat, arrays, shapes, x, w, dtype="float64")
    _hold_train(family, pg, jg, eg)


def test_get_symbol_table_matches_jax():
    assert set(models._NETWORKS) == set(jmodels._NETWORKS)
    with pytest.raises(MXNetError):
        models.get_symbol("lenet5")
    with pytest.raises(ValueError):
        models.get_symbol("vgg", num_layers=12)
