"""PyTorch port: the Gluon vision zoo (``gluon/model_zoo/vision``: VGG,
AlexNet, SqueezeNet, DenseNet, MobileNet v1 and v2, Inception v3)
against the JAX package, as ``test_torch_model_zoo.py`` holds the
symbolic zoo and with its helpers: the same numpy weights in both
packages, the predict-mode output held against the JAX package's
(``_hold_predict``), and the train-mode gradients of the first children
of ``features`` held, with the JAX package's, against the port's
float64 result (``_hold_train``)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.base import NameManager as JNameManager
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.base import MXNetError, NameManager
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

from test_torch_model_zoo import _hold_predict, _hold_train, seeded_weights


# family: (builder over a vision module, input size, the count of
# ``features`` children whose train-mode gradient is held, and the input
# size of that train-mode pass: a stem and the first blocks that hold
# the family's own layers (a fire module, a dense block, an inverted
# residual, Inception's first ``_Concurrent``), a short backward for the
# JAX package to compile; the features take a smaller input than the
# classifier's fixed pooling needs)
GLUON = {
    "vgg11_bn": (lambda v: v.vgg11_bn(classes=10), 32, 8, 32),
    "alexnet": (lambda v: v.alexnet(classes=10), 63, 8, 63),
    "squeezenet1.0": (lambda v: v.squeezenet1_0(classes=10), 35, 5, 35),
    "squeezenet1.1": (lambda v: v.squeezenet1_1(classes=10), 17, 5, 17),
    "densenet": (lambda v: v.DenseNet(8, 4, [1, 2, 1, 1], classes=10), 221,
                 5, 32),
    "mobilenet0.25": (lambda v: v.mobilenet0_25(classes=10), 32, 12, 32),
    "mobilenetv2_0.25": (lambda v: v.mobilenet_v2_0_25(classes=10), 32, 6,
                         32),
    "inceptionv3": (lambda v: v.inception_v3(classes=10), 299, 8, 75),
}


def _feature_block(pkg_nn, net, cut):
    kids = list(net.features._children.values())
    block = pkg_nn.HybridSequential(prefix="")
    for c in kids[:cut]:
        block.add(c)
    block.hybridize()
    return block


def _gluon_grads(pkg, block, net, x, w, **ctx):
    nx = pkg.nd.array(x, dtype=x.dtype, **ctx)
    nx.attach_grad()
    with pkg.autograd.record():
        y = block(nx)
        loss = (y * pkg.nd.array(w, dtype=x.dtype, **ctx)).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null" and p.grad() is not None}
    grads["data"] = nx.grad.asnumpy()
    return y.asnumpy(), grads


def _port_net(make, arrays, x, dtype):
    with NameManager():
        net = make(tvision)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    net(mx.nd.array(x[:1], ctx=mx.cpu()))            # deferred shapes
    if arrays is None:
        return net
    if dtype != "float32":
        net.cast(dtype)
    weights.gluon_params_from_numpy(
        net, {k: v.astype(dtype) for k, v in arrays.items()})
    net.hybridize()
    return net


@pytest.mark.parametrize("family", sorted(GLUON))
def test_gluon_family_matches_jax(family):
    make, size, cut, train_size = GLUON[family]
    rng = np.random.RandomState(1)
    x = rng.rand(2, 3, size, size).astype(np.float32)
    arrays = seeded_weights({k: p.data().shape for k, p in _port_net(
        make, None, x, None).collect_params().items()}, seed=2)
    pnet = _port_net(make, arrays, x, "float32")
    enet = _port_net(make, arrays, x, "float64")
    with JNameManager():
        jnet = make(jvision)
    jparams = jnet.collect_params()
    assert sorted(arrays) == sorted(jparams.keys())
    for k, p in jparams.items():        # shapes known: no deferred pass
        p.shape = arrays[k].shape
    jnet.initialize(jmx.init.Zero())
    for k, p in jparams.items():
        p.set_data(jmx.nd.array(arrays[k]))
    jnet.hybridize()
    want = jnet(jmx.nd.array(x)).asnumpy()
    got = pnet(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    assert got.shape == (2, 10)
    _hold_predict(family, got, want)

    blocks = [_feature_block(jnn, jnet, cut), _feature_block(tnn, pnet, cut),
              _feature_block(tnn, enet, cut)]
    x = rng.rand(2, 3, train_size, train_size).astype(np.float32)
    y_shape = blocks[1](mx.nd.array(x, ctx=mx.cpu())).shape
    w = rng.randn(*y_shape).astype(np.float32)
    _, jg = _gluon_grads(jmx, blocks[0], jnet, x, w)
    _, pg = _gluon_grads(mx, blocks[1], pnet, x, w, ctx=mx.cpu())
    _, eg = _gluon_grads(mx, blocks[2], enet, x.astype(np.float64),
                         w.astype(np.float64), ctx=mx.cpu())
    _hold_train(family, pg, jg, eg)


def test_gluon_zoo_names_and_pretrained():
    assert set(tvision._models) == set(jvision._models)
    with pytest.raises(MXNetError):
        tvision.get_model("vgg16", pretrained=True)
    with pytest.raises(MXNetError):
        tvision.inception_v3(pretrained=True)
    with pytest.raises(ValueError):
        tvision.get_model("vgg17")
