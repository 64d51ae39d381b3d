"""SqueezeNet v1.1 (counterpart of ``mxnet_tpu/models/squeezenet.py``;
reference example/image-classification/symbols/squeezenet.py)."""
from .. import symbol as sym


def fire(data, squeeze, expand, name):
    sq = sym.Convolution(data=data, num_filter=squeeze, kernel=(1, 1),
                         name="%s_squeeze" % name)
    sq = sym.Activation(data=sq, act_type="relu")
    e1 = sym.Convolution(data=sq, num_filter=expand, kernel=(1, 1),
                         name="%s_e1x1" % name)
    e1 = sym.Activation(data=e1, act_type="relu")
    e3 = sym.Convolution(data=sq, num_filter=expand, kernel=(3, 3),
                         pad=(1, 1), name="%s_e3x3" % name)
    e3 = sym.Activation(data=e3, act_type="relu")
    return sym.Concat(e1, e3, name="%s_concat" % name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    net = sym.Convolution(data=data, num_filter=64, kernel=(3, 3),
                          stride=(2, 2), name="conv1")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    net = fire(net, 16, 64, "fire2")
    net = fire(net, 16, 64, "fire3")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    net = fire(net, 32, 128, "fire4")
    net = fire(net, 32, 128, "fire5")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    net = fire(net, 48, 192, "fire6")
    net = fire(net, 48, 192, "fire7")
    net = fire(net, 64, 256, "fire8")
    net = fire(net, 64, 256, "fire9")
    net = sym.Dropout(data=net, p=0.5)
    net = sym.Convolution(data=net, num_filter=num_classes, kernel=(1, 1),
                          name="conv10")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.Pooling(data=net, global_pool=True, kernel=(13, 13),
                      pool_type="avg")
    net = sym.Flatten(data=net)
    return sym.SoftmaxOutput(data=net, name="softmax")
