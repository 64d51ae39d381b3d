"""VGG 11/13/16/19, with or without BatchNorm (counterpart of
``mxnet_tpu/models/vgg.py``; reference
example/image-classification/symbols/vgg.py)."""
from .. import symbol as sym

VGG_SPEC = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False,
               dtype="float32", **kwargs):
    if num_layers not in VGG_SPEC:
        raise ValueError("no vgg with depth %d" % num_layers)
    layers, filters = VGG_SPEC[num_layers]
    data = sym.Variable("data")
    if dtype in ("float16", "bfloat16"):
        data = sym.Cast(data=data, dtype=dtype)
    net = data
    for i, num in enumerate(layers):
        for j in range(num):
            net = sym.Convolution(data=net, kernel=(3, 3), pad=(1, 1),
                                  num_filter=filters[i],
                                  name="conv%d_%d" % (i + 1, j + 1))
            if batch_norm:
                net = sym.BatchNorm(data=net, name="bn%d_%d" % (i + 1, j + 1))
            net = sym.Activation(data=net, act_type="relu",
                                 name="relu%d_%d" % (i + 1, j + 1))
        net = sym.Pooling(data=net, pool_type="max", kernel=(2, 2),
                          stride=(2, 2), name="pool%d" % (i + 1))
    net = sym.Flatten(data=net, name="flatten")
    net = sym.FullyConnected(data=net, num_hidden=4096, name="fc6")
    net = sym.Activation(data=net, act_type="relu", name="relu6")
    net = sym.Dropout(data=net, p=0.5, name="drop6")
    net = sym.FullyConnected(data=net, num_hidden=4096, name="fc7")
    net = sym.Activation(data=net, act_type="relu", name="relu7")
    net = sym.Dropout(data=net, p=0.5, name="drop7")
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc8")
    if dtype in ("float16", "bfloat16"):
        net = sym.Cast(data=net, dtype="float32")
    return sym.SoftmaxOutput(data=net, name="softmax")
