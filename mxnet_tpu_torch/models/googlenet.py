"""GoogLeNet / Inception v1 (counterpart of
``mxnet_tpu/models/googlenet.py``; reference
example/image-classification/symbols/googlenet.py)."""
from .. import symbol as sym


def conv_relu(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, name="conv_%s" % name)
    return sym.Activation(data=conv, act_type="relu", name="relu_%s" % name)


def inception(data, n1x1, n3x3r, n3x3, n5x5r, n5x5, proj, name):
    c1 = conv_relu(data, n1x1, (1, 1), name="%s_1x1" % name)
    c3r = conv_relu(data, n3x3r, (1, 1), name="%s_3x3r" % name)
    c3 = conv_relu(c3r, n3x3, (3, 3), pad=(1, 1), name="%s_3x3" % name)
    c5r = conv_relu(data, n5x5r, (1, 1), name="%s_5x5r" % name)
    c5 = conv_relu(c5r, n5x5, (5, 5), pad=(2, 2), name="%s_5x5" % name)
    pool = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                       pool_type="max", name="pool_%s" % name)
    cp = conv_relu(pool, proj, (1, 1), name="%s_proj" % name)
    return sym.Concat(c1, c3, c5, cp, name="concat_%s" % name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    body = conv_relu(data, 64, (7, 7), stride=(2, 2), pad=(3, 3), name="1")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max", name="pool1")
    body = conv_relu(body, 64, (1, 1), name="2r")
    body = conv_relu(body, 192, (3, 3), pad=(1, 1), name="2")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max", name="pool2")
    body = inception(body, 64, 96, 128, 16, 32, 32, "3a")
    body = inception(body, 128, 128, 192, 32, 96, 64, "3b")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max", name="pool3")
    body = inception(body, 192, 96, 208, 16, 48, 64, "4a")
    body = inception(body, 160, 112, 224, 24, 64, 64, "4b")
    body = inception(body, 128, 128, 256, 24, 64, 64, "4c")
    body = inception(body, 112, 144, 288, 32, 64, 64, "4d")
    body = inception(body, 256, 160, 320, 32, 128, 128, "4e")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max", name="pool4")
    body = inception(body, 256, 160, 320, 32, 128, 128, "5a")
    body = inception(body, 384, 192, 384, 48, 128, 128, "5b")
    body = sym.Pooling(data=body, kernel=(7, 7), global_pool=True,
                       pool_type="avg", name="global_pool")
    body = sym.Flatten(data=body)
    body = sym.Dropout(data=body, p=0.4)
    fc = sym.FullyConnected(data=body, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(data=fc, name="softmax")
