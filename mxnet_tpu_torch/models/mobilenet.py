"""MobileNet v1, depthwise-separable convolutions as grouped
convolutions (counterpart of ``mxnet_tpu/models/mobilenet.py``; reference
example/image-classification/symbols/mobilenet.py)."""
from .. import symbol as sym


def conv_bn(data, num_filter, kernel, stride, pad, name, num_group=1):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, num_group=num_group,
                           no_bias=True, name=name)
    bn = sym.BatchNorm(data=conv, name=name + "_bn")
    return sym.Activation(data=bn, act_type="relu", name=name + "_relu")


def dw_sep(data, in_ch, out_ch, stride, name, alpha=1.0):
    in_ch = int(in_ch * alpha)
    out_ch = int(out_ch * alpha)
    dw = conv_bn(data, in_ch, (3, 3), stride, (1, 1), name + "_dw",
                 num_group=in_ch)
    return conv_bn(dw, out_ch, (1, 1), (1, 1), (0, 0), name + "_pw")


def get_symbol(num_classes=1000, alpha=1.0, dtype="float32", **kwargs):
    data = sym.Variable("data")
    if dtype in ("float16", "bfloat16"):
        data = sym.Cast(data=data, dtype=dtype)
    net = conv_bn(data, int(32 * alpha), (3, 3), (2, 2), (1, 1), "conv1")
    cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
           (256, 256, 1), (256, 512, 2),
           (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
           (512, 512, 1),
           (512, 1024, 2), (1024, 1024, 1)]
    for i, (cin, cout, s) in enumerate(cfg):
        net = dw_sep(net, cin, cout, (s, s), "sep%d" % (i + 2), alpha)
    pool = sym.Pooling(data=net, global_pool=True, kernel=(7, 7),
                       pool_type="avg", name="global_pool")
    flat = sym.Flatten(data=pool)
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc")
    if dtype in ("float16", "bfloat16"):
        fc = sym.Cast(data=fc, dtype="float32")
    return sym.SoftmaxOutput(data=fc, name="softmax")
