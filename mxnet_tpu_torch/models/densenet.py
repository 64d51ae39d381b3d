"""DenseNet-BC (counterpart of ``mxnet_tpu/models/densenet.py``;
reference example/image-classification/symbols/densenet.py)."""
from .. import symbol as sym


def _bn_relu_conv(data, num_filter, kernel, pad, name):
    bn = sym.BatchNorm(data=data, name=name + "_bn")
    act = sym.Activation(data=bn, act_type="relu")
    return sym.Convolution(data=act, num_filter=num_filter, kernel=kernel,
                           pad=pad, no_bias=True, name=name + "_conv")


def dense_block(data, num_units, growth_rate, name):
    for i in range(num_units):
        u = "%s_unit%d" % (name, i + 1)
        bottleneck = _bn_relu_conv(data, 4 * growth_rate, (1, 1), (0, 0),
                                   u + "_b")
        new = _bn_relu_conv(bottleneck, growth_rate, (3, 3), (1, 1), u)
        data = sym.Concat(data, new, name=u + "_concat")
    return data


def transition(data, num_filter, name):
    out = _bn_relu_conv(data, num_filter, (1, 1), (0, 0), name)
    return sym.Pooling(data=out, kernel=(2, 2), stride=(2, 2),
                       pool_type="avg", name=name + "_pool")


def get_symbol(num_classes=1000, num_layers=121, growth_rate=32,
               reduction=0.5, **kwargs):
    stages_by_depth = {121: [6, 12, 24, 16], 169: [6, 12, 32, 32],
                       201: [6, 12, 48, 32], 161: [6, 12, 36, 24]}
    if num_layers not in stages_by_depth:
        raise ValueError("no densenet with depth %d" % num_layers)
    stages = stages_by_depth[num_layers]
    if num_layers == 161:
        growth_rate = 48
    init_ch = 2 * growth_rate

    data = sym.Variable("data")
    body = sym.Convolution(data=data, num_filter=init_ch, kernel=(7, 7),
                           stride=(2, 2), pad=(3, 3), no_bias=True,
                           name="conv0")
    body = sym.BatchNorm(data=body, name="bn0")
    body = sym.Activation(data=body, act_type="relu", name="relu0")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max", name="pool0")
    ch = init_ch
    for i, units in enumerate(stages):
        body = dense_block(body, units, growth_rate, "block%d" % (i + 1))
        ch += units * growth_rate
        if i != len(stages) - 1:
            ch = int(ch * reduction)
            body = transition(body, ch, "trans%d" % (i + 1))
    body = sym.BatchNorm(data=body, name="bn_final")
    body = sym.Activation(data=body, act_type="relu", name="relu_final")
    pool = sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                       pool_type="avg", name="global_pool")
    flat = sym.Flatten(data=pool)
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")
