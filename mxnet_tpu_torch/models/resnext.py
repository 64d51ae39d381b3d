"""ResNeXt, the 3x3 convolutions grouped (counterpart of
``mxnet_tpu/models/resnext.py``; reference
example/image-classification/symbols/resnext.py)."""
from .. import symbol as sym


def resnext_unit(data, num_filter, stride, dim_match, name, num_group=32,
                 bottle_neck=True):
    if bottle_neck:
        mid = num_filter // 2
        conv1 = sym.Convolution(data=data, num_filter=mid, kernel=(1, 1),
                                no_bias=True, name=name + "_conv1")
        bn1 = sym.BatchNorm(data=conv1, name=name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu")
        conv2 = sym.Convolution(data=act1, num_filter=mid, kernel=(3, 3),
                                stride=stride, pad=(1, 1),
                                num_group=num_group, no_bias=True,
                                name=name + "_conv2")
        bn2 = sym.BatchNorm(data=conv2, name=name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu")
        conv3 = sym.Convolution(data=act2, num_filter=num_filter,
                                kernel=(1, 1), no_bias=True,
                                name=name + "_conv3")
        body = sym.BatchNorm(data=conv3, name=name + "_bn3")
    else:
        conv1 = sym.Convolution(data=data, num_filter=num_filter,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv1")
        bn1 = sym.BatchNorm(data=conv1, name=name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu")
        conv2 = sym.Convolution(data=act1, num_filter=num_filter,
                                kernel=(3, 3), pad=(1, 1), no_bias=True,
                                name=name + "_conv2")
        body = sym.BatchNorm(data=conv2, name=name + "_bn2")
    if dim_match:
        shortcut = data
    else:
        sc = sym.Convolution(data=data, num_filter=num_filter, kernel=(1, 1),
                             stride=stride, no_bias=True, name=name + "_sc")
        shortcut = sym.BatchNorm(data=sc, name=name + "_sc_bn")
    return sym.Activation(data=body + shortcut, act_type="relu",
                          name=name + "_relu")


def get_symbol(num_classes=1000, num_layers=50, num_group=32,
               image_shape=(3, 224, 224), dtype="float32", **kwargs):
    units_by_depth = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
                      152: [3, 8, 36, 3]}
    if num_layers not in units_by_depth:
        raise ValueError("no resnext with depth %d" % num_layers)
    units = units_by_depth[num_layers]
    filter_list = [64, 256, 512, 1024, 2048]

    data = sym.Variable("data")
    if dtype in ("float16", "bfloat16"):
        data = sym.Cast(data=data, dtype=dtype)
    body = sym.Convolution(data=data, num_filter=filter_list[0],
                           kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                           no_bias=True, name="conv0")
    body = sym.BatchNorm(data=body, name="bn0")
    body = sym.Activation(data=body, act_type="relu", name="relu0")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max", name="pool0")
    for i in range(4):
        stride = (1, 1) if i == 0 else (2, 2)
        body = resnext_unit(body, filter_list[i + 1], stride, False,
                            "stage%d_unit1" % (i + 1), num_group)
        for j in range(units[i] - 1):
            body = resnext_unit(body, filter_list[i + 1], (1, 1), True,
                                "stage%d_unit%d" % (i + 1, j + 2), num_group)
    pool = sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                       pool_type="avg", name="pool1")
    flat = sym.Flatten(data=pool)
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    if dtype in ("float16", "bfloat16"):
        fc = sym.Cast(data=fc, dtype="float32")
    return sym.SoftmaxOutput(data=fc, name="softmax")
