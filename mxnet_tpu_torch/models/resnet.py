"""ResNet v1/v2 for ImageNet and CIFAR.

Counterpart of ``mxnet_tpu/models/resnet.py`` (reference
example/image-classification/symbols/resnet.py, v2 "Identity Mappings
in Deep Residual Networks", and resnet-v1.py), with the same names and
shapes, so one numpy weight set binds in both packages.
``dtype='bfloat16'`` or ``'float16'`` casts the data to that type
before the first BatchNorm and the logits back to f32 before the
softmax, as the JAX package's does, so the weights infer the 16-bit
type and BatchNorm computes its statistics in f32.
``layout='NHWC'`` builds the whole trunk channel-last (data, OHWI
weights, pooling, BatchNorm axis 3), with no relayout copy in the step
(``ops/nn.py``); ``image_shape`` stays channels-first and the data
variable is fed (N, H, W, C) batches.

Depth table (ImageNet): 18/34 use the basic block, 50/101/152/200/269
the bottleneck block.  CIFAR shapes (image height <= 28) use the
3-stage layout with depth 6n+2 (9n+2 bottleneck for 164 and more).
"""
from functools import partial

from .. import symbol as sym
from ..base import MXNetError

BN_MOM = 0.9
EPS = 2e-5


def _bn(data, name, fix_gamma=False, layout="NCHW"):
    axis = 3 if str(layout).endswith("C") else 1
    return sym.BatchNorm(data=data, name=name, fix_gamma=fix_gamma,
                         eps=EPS, momentum=BN_MOM, axis=axis)


def residual_unit_v2(data, num_filter, stride, dim_match, name,
                     bottle_neck=True, workspace=256, layout="NCHW"):
    """Pre-activation residual unit (BN-ReLU-Conv)."""
    conv = partial(sym.Convolution, layout=layout, workspace=workspace)
    bn = partial(_bn, layout=layout)
    bn1 = bn(data, name + "_bn1")
    act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
    if bottle_neck:
        conv1 = conv(data=act1, num_filter=num_filter // 4, kernel=(1, 1),
                     stride=(1, 1), pad=(0, 0), no_bias=True,
                     name=name + "_conv1")
        bn2 = bn(conv1, name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
        conv2 = conv(data=act2, num_filter=num_filter // 4, kernel=(3, 3),
                     stride=stride, pad=(1, 1), no_bias=True,
                     name=name + "_conv2")
        bn3 = bn(conv2, name + "_bn3")
        act3 = sym.Activation(data=bn3, act_type="relu", name=name + "_relu3")
        body = conv(data=act3, num_filter=num_filter, kernel=(1, 1),
                    stride=(1, 1), pad=(0, 0), no_bias=True,
                    name=name + "_conv3")
    else:
        conv1 = conv(data=act1, num_filter=num_filter, kernel=(3, 3),
                     stride=stride, pad=(1, 1), no_bias=True,
                     name=name + "_conv1")
        bn2 = bn(conv1, name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
        body = conv(data=act2, num_filter=num_filter, kernel=(3, 3),
                    stride=(1, 1), pad=(1, 1), no_bias=True,
                    name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = conv(data=act1, num_filter=num_filter, kernel=(1, 1),
                        stride=stride, no_bias=True, name=name + "_sc")
    return body + shortcut


def residual_unit_v1(data, num_filter, stride, dim_match, name,
                     bottle_neck=True, workspace=256, layout="NCHW"):
    """Original residual unit (Conv-BN-ReLU, post-activation)."""
    conv = partial(sym.Convolution, layout=layout, workspace=workspace)
    bn = partial(_bn, layout=layout)
    if bottle_neck:
        conv1 = conv(data=data, num_filter=num_filter // 4, kernel=(1, 1),
                     stride=stride, pad=(0, 0), no_bias=True,
                     name=name + "_conv1")
        bn1 = bn(conv1, name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
        conv2 = conv(data=act1, num_filter=num_filter // 4, kernel=(3, 3),
                     stride=(1, 1), pad=(1, 1), no_bias=True,
                     name=name + "_conv2")
        bn2 = bn(conv2, name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
        conv3 = conv(data=act2, num_filter=num_filter, kernel=(1, 1),
                     stride=(1, 1), pad=(0, 0), no_bias=True,
                     name=name + "_conv3")
        body = bn(conv3, name + "_bn3")
    else:
        conv1 = conv(data=data, num_filter=num_filter, kernel=(3, 3),
                     stride=stride, pad=(1, 1), no_bias=True,
                     name=name + "_conv1")
        bn1 = bn(conv1, name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
        conv2 = conv(data=act1, num_filter=num_filter, kernel=(3, 3),
                     stride=(1, 1), pad=(1, 1), no_bias=True,
                     name=name + "_conv2")
        body = bn(conv2, name + "_bn2")
    if dim_match:
        shortcut = data
    else:
        sc = conv(data=data, num_filter=num_filter, kernel=(1, 1),
                  stride=stride, no_bias=True, name=name + "_sc")
        shortcut = bn(sc, name + "_sc_bn")
    return sym.Activation(data=body + shortcut, act_type="relu",
                          name=name + "_relu")


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, workspace=256, dtype="float32", version=2,
           layout="NCHW"):
    unit_fn = residual_unit_v2 if version == 2 else residual_unit_v1
    conv = partial(sym.Convolution, layout=layout, workspace=workspace)
    bn = partial(_bn, layout=layout)
    (_nchannel, height, _width) = image_shape
    data = sym.Variable(name="data")
    if dtype in ("float16", "bfloat16"):
        data = sym.Cast(data=data, dtype=dtype, name="cast_data")
    data = bn(data, "bn_data", fix_gamma=True)
    if height <= 32:  # cifar
        body = conv(data=data, num_filter=filter_list[0], kernel=(3, 3),
                    stride=(1, 1), pad=(1, 1), no_bias=True, name="conv0")
    else:  # imagenet stem
        body = conv(data=data, num_filter=filter_list[0], kernel=(7, 7),
                    stride=(2, 2), pad=(3, 3), no_bias=True, name="conv0")
        body = bn(body, "bn0")
        body = sym.Activation(data=body, act_type="relu", name="relu0")
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                           pad=(1, 1), pool_type="max", name="pool0",
                           layout=layout)

    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = unit_fn(body, filter_list[i + 1], stride, False,
                       name="stage%d_unit%d" % (i + 1, 1),
                       bottle_neck=bottle_neck, workspace=workspace,
                       layout=layout)
        for j in range(units[i] - 1):
            body = unit_fn(body, filter_list[i + 1], (1, 1), True,
                           name="stage%d_unit%d" % (i + 1, j + 2),
                           bottle_neck=bottle_neck, workspace=workspace,
                           layout=layout)
    if version == 2:
        body = bn(body, "bn1")
        body = sym.Activation(data=body, act_type="relu", name="relu1")
    pool1 = sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1", layout=layout)
    flat = sym.Flatten(data=pool1)
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    if dtype in ("float16", "bfloat16"):
        fc1 = sym.Cast(data=fc1, dtype="float32", name="cast_out")
    return sym.SoftmaxOutput(data=fc1, name="softmax")


def get_symbol(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
               conv_workspace=256, dtype="float32", version=2,
               layout="NCHW", **kwargs):
    """``image_shape`` is channels-first (C, H, W), as the reference CLI
    gives it (a tuple or a "3,224,224" string); with ``layout='NHWC'``
    the bound data variable is fed (N, H, W, C) batches."""
    if dtype not in ("float32", "bfloat16", "float16"):
        raise MXNetError("resnet dtype=%r: use 'float32', 'bfloat16' or "
                         "'float16'" % (dtype,))
    if layout not in ("NCHW", "NHWC"):
        raise MXNetError("resnet layout=%r: use 'NCHW' or 'NHWC'"
                         % (layout,))
    if isinstance(image_shape, str):
        image_shape = tuple(int(x) for x in image_shape.split(","))
    image_shape = tuple(image_shape)
    (_nchannel, height, _width) = image_shape
    if height <= 28:  # cifar/mnist-sized
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError("no cifar resnet with depth %d" % num_layers)
        units = per_unit * num_stages
    else:
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        num_stages = 4
        units_by_depth = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3],
                          50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
                          152: [3, 8, 36, 3], 200: [3, 24, 36, 3],
                          269: [3, 30, 48, 8]}
        if num_layers not in units_by_depth:
            raise ValueError("no imagenet resnet with depth %d" % num_layers)
        units = units_by_depth[num_layers]

    return resnet(units=units, num_stages=num_stages, filter_list=filter_list,
                  num_classes=num_classes, image_shape=image_shape,
                  bottle_neck=bottle_neck, workspace=conv_workspace,
                  dtype=dtype, version=version, layout=layout)
