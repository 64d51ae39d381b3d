"""Gluon ResNet v1 (He et al. 1512.03385, post-activation) and v2
(He et al. 1603.05027, pre-activation).

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py`` (API
parity with the reference ``python/mxnet/gluon/model_zoo/vision/
resnet.py``), built in the same order so every parameter has the JAX
package's name.

Parameter names (``resnetv20_stage1_conv0_weight``, ...) follow from the
construction order of the parametered layers inside each name scope,
which is the JAX package's: weights carry between the packages by name.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ..model_store import no_pretrained

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


# Per-block convolution plans: (out_channels, kernel, stride, pad, bias,
# in_channels).  Stride goes on the first 3x3 for basic blocks, on the 1x1
# (v1) or the 3x3 (v2) for bottlenecks — the paper's placement (and, for
# v1's biased 1x1 convs, the reference's quirk, which the checkpoint layout
# bakes in).  in_channels entries mirror the reference declarations: a
# conv with known in_channels allocates its weight at initialize(), the
# others at the first forward.
def _basic_plan(ch, stride, in_ch):
    return [(ch, 3, stride, 1, False, in_ch), (ch, 3, 1, 1, False, ch)]


def _bottleneck_v1_plan(ch, stride):
    return [(ch // 4, 1, stride, 0, True, 0),
            (ch // 4, 3, 1, 1, False, ch // 4),
            (ch, 1, 1, 0, True, 0)]


def _bottleneck_v2_plan(ch, stride):
    return [(ch // 4, 1, 1, 0, False, 0),
            (ch // 4, 3, stride, 1, False, ch // 4),
            (ch, 1, 1, 0, False, 0)]


def _conv(ch, kernel, stride, pad, bias, in_channels=0):
    return nn.Conv2D(ch, kernel_size=kernel, strides=stride, padding=pad,
                     use_bias=bias, in_channels=in_channels)


class _ResidualV1(HybridBlock):
    """Post-activation residual unit: relu(body(x) + shortcut(x)).

    ``body`` is conv→BN pairs with interior relus; ``shortcut`` is a strided
    1x1 conv + BN when the shape changes, else identity.
    """

    def __init__(self, plan, stride, downsample, in_channels, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        last = len(plan) - 1
        for i, (ch, k, s, p, bias, in_ch) in enumerate(plan):
            self.body.add(_conv(ch, k, s, p, bias, in_ch))
            self.body.add(nn.BatchNorm())
            if i != last:
                self.body.add(nn.Activation("relu"))
        if downsample:
            out_ch = plan[-1][0]
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(_conv(out_ch, 1, stride, 0, False,
                                      in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.Activation(self.body(x) + shortcut, act_type="relu")


class BasicBlockV1(_ResidualV1):
    """Two 3x3 convs (ResNet-18/34 unit)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(_basic_plan(channels, stride, in_channels),
                         stride, downsample, in_channels, **kwargs)


class BottleneckV1(_ResidualV1):
    """1x1 (strided) → 3x3 → 1x1 expand (ResNet-50/101/152 unit)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(_bottleneck_v1_plan(channels, stride), stride,
                         downsample, in_channels, **kwargs)


class _ResidualV2(HybridBlock):
    """Pre-activation residual unit: each conv is preceded by BN→relu, the
    shortcut projection (if any) taps the FIRST pre-activation output, and
    the sum is returned un-activated."""

    def __init__(self, plan, stride, downsample, in_channels, **kwargs):
        super().__init__(**kwargs)
        self._depth = len(plan)
        for i, (ch, k, s, p, _bias, in_ch) in enumerate(plan, start=1):
            setattr(self, f"bn{i}", nn.BatchNorm())
            setattr(self, f"conv{i}", _conv(ch, k, s, p, False, in_ch))
        if downsample:
            self.downsample = _conv(plan[-1][0], 1, stride, 0, False,
                                    in_channels)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        shortcut = x
        for i in range(1, self._depth + 1):
            x = getattr(self, f"bn{i}")(x)
            x = F.Activation(x, act_type="relu")
            if i == 1 and self.downsample is not None:
                shortcut = self.downsample(x)
            x = getattr(self, f"conv{i}")(x)
        return x + shortcut


class BasicBlockV2(_ResidualV2):
    """Pre-activation pair of 3x3 convs."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(_basic_plan(channels, stride, in_channels),
                         stride, downsample, in_channels, **kwargs)


class BottleneckV2(_ResidualV2):
    """Pre-activation bottleneck; the stride sits on the 3x3."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(_bottleneck_v2_plan(channels, stride), stride,
                         downsample, in_channels, **kwargs)


def _imagenet_stem(seq, first_channels, thumbnail):
    """7x7/2 conv + BN + relu + 3x3/2 maxpool, or a bare 3x3 for CIFAR-size
    inputs (``thumbnail=True``)."""
    if thumbnail:
        seq.add(_conv(first_channels, 3, 1, 1, False))
    else:
        seq.add(nn.Conv2D(first_channels, 7, 2, 3, use_bias=False))
        seq.add(nn.BatchNorm())
        seq.add(nn.Activation("relu"))
        seq.add(nn.MaxPool2D(3, 2, 1))


def _stage(block, n_units, channels, stride, index, in_channels):
    """One spatial stage: a strided/projecting unit then n-1 identity units."""
    seq = nn.HybridSequential(prefix=f"stage{index}_")
    with seq.name_scope():
        seq.add(block(channels, stride, channels != in_channels,
                      in_channels=in_channels, prefix=""))
        for _ in range(n_units - 1):
            seq.add(block(channels, 1, False, in_channels=channels, prefix=""))
    return seq


class ResNetV1(HybridBlock):
    """Post-activation ResNet: stem → 4 stages → global pool → classifier."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("need one channel count per stage plus the stem")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _imagenet_stem(self.features, channels[0], thumbnail)
            for i, n_units in enumerate(layers):
                self.features.add(_stage(block, n_units, channels[i + 1],
                                         1 if i == 0 else 2, i + 1,
                                         channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """Pre-activation ResNet: input-normalising BN → stem → stages → final
    BN+relu → global pool → classifier."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("need one channel count per stage plus the stem")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False))
            _imagenet_stem(self.features, channels[0], thumbnail)
            width = channels[0]
            for i, n_units in enumerate(layers):
                self.features.add(_stage(block, n_units, channels[i + 1],
                                         1 if i == 0 else 2, i + 1, width))
                width = channels[i + 1]
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=width)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


resnet_spec = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
               34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
               50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
               101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
               152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [{"basic_block": BasicBlockV1,
                          "bottle_neck": BottleneckV1},
                         {"basic_block": BasicBlockV2,
                          "bottle_neck": BottleneckV2}]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """A ResNet by (version, depth).  ``pretrained=True`` raises: no
    store of weights is in the repository (carry weights in with
    ``weights.gluon_params_from_numpy``)."""
    if num_layers not in resnet_spec:
        raise ValueError(f"Invalid number of layers: {num_layers}. "
                         f"Options are {sorted(resnet_spec)}")
    if version not in (1, 2):
        raise ValueError(f"Invalid resnet version: {version}.")
    if pretrained:
        no_pretrained(f"resnet{num_layers}_v{version}")
    block_kind, layers, channels = resnet_spec[num_layers]
    net_cls = resnet_net_versions[version - 1]
    block_cls = resnet_block_versions[version - 1][block_kind]
    return net_cls(block_cls, layers, channels, **kwargs)


def _register_factories():
    for depth in sorted(resnet_spec):
        for version in (1, 2):
            name = f"resnet{depth}_v{version}"

            def _factory(version=version, depth=depth, **kwargs):
                return get_resnet(version, depth, **kwargs)
            _factory.__name__ = name
            _factory.__qualname__ = name
            _factory.__doc__ = f"ResNet-{depth} v{version} model."
            globals()[name] = _factory


_register_factories()
