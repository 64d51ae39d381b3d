"""Gluon MobileNet v1 (Howard et al. 1704.04861, depthwise-separable convs)
and v2 (Sandler et al. 1801.04381, inverted residuals / linear bottlenecks).

API parity with ``python/mxnet/gluon/model_zoo/vision/mobilenet.py``.

CONTRACT CONSTRAINT: checkpoint parameter names pin the construction order
of parametered layers (conv→BN triplets, the v2 ``features_``/``output_``/
``pred_`` prefixes); the stage tables below re-derive the architectures
from the papers' layer tables.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``: the same
blocks in the same order, so every parameter has the JAX package's
name.  ``pretrained=True`` raises: no store of weights is in the
repository.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ..model_store import no_pretrained

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25"]

# v1 paper table 1 as (pointwise_out, stride) per separable block; the
# depthwise width equals the previous block's output width.
_V1_BLOCKS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
              (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
              (1024, 1)]

# v2 paper table 2 as (expansion t, out_channels, stride) per bottleneck,
# with each "n>1" row unrolled (stride applies to the first repeat).
_V2_BLOCKS = [(1, 16, 1),
              (6, 24, 2), (6, 24, 1),
              (6, 32, 2), (6, 32, 1), (6, 32, 1),
              (6, 64, 2), (6, 64, 1), (6, 64, 1), (6, 64, 1),
              (6, 96, 1), (6, 96, 1), (6, 96, 1),
              (6, 160, 2), (6, 160, 1), (6, 160, 1),
              (6, 320, 1)]


class _RELU6(HybridBlock):
    """clip(x, 0, 6) — v2's quantization-friendly activation."""

    def hybrid_forward(self, F, x):
        return F.clip(x, a_min=0, a_max=6)


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    """conv → BN → (relu|relu6); the building triplet for both versions."""
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm(scale=True))
    if active:
        out.add(_RELU6() if relu6 else nn.Activation("relu"))


def _add_separable(out, dw_width, pw_width, stride):
    """v1 separable block: 3x3 depthwise (one group per channel) then 1x1
    pointwise, each with BN+relu."""
    _add_conv(out, dw_width, kernel=3, stride=stride, pad=1,
              num_group=dw_width)
    _add_conv(out, pw_width)


class _LinearBottleneck(HybridBlock):
    """v2 inverted residual: 1x1 expand (xt, relu6) → 3x3 depthwise →
    1x1 project (linear); identity shortcut when shape-preserving."""

    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        mid = in_channels * t
        with self.name_scope():
            self.out = nn.HybridSequential()
            _add_conv(self.out, mid, relu6=True)
            _add_conv(self.out, mid, kernel=3, stride=stride, pad=1,
                      num_group=mid, relu6=True)
            _add_conv(self.out, channels, active=False, relu6=True)

    def hybrid_forward(self, F, x):
        y = self.out(x)
        return y + x if self.use_shortcut else y


class MobileNet(HybridBlock):
    """v1: strided 3x3 stem, 13 depthwise-separable blocks, global pool,
    Dense classifier.  ``multiplier`` scales every width."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        scale = lambda w: int(w * multiplier)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                _add_conv(self.features, channels=scale(32), kernel=3,
                          pad=1, stride=2)
                prev = 32
                for width, stride in _V1_BLOCKS:
                    _add_separable(self.features, scale(prev), scale(width),
                                   stride)
                    prev = width
                self.features.add(nn.GlobalAvgPool2D())
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    """v2: relu6 stem, 17 linear bottlenecks, 1280-wide head conv, global
    pool, and a 1x1-conv classifier (``output_pred_`` in checkpoints)."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        scale = lambda w: int(w * multiplier)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="features_")
            with self.features.name_scope():
                _add_conv(self.features, scale(32), kernel=3, stride=2,
                          pad=1, relu6=True)
                prev = 32
                for t, width, stride in _V2_BLOCKS:
                    self.features.add(_LinearBottleneck(
                        in_channels=scale(prev), channels=scale(width),
                        t=t, stride=stride))
                    prev = width
                head = scale(1280) if multiplier > 1.0 else 1280
                _add_conv(self.features, head, relu6=True)
                self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.HybridSequential(prefix="output_")
            with self.output.name_scope():
                self.output.add(
                    nn.Conv2D(classes, 1, use_bias=False, prefix="pred_"),
                    nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _store_suffix(multiplier):
    """Model-store spelling of the multiplier: '1.0'/'0.5' keep one decimal,
    '0.75'/'0.25' keep two."""
    text = f"{multiplier:.2f}"
    return text[:-1] if text.endswith("0") else text


def get_mobilenet(multiplier, pretrained=False, ctx=None, root=None,
                  **kwargs):
    if pretrained:
        no_pretrained(f"mobilenet{_store_suffix(multiplier)}")
    return MobileNet(multiplier, **kwargs)


def get_mobilenet_v2(multiplier, pretrained=False, ctx=None, root=None,
                     **kwargs):
    if pretrained:
        no_pretrained(f"mobilenetv2_{_store_suffix(multiplier)}")
    return MobileNetV2(multiplier, **kwargs)


def _register_factories():
    for mult in (1.0, 0.75, 0.5, 0.25):
        tag = str(mult).replace(".", "_")
        for ver, factory in ((1, get_mobilenet), (2, get_mobilenet_v2)):
            name = f"mobilenet{tag}" if ver == 1 else f"mobilenet_v2_{tag}"

            def _f(mult=mult, factory=factory, **kwargs):
                return factory(mult, **kwargs)
            _f.__name__ = name
            _f.__qualname__ = name
            _f.__doc__ = f"MobileNet v{ver}, width multiplier {mult}."
            globals()[name] = _f


_register_factories()
