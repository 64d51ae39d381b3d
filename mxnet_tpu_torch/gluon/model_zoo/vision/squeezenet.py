"""Gluon SqueezeNet 1.0/1.1 (Iandola et al. 1602.07360; 1.1 is the
forum-released variant with the same accuracy at ~2.4x less compute).

API parity with ``python/mxnet/gluon/model_zoo/vision/squeezenet.py``.

CONTRACT CONSTRAINT: checkpoint parameter names pin the construction order
of parametered layers; the per-version plan tables below re-derive that
order from the paper's macro-architecture table.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``: the same
blocks in the same order, so every parameter has the JAX package's
name.  ``pretrained=True`` raises: no store of weights is in the
repository.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ..model_store import no_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]

_POOL = "pool"
# (stem_channels, stem_kernel, plan); plan entries are either _POOL or a
# fire module's (squeeze, expand1x1, expand3x3) widths.
_PLANS = {
    "1.0": (96, 7, [_POOL, (16, 64, 64), (16, 64, 64), (32, 128, 128),
                    _POOL, (32, 128, 128), (48, 192, 192), (48, 192, 192),
                    (64, 256, 256), _POOL, (64, 256, 256)]),
    "1.1": (64, 3, [_POOL, (16, 64, 64), (16, 64, 64),
                    _POOL, (32, 128, 128), (32, 128, 128),
                    _POOL, (48, 192, 192), (48, 192, 192),
                    (64, 256, 256), (64, 256, 256)]),
}


def _relu_conv(channels, kernel, padding=0):
    seq = nn.HybridSequential(prefix="")
    seq.add(nn.Conv2D(channels, kernel, padding=padding))
    seq.add(nn.Activation("relu"))
    return seq


class _FireExpand(HybridBlock):
    """The fire module's two parallel expand convs, channel-concatenated."""

    def __init__(self, expand1x1, expand3x3, **kwargs):
        super().__init__(**kwargs)
        self.p1 = _relu_conv(expand1x1, 1)
        self.p2 = _relu_conv(expand3x3, 3, 1)

    def hybrid_forward(self, F, x):
        return F.concat(self.p1(x), self.p2(x), dim=1)


def _fire(squeeze, expand1x1, expand3x3):
    seq = nn.HybridSequential(prefix="")
    seq.add(_relu_conv(squeeze, 1))
    seq.add(_FireExpand(expand1x1, expand3x3))
    return seq


class SqueezeNet(HybridBlock):
    """Strided stem conv, fire modules interleaved with ceil-mode maxpools
    per the version plan, then a 1x1-conv classifier head (no Dense)."""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        try:
            stem_ch, stem_k, plan = _PLANS[version]
        except KeyError:
            raise ValueError(f"Unsupported SqueezeNet version {version}: "
                             f"1.0 or 1.1 expected") from None
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(stem_ch, kernel_size=stem_k, strides=2))
            self.features.add(nn.Activation("relu"))
            for step in plan:
                if step is _POOL:
                    self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                                   ceil_mode=True))
                else:
                    self.features.add(_fire(*step))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, ctx=None, root=None, **kwargs):
    if pretrained:
        no_pretrained(f"squeezenet{version}")
    return SqueezeNet(version, **kwargs)


def squeezenet1_0(**kwargs):
    """SqueezeNet 1.0 from the paper."""
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    """SqueezeNet 1.1: same accuracy, ~2.4x cheaper."""
    return get_squeezenet("1.1", **kwargs)
