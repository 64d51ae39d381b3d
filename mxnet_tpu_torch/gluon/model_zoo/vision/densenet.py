"""Gluon DenseNet 121/161/169/201 (Huang et al. 1608.06993).

API parity with ``python/mxnet/gluon/model_zoo/vision/densenet.py``.

CONTRACT CONSTRAINT: checkpoint parameter names pin the construction order
of parametered layers; the composite-function builder below re-derives the
architecture (BN-relu-conv composite functions, dense concatenation,
half-width transitions) from the paper.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/densenet.py``: the same
blocks in the same order, so every parameter has the JAX package's
name.  ``pretrained=True`` raises: no store of weights is in the
repository.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ..model_store import no_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]

# depth -> (stem width, growth rate k, layers per dense block)
densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def _composite(seq, channels, kernel, padding=0):
    """The paper's composite function H: BN → relu → conv."""
    seq.add(nn.BatchNorm())
    seq.add(nn.Activation("relu"))
    seq.add(nn.Conv2D(channels, kernel_size=kernel, padding=padding,
                      use_bias=False))


class _DenseLayer(HybridBlock):
    """Bottlenecked composite (1x1 to bn_size*k, then 3x3 to k channels);
    output is the input with the k new feature maps concatenated."""

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        _composite(self.body, bn_size * growth_rate, 1)
        _composite(self.body, growth_rate, 3, padding=1)
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def hybrid_forward(self, F, x):
        return F.concat(x, self.body(x), dim=1)


def _dense_stage(n_layers, bn_size, growth_rate, dropout, index):
    stage = nn.HybridSequential(prefix=f"stage{index}_")
    with stage.name_scope():
        for _ in range(n_layers):
            stage.add(_DenseLayer(growth_rate, bn_size, dropout))
    return stage


def _transition(channels):
    """Between dense blocks: composite 1x1 conv then 2x2 average pool."""
    seq = nn.HybridSequential(prefix="")
    _composite(seq, channels, 1)
    seq.add(nn.AvgPool2D(pool_size=2, strides=2))
    return seq


class DenseNet(HybridBlock):
    """7x7/2 stem → dense blocks with half-width transitions → BN-relu →
    7x7 average pool → linear classifier."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                        strides=2, padding=3, use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, padding=1))
            width = num_init_features
            last = len(block_config) - 1
            for i, n_layers in enumerate(block_config):
                self.features.add(_dense_stage(n_layers, bn_size, growth_rate,
                                               dropout, i + 1))
                width += n_layers * growth_rate
                if i != last:
                    width //= 2
                    self.features.add(_transition(width))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.AvgPool2D(pool_size=7))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_densenet(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    if pretrained:
        no_pretrained(f"densenet{num_layers}")
    return DenseNet(*densenet_spec[num_layers], **kwargs)


def _register_factories():
    for depth in sorted(densenet_spec):
        name = f"densenet{depth}"

        def _factory(depth=depth, **kwargs):
            return get_densenet(depth, **kwargs)
        _factory.__name__ = name
        _factory.__qualname__ = name
        _factory.__doc__ = f"DenseNet-{depth} model."
        globals()[name] = _factory


_register_factories()
