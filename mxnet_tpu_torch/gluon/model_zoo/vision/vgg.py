"""Gluon VGG 11/13/16/19, plain and batch-normalised (Simonyan & Zisserman
1409.1556, configurations A/B/D/E).

API parity with ``python/mxnet/gluon/model_zoo/vision/vgg.py``.

CONTRACT CONSTRAINT: checkpoint parameter names pin the construction order
of parametered layers; the block-table builder below re-derives that order
from the paper's configuration table.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/vgg.py``: the same
blocks in the same order, so every parameter has the JAX package's
name.  ``pretrained=True`` raises: no store of weights is in the
repository.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ....initializer import Xavier
from ..model_store import no_pretrained

__all__ = ["VGG", "get_vgg", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn"]

# Paper table 1: convs-per-block for each depth; widths are shared.
vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}

_CONV_INIT = dict(
    weight_initializer=Xavier(rnd_type="gaussian", factor_type="out",
                              magnitude=2),
    bias_initializer="zeros")


class VGG(HybridBlock):
    """Stacked 3x3-conv blocks (each followed by a 2x2 maxpool), then the
    classic 4096-4096-classes head with dropout."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise ValueError("one filter width per conv block required")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for n_convs, width in zip(layers, filters):
                self._add_block(n_convs, width, batch_norm)
            for _ in range(2):
                self.features.add(nn.Dense(4096, activation="relu",
                                           weight_initializer="normal",
                                           bias_initializer="zeros"))
                self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal",
                                   bias_initializer="zeros")

    def _add_block(self, n_convs, width, batch_norm):
        for _ in range(n_convs):
            self.features.add(nn.Conv2D(width, kernel_size=3, padding=1,
                                        **_CONV_INIT))
            if batch_norm:
                self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
        self.features.add(nn.MaxPool2D(strides=2))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    """VGG-``num_layers`` factory; ``pretrained=True`` raises (no store
    of weights)."""
    if pretrained:
        suffix = "_bn" if kwargs.get("batch_norm") else ""
        no_pretrained(f"vgg{num_layers}{suffix}")
    return VGG(*vgg_spec[num_layers], **kwargs)


def _register_factories():
    for depth in sorted(vgg_spec):
        for bn in (False, True):
            name = f"vgg{depth}_bn" if bn else f"vgg{depth}"

            def _factory(depth=depth, bn=bn, **kwargs):
                if bn:
                    kwargs["batch_norm"] = True
                return get_vgg(depth, **kwargs)
            _factory.__name__ = name
            _factory.__qualname__ = name
            _factory.__doc__ = (f"VGG-{depth} model"
                                + (" with batch normalisation." if bn else "."))
            globals()[name] = _factory


_register_factories()
