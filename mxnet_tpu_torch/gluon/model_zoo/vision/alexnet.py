"""Gluon AlexNet (Krizhevsky et al. 2012, the one-column variant used by
torchvision and the reference model zoo).

API parity with ``python/mxnet/gluon/model_zoo/vision/alexnet.py``.

CONTRACT CONSTRAINT: layer construction order is pinned by the reference
checkpoint's parameter names (``alexnet0_conv0_weight``...); the
table-driven builder below reproduces that order from the paper's
architecture, not the reference's statement sequence.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``: the same
blocks in the same order, so every parameter has the JAX package's
name.  ``pretrained=True`` raises: no store of weights is in the
repository.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ..model_store import no_pretrained

__all__ = ["AlexNet", "alexnet"]

# Convolutional stem: (channels, kernel, stride, pad, maxpool-after?).
_STEM = [
    (64, 11, 4, 2, True),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, False),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, True),
]

_HEAD_WIDTH = 4096
_DROP_RATE = 0.5


def _build_features():
    seq = nn.HybridSequential(prefix="")
    with seq.name_scope():
        for ch, k, s, p, pool_after in _STEM:
            seq.add(nn.Conv2D(ch, kernel_size=k, strides=s, padding=p,
                              activation="relu"))
            if pool_after:
                seq.add(nn.MaxPool2D(pool_size=3, strides=2))
        seq.add(nn.Flatten())
        for _ in range(2):
            seq.add(nn.Dense(_HEAD_WIDTH, activation="relu"))
            seq.add(nn.Dropout(_DROP_RATE))
    return seq


class AlexNet(HybridBlock):
    """Five relu convs (pools after 1, 2 and 5) then two dropout-regularised
    4096-wide relu Dense layers and a linear classifier."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = _build_features()
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    """AlexNet factory; ``pretrained=True`` raises (no store of
    weights)."""
    if pretrained:
        no_pretrained("alexnet")
    return AlexNet(**kwargs)
