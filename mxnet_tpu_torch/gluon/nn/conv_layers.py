"""Convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` (reference
python/mxnet/gluon/nn/conv_layers.py): ``Conv1D/2D/3D``, the max,
average and global pools at 1-3 D, and ``ReflectionPad2D``, with the
same signatures and ``weight``/``bias`` names.  The classes per rank
are made from one rank-generic convolution and one pooling core, as in
the JAX package.  The ``Conv*Transpose`` layers need the Deconvolution
op (ROADMAP A.5) and raise.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _per_axis(value, rank):
    return (value,) * rank if isinstance(value, int) else tuple(value)


class _Conv(HybridBlock):
    """Rank-generic convolution: (out, in / groups, *kernel) weights."""

    def __init__(self, rank, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout=None, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(**kwargs)
        if layout != _LAYOUTS[rank]:
            raise MXNetError("%s: layout %r; the Gluon convolutions of the "
                             "PyTorch port take %s data" % (
                                 type(self).__name__, layout,
                                 _LAYOUTS[rank]))
        self._channels = channels
        kernel = _per_axis(kernel_size, rank)
        self._kwargs = {
            "kernel": kernel, "stride": _per_axis(strides, rank),
            "dilate": _per_axis(dilation, rank),
            "pad": _per_axis(padding, rank), "num_filter": channels,
            "num_group": groups, "no_bias": not use_bias}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels),
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _weight_shape(self, in_ch):
        g = self._kwargs["num_group"]
        return (self._channels, in_ch // g if in_ch else 0) + \
            self._kwargs["kernel"]

    def _infer_param_shapes(self, x):
        self.weight._shape_from_data(self._weight_shape(x.shape[1]))

    def hybrid_forward(self, F, x, weight, bias=None):
        kw = dict(self._kwargs, no_bias=bias is None)
        out = F.Convolution(x, weight, **kw) if bias is None \
            else F.Convolution(x, weight, bias, **kw)
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        return "%s(%s, kernel_size=%s, stride=%s)" % (
            type(self).__name__, self._channels, self._kwargs["kernel"],
            self._kwargs["stride"])


def _conv_init(rank):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout=_LAYOUTS[rank],
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        _Conv.__init__(self, rank, channels, kernel_size, strides, padding,
                       dilation, groups, layout, activation, use_bias,
                       weight_initializer, bias_initializer, in_channels,
                       **kwargs)
    return __init__


def _transposed_init(name):
    def __init__(self, *args, **kwargs):
        raise MXNetError("nn.%s needs the Deconvolution op, which is not in "
                         "the PyTorch port yet (ROADMAP A.5)" % name)
    return __init__


class _Pooling(HybridBlock):
    """Rank-generic pooling over the trailing spatial axes."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {
            "kernel": pool_size,
            "stride": pool_size if strides is None else strides,
            "pad": padding, "pool_type": pool_type,
            "global_pool": global_pool,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "%s(size=%s, stride=%s, pad=%s)" % (
            type(self).__name__, self._kwargs["kernel"],
            self._kwargs["stride"], self._kwargs["pad"])


def _pool_init(rank, kind):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 layout=_LAYOUTS[rank], ceil_mode=False,
                 count_include_pad=True, **kwargs):
        _Pooling.__init__(
            self, _per_axis(pool_size, rank),
            None if strides is None else _per_axis(strides, rank),
            _per_axis(padding, rank), ceil_mode, False, kind,
            count_include_pad if kind == "avg" else None, **kwargs)
    return __init__


def _global_pool_init(rank, kind):
    def __init__(self, layout=_LAYOUTS[rank], **kwargs):
        _Pooling.__init__(self, (1,) * rank, None, (0,) * rank, True, True,
                          kind, **kwargs)
    return __init__


def _register_layer_classes():
    for rank in (1, 2, 3):
        name = "Conv%dD" % rank
        globals()[name] = type(name, (_Conv,), {
            "__init__": _conv_init(rank), "__module__": __name__,
            "__doc__": "%d-D convolution layer (reference %s)."
                       % (rank, name)})
        tname = name + "Transpose"
        globals()[tname] = type(tname, (_Conv,), {
            "__init__": _transposed_init(tname), "__module__": __name__,
            "__doc__": "%d-D transposed convolution: needs the "
                       "Deconvolution op (ROADMAP A.5)." % rank})
        for kind in ("max", "avg"):
            pname = "%sPool%dD" % (kind.capitalize(), rank)
            globals()[pname] = type(pname, (_Pooling,), {
                "__init__": _pool_init(rank, kind), "__module__": __name__,
                "__doc__": "%d-D %s pooling (reference %s)."
                           % (rank, kind, pname)})
            gname = "Global" + pname
            globals()[gname] = type(gname, (_Pooling,), {
                "__init__": _global_pool_init(rank, kind),
                "__module__": __name__,
                "__doc__": "Global %d-D %s pooling." % (rank, kind)})


_register_layer_classes()


class ReflectionPad2D(HybridBlock):
    """Reflect-pad the two trailing spatial axes; an int pads H and W on
    both sides (the 8-tuple is the Pad op's ``pad_width``)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0) + (padding,) * 4
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
