"""Model zoo of the PyTorch port (counterpart of ``mxnet_tpu/models``):
the transformer LM and the image-classification harness's symbols (mlp,
lenet, alexnet, vgg, resnet, resnext, mobilenet, inception-bn,
googlenet, squeezenet, densenet), each ``get_symbol(num_classes, ...)``
ending in SoftmaxOutput with the JAX package's node names.
``get_symbol(network, ...)`` mirrors the harness's factory."""
from ..base import MXNetError
from . import (alexnet, densenet, googlenet, inception_bn, lenet, mlp,
               mobilenet, resnet, resnext, squeezenet, transformer, vgg)

__all__ = ["get_symbol", "alexnet", "densenet", "googlenet", "inception_bn",
           "lenet", "mlp", "mobilenet", "resnet", "resnext", "squeezenet",
           "transformer", "vgg"]

_NETWORKS = {
    "transformer": transformer,
    "mlp": mlp,
    "lenet": lenet,
    "alexnet": alexnet,
    "vgg": vgg,
    "resnet": resnet,
    "resnext": resnext,
    "mobilenet": mobilenet,
    "inception-bn": inception_bn,
    "inception_bn": inception_bn,
    "googlenet": googlenet,
    "squeezenet": squeezenet,
    "densenet": densenet,
}


def get_symbol(network, **kwargs):
    """``models.get_symbol('resnet', num_classes=1000, num_layers=50,
    image_shape=(3, 224, 224))``."""
    if network not in _NETWORKS:
        raise MXNetError("network %r is not in the PyTorch port; "
                         "available: %s" % (network, sorted(_NETWORKS)))
    return _NETWORKS[network].get_symbol(**kwargs)
