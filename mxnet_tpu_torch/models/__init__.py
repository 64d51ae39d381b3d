"""Model zoo of the PyTorch port (counterpart of ``mxnet_tpu/models``):
the transformer LM, LeNet and ResNet.  ``get_symbol(network, ...)``
mirrors the image-classification harness's factory; the other networks
of the JAX package's zoo come with later slices."""
from ..base import MXNetError
from . import lenet, resnet, transformer

__all__ = ["get_symbol", "lenet", "resnet", "transformer"]

_NETWORKS = {"transformer": transformer, "lenet": lenet, "resnet": resnet}


def get_symbol(network, **kwargs):
    """``models.get_symbol('resnet', num_classes=1000, num_layers=50,
    image_shape=(3, 224, 224))``."""
    if network not in _NETWORKS:
        raise MXNetError("network %r is not in the PyTorch port yet; "
                         "available: %s" % (network, sorted(_NETWORKS)))
    return _NETWORKS[network].get_symbol(**kwargs)
