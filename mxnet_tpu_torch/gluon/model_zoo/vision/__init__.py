"""Vision model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision``): the ResNets, v1 and v2, at every
depth of ``resnet_spec``.  The other families of the JAX package's zoo
are still to port (ROADMAP A.6)."""
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1,
                     resnet18_v2, resnet34_v1, resnet34_v2, resnet50_v1,
                     resnet50_v2, resnet101_v1, resnet101_v2, resnet152_v1,
                     resnet152_v2)

_models = {"resnet%d_v%d" % (d, v): globals()["resnet%d_v%d" % (d, v)]
           for d in (18, 34, 50, 101, 152) for v in (1, 2)}


def get_model(name, **kwargs):
    """A model by name (reference model_zoo get_model)."""
    name = name.lower()
    if name not in _models:
        raise ValueError("Model %s is not supported. Available: %s"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
