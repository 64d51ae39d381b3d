"""Vision model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision``): ResNet v1 and v2, VGG (with and
without BatchNorm), AlexNet, SqueezeNet 1.0 and 1.1, DenseNet, MobileNet
v1 and v2 and Inception v3, each with the JAX package's parameter names.
``pretrained=True`` raises: no store of weights is in the repository."""
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1,
                     resnet18_v2, resnet34_v1, resnet34_v2, resnet50_v1,
                     resnet50_v2, resnet101_v1, resnet101_v2, resnet152_v1,
                     resnet152_v2)
from .vgg import (VGG, get_vgg, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,
                  vgg16_bn, vgg19, vgg19_bn)
from .alexnet import AlexNet, alexnet
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201)
from .mobilenet import (MobileNet, MobileNetV2, mobilenet0_5, mobilenet0_25,
                        mobilenet0_75, mobilenet1_0, mobilenet_v2_0_5,
                        mobilenet_v2_0_25, mobilenet_v2_0_75,
                        mobilenet_v2_1_0)
from .inception import Inception3, inception_v3

_models = {"resnet%d_v%d" % (d, v): globals()["resnet%d_v%d" % (d, v)]
           for d in (18, 34, 50, 101, 152) for v in (1, 2)}
_models.update({
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25,
    "inceptionv3": inception_v3,
})


def get_model(name, **kwargs):
    """A model by name (reference model_zoo get_model)."""
    name = name.lower()
    if name not in _models:
        raise ValueError("Model %s is not supported. Available: %s"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
