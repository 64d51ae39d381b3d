"""The multilayer perceptron of the image-classification examples
(counterpart of ``mxnet_tpu/models/mlp.py``; reference
example/image-classification/symbols/mlp.py): train_mnist's default
network."""
from .. import symbol as sym

_HIDDEN = (128, 64)


def get_symbol(num_classes=10, **kwargs):
    """Flatten -> fc1 (128) / relu1 -> fc2 (64) / relu2 -> fc3
    (``num_classes``) -> softmax; other keyword arguments (the harness's
    ``num_layers``, ``image_shape``, ``dtype``) are accepted and change
    nothing, as in the JAX package."""
    net = sym.Flatten(data=sym.Variable("data"))
    for i, width in enumerate(_HIDDEN, start=1):
        net = sym.FullyConnected(data=net, name="fc%d" % i, num_hidden=width)
        net = sym.Activation(data=net, name="relu%d" % i, act_type="relu")
    net = sym.FullyConnected(data=net, name="fc%d" % (len(_HIDDEN) + 1),
                             num_hidden=num_classes)
    return sym.SoftmaxOutput(data=net, name="softmax")
