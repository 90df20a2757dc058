"""Vision model zoo of the port (parity: gluon/model_zoo/vision): the
ResNets v1 and v2, 18 to 152 layers.  ``get_model`` knows the JAX
package's other families by name and raises for them: AlexNet, VGG,
DenseNet, SqueezeNet, Inception-v3 and MobileNet come with a later
slice (``ROADMAP.md``)."""
from ....base import MXNetError
from ._base import load_jax_params  # noqa: F401
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1,  # noqa: F401
                     BottleneckV2, ResNetV1, ResNetV2, get_resnet,
                     resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
                     resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2,
                     resnet152_v1, resnet152_v2)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
}

# the JAX package's other families, by name
_LATER = (
    "vgg11", "vgg13", "vgg16", "vgg19",
    "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "alexnet",
    "densenet121", "densenet161", "densenet169", "densenet201",
    "squeezenet1.0", "squeezenet1.1", "inceptionv3",
    "mobilenet1.0", "mobilenet0.75", "mobilenet0.5", "mobilenet0.25",
    "mobilenetv2_1.0", "mobilenetv2_0.75", "mobilenetv2_0.5",
    "mobilenetv2_0.25",
)


def get_model(name, **kwargs):
    """Create a model by name (parity: model_zoo/vision get_model)."""
    name = name.lower()
    if name in _LATER:
        raise MXNetError("Model %s is not ported yet: the vision families "
                         "other than ResNet come with a later slice of the "
                         "port (ROADMAP.md, S6b)" % name)
    if name not in _models:
        raise MXNetError("Model %s is not supported. Available: %s"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
