"""Vision model zoo of the port (parity: gluon/model_zoo/vision): every
family of the JAX package, on the port's layers: AlexNet, DenseNet
121-201, Inception-v3, MobileNet v1 and v2, ResNet v1 and v2 (18-152),
SqueezeNet 1.0 and 1.1, and VGG 11-19 with and without BatchNorm.  No
weights are shipped: ``pretrained=True`` loads ``root/<name>.params``
from a local directory, and ``load_jax_params`` carries the JAX
package's weights."""
from ....base import MXNetError
from ._base import load_jax_params  # noqa: F401
from .alexnet import AlexNet, alexnet  # noqa: F401
from .densenet import (DenseNet, densenet121, densenet161,  # noqa: F401
                       densenet169, densenet201)
from .inception import Inception3, inception_v3  # noqa: F401
from .mobilenet import (MobileNet, MobileNetV2, mobilenet0_25,  # noqa: F401
                        mobilenet0_5, mobilenet0_75, mobilenet1_0,
                        mobilenet_v2_0_25, mobilenet_v2_0_5,
                        mobilenet_v2_0_75, mobilenet_v2_1_0)
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1,  # noqa: F401
                     BottleneckV2, ResNetV1, ResNetV2, get_resnet,
                     resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
                     resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2,
                     resnet152_v1, resnet152_v2)
from .squeezenet import (SqueezeNet, squeezenet1_0,  # noqa: F401
                         squeezenet1_1)
from .vgg import (VGG, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,  # noqa: F401
                  vgg16_bn, vgg19, vgg19_bn)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "inceptionv3": inception_v3,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25,
}


def get_model(name, **kwargs):
    """Create a model by name (parity: model_zoo/vision get_model)."""
    name = name.lower()
    if name not in _models:
        raise MXNetError("Model %s is not supported. Available: %s"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
