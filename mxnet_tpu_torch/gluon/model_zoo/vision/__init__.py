"""Vision models (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): ResNet v1 and v2, VGG,
AlexNet, SqueezeNet, DenseNet, MobileNet v1 and v2 and Inception v3, and
``get_model`` over every name the JAX package's takes (:24-48)."""
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201)
from .inception import Inception3, inception_v3
from .mobilenet import (MobileNet, MobileNetV2, get_mobilenet,
                        get_mobilenet_v2, mobilenet0_5, mobilenet0_25,
                        mobilenet0_75, mobilenet1_0, mobilenet_v2_0_5,
                        mobilenet_v2_0_25, mobilenet_v2_0_75,
                        mobilenet_v2_1_0)
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1,
                     resnet18_v2, resnet34_v1, resnet34_v2, resnet50_v1,
                     resnet50_v2, resnet101_v1, resnet101_v2, resnet152_v1,
                     resnet152_v2)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .vgg import (VGG, get_vgg, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,
                  vgg16_bn, vgg19, vgg19_bn)

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet", "get_model",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2", "AlexNet", "alexnet", "VGG",
           "get_vgg", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn", "SqueezeNet",
           "squeezenet1_0", "squeezenet1_1", "DenseNet", "densenet121",
           "densenet161", "densenet169", "densenet201", "MobileNet",
           "MobileNetV2", "get_mobilenet", "get_mobilenet_v2",
           "mobilenet1_0", "mobilenet0_75", "mobilenet0_5", "mobilenet0_25",
           "mobilenet_v2_1_0", "mobilenet_v2_0_75", "mobilenet_v2_0_5",
           "mobilenet_v2_0_25", "Inception3", "inception_v3"]

_MODELS = {
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
    """The model called ``name`` (``vision/__init__.py:91``), built with
    ``kwargs`` (``classes``, ``device``, ``pretrained``, a ResNet's
    ``thumbnail`` and ``layout``, ...)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError("Model %s is not supported. Available options are"
                         "\n\t%s" % (name, "\n\t".join(sorted(_MODELS))))
    return _MODELS[name](**kwargs)
