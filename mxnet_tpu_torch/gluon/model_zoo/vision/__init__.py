"""Vision models (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``).  Only ResNet v1 and v2
are ported; ``get_model`` raises for any other name, listing the ported
ones."""
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1,
                     resnet18_v2, resnet34_v1, resnet34_v2, resnet50_v1,
                     resnet50_v2, resnet101_v1, resnet101_v2, resnet152_v1,
                     resnet152_v2)

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet", "get_model",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]

_MODELS = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    """The model called ``name`` (``vision/__init__.py:91``), built with
    ``kwargs`` (``classes``, ``thumbnail``, ``layout``, ``device``, ...)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError("Model %s is not supported. Available options are"
                         "\n\t%s" % (name, "\n\t".join(sorted(_MODELS))))
    return _MODELS[name](**kwargs)
