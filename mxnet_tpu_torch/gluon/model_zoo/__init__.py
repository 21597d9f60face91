"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``): the vision
models ported so far."""
from . import vision

__all__ = ["vision"]
