"""Gluon (counterpart of ``mxnet_tpu/gluon``): layers as ``Block``s
(``nn.Module``s with Gluon's names, parameters, deferred shapes and
``cast``), parameters, losses, the Trainer and the model zoo."""
from . import block, loss, model_zoo, nn, parameter
from .block import Block
from .trainer import Trainer

__all__ = ["Block", "block", "nn", "loss", "model_zoo", "parameter",
           "Trainer"]
