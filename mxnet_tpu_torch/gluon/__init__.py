"""Gluon (counterpart of ``mxnet_tpu/gluon``): layers as ``nn.Module``s,
losses, the Trainer and the model zoo."""
from . import loss, model_zoo, nn
from .trainer import Trainer

__all__ = ["nn", "loss", "model_zoo", "Trainer"]
