"""Gluon (counterpart of ``mxnet_tpu/gluon``): layers as ``nn.Module``s,
losses and the Trainer."""
from . import loss, nn
from .trainer import Trainer

__all__ = ["nn", "loss", "Trainer"]
