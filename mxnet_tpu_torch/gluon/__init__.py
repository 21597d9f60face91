"""Gluon (counterpart of ``mxnet_tpu/gluon``): layers as ``Block``s
(``nn.Module``s with Gluon's names, parameters, deferred shapes and
``cast``), parameters, losses, the Trainer, the model zoo, and the data
API (``gluon.data``: datasets, samplers, the DataLoader), and the
recurrent cells and layers (``gluon.rnn``)."""
from . import block, contrib, data, loss, model_zoo, nn, parameter, rnn
from .block import Block, HybridBlock
from .trainer import Trainer

__all__ = ["Block", "block", "contrib", "data", "nn", "loss", "model_zoo",
           "parameter", "rnn", "Trainer"]
