"""Gluon layers (counterpart of ``mxnet_tpu/gluon``), as ``nn.Module``s."""
from . import nn

__all__ = ["nn"]
