"""Gluon ``nn`` layers ported so far (counterpart of
``mxnet_tpu/gluon/nn``)."""
from .activations import Activation
from .basic_layers import (BatchNorm, Dense, Embedding, Flatten,
                           HybridSequential, LayerNorm)
from .conv_layers import (AvgPool2D, Conv1D, Conv2D, Conv3D,
                          GlobalAvgPool2D, GlobalMaxPool2D, MaxPool2D,
                          channels_last)

__all__ = ["Activation", "AvgPool2D", "BatchNorm", "Conv1D", "Conv2D",
           "Conv3D", "Dense", "Embedding", "Flatten", "GlobalAvgPool2D",
           "GlobalMaxPool2D", "HybridSequential", "LayerNorm", "MaxPool2D",
           "channels_last"]
