"""Gluon ``nn`` layers ported so far (counterpart of
``mxnet_tpu/gluon/nn``)."""
from .activations import ELU, GELU, SELU, Activation, LeakyReLU, PReLU, Swish
from .basic_layers import (BatchNorm, Dense, Dropout, Embedding, Flatten,
                           HybridLambda, HybridSequential, InstanceNorm,
                           Lambda, LayerNorm, Sequential)
from .conv_layers import (AvgPool2D, Conv1D, Conv2D, Conv3D,
                          GlobalAvgPool2D, GlobalMaxPool2D, MaxPool2D,
                          ReflectionPad2D, channels_last)

__all__ = ["Activation", "AvgPool2D", "BatchNorm", "Conv1D", "Conv2D",
           "Conv3D", "Dense", "Dropout", "ELU", "Embedding", "Flatten",
           "GELU", "GlobalAvgPool2D", "GlobalMaxPool2D", "HybridLambda",
           "HybridSequential", "InstanceNorm", "Lambda", "LayerNorm",
           "LeakyReLU", "MaxPool2D", "PReLU", "ReflectionPad2D", "SELU",
           "Sequential", "Swish", "channels_last"]
