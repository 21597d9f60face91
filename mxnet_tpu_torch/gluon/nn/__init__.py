"""Gluon ``nn`` layers ported so far (counterpart of
``mxnet_tpu/gluon/nn``)."""
from .basic_layers import Dense, Embedding, HybridSequential, LayerNorm

__all__ = ["Dense", "Embedding", "HybridSequential", "LayerNorm"]
