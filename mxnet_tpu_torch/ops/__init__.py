"""Operators (counterpart of ``mxnet_tpu/ops``): the op registry and the
registered ops (``elemwise``, ``tensor_ops``, ``reduce_ops``, ``nn_ops``,
``optimizer_ops``, ``random_ops``, ``cuda_ops``), flash attention with its
hand-written CUDA kernel, and the optimizer updates as plain PyTorch
functions."""
from . import (elemwise, nn_ops, random_ops, reduce_ops,  # noqa: F401
               registry, tensor_ops)
from .cuda_ops import flash_attention
from .optimizer_ops import adam_update, sgd_mom_update, sgd_update
from .registry import get_op, list_ops

__all__ = ["flash_attention", "sgd_update", "sgd_mom_update", "adam_update",
           "get_op", "list_ops"]

nn_ops.set_symbol_specs()
