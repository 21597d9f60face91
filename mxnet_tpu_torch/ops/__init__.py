"""Operators (counterpart of ``mxnet_tpu/ops``; the op registry comes in a
later slice): flash attention with its hand-written CUDA kernel, and the
optimizer updates as plain PyTorch functions."""
from .cuda_ops import flash_attention
from .optimizer_ops import adam_update, sgd_mom_update, sgd_update

__all__ = ["flash_attention", "sgd_update", "sgd_mom_update", "adam_update"]
