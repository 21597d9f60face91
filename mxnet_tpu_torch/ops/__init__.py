"""Operators with hand-written CUDA kernels (counterpart of
``mxnet_tpu/ops``; the op registry comes in a later slice)."""
from .cuda_ops import flash_attention

__all__ = ["flash_attention"]
