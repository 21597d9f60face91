"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

The JAX package ``mxnet_tpu`` is the reference; this package answers to it
module for module and runs on an NVIDIA H100.  It imports ``torch`` and never
``jax``, and nothing of ``mxnet_tpu``.  Entry points run on the card
(``cuda:0``) unless the caller passes ``device="cpu"``; with no CUDA device
and no explicit device they raise :class:`MXNetError`.

Ported so far: the flash-attention TransformerLM, served through
``serving.ModelServer`` and trained through ``autograd``, ``gluon.loss``,
``gluon.Trainer`` and the SGD and Adam optimizers, with attention in a
hand-written CUDA kernel (``ops/cuda_ops.py``, ``csrc/flash_attention.cu``);
and ResNet v1/v2 (``gluon.model_zoo.vision``) on the Gluon conv, pooling
and BatchNorm layers, trained by the example's ``fit_gluon`` loop
(``models/image_classification.py``) with SGD and ``metric.Accuracy``.
"""
from . import metric
from .base import MXNetError
from .context import cpu, current_context, gpu, tpu

__all__ = ["MXNetError", "cpu", "gpu", "tpu", "current_context", "metric"]
