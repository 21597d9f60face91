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
(``models/image_classification.py``) with SGD and ``metric.Accuracy``;
the imperative API: ``nd`` (``NDArray`` and one function per
registered op, ``ops/registry.py``) with ``autograd`` on NDArrays, the
contexts usable as ``with mx.cpu():`` scopes; and Gluon's parameter model:
names, deferred shapes, ``initialize`` drawing from ``random`` (the JAX
package's keys, so ``mx.random.seed(n)`` gives its weights),
``io.NDArrayIter``, ``.params`` files (``nd.save``/``nd.load``,
``save_parameters``) and ``gluon.block.functional_call``.
"""
from . import autograd, initializer, io, metric, ndarray, random
from . import ndarray as nd
from .base import MXNetError
from .context import cpu, current_context, gpu, tpu

init = initializer   # mx.init.Xavier()

__all__ = ["MXNetError", "cpu", "gpu", "tpu", "current_context", "metric",
           "nd", "ndarray", "autograd", "random", "initializer", "init",
           "io"]
