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
``save_parameters``) and ``gluon.block.functional_call``; and the
compiled half: ``CachedOp`` (a forward captured as a CUDA graph per input
signature), ``HybridBlock.hybridize()``, the compiled train step, ``sym``,
the executor, ``mod.Module`` and ``callback``; and ``random``'s draws on
the card (``Dropout``, ``nd.random``), the rest of Gluon's layers and
losses, and the vision model zoo; and int8 inference
(``contrib.quantization.quantize_model`` and the quantized ops, their
products in cuBLASLt's int8 GEMM on the card); and the input pipeline:
``recordio``, the native decode library (``_native``), ``io``'s
iterators and ``DeviceFeed`` (batches staged on the card from a CUDA side
stream), ``gluon.data`` and ``image``; and the recurrent models: the
fused ``RNN`` op, ``rnn`` (the legacy symbolic cells, RNN checkpoints,
``BucketSentenceIter``), ``mod.BucketingModule``, ``SequentialModule`` and
``PythonModule``, and ``gluon.rnn`` and ``gluon.contrib.rnn``.
"""
from . import autograd, callback, initializer, io, metric, ndarray, random
from . import lr_scheduler, model, module, optimizer, symbol
from . import contrib, gluon, image, recordio, rnn
from . import module as mod
from . import ndarray as nd
from . import symbol as sym
from .attribute import AttrScope
from .base import MXNetError
from .context import cpu, cpu_pinned, current_context, gpu, tpu

init = initializer   # mx.init.Xavier()

__all__ = ["MXNetError", "cpu", "cpu_pinned", "gpu", "tpu",
           "current_context", "metric", "nd", "ndarray", "autograd",
           "random", "initializer", "init", "io", "sym", "symbol", "mod",
           "module", "callback", "model", "optimizer", "lr_scheduler",
           "AttrScope", "gluon", "contrib", "image", "recordio", "rnn"]
