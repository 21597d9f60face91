"""``mx.contrib`` (counterpart of ``mxnet_tpu/contrib/``): post-training
int8 quantization (``quantization``).  Control flow, the text utilities,
SVRG, TensorBoard and ONNX are not ported yet."""
from . import quantization  # noqa: F401

__all__ = ["quantization"]
