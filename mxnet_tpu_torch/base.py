"""Base error type and dtype helpers (counterpart of ``mxnet_tpu/base.py``,
and of the dtype aliases of ``mxnet_tpu/ndarray/ndarray.py:34-56``).

Only :class:`MXNetError` and the dtype helpers are ported; the rest of
those modules serves the op registry and NDArray, which later slices bring
over.  numpy has no bfloat16 of its own: the JAX package hands out
``ml_dtypes``' type, which this package recognises by name and never
imports.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "as_dtype", "tensor_from_numpy"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16}


class MXNetError(RuntimeError):
    """Error raised by framework internals (``mxnet_tpu.base.MXNetError``)."""


def as_dtype(dtype):
    """The torch floating dtype for ``dtype``: a name (``"bfloat16"``), a
    numpy dtype or type, or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise TypeError("dtype %r is not one of %s" % (dtype, sorted(_DTYPES)))
    return _DTYPES[name]


def tensor_from_numpy(array):
    """A CPU tensor holding a copy of ``array``, bit for bit; a bfloat16
    array (``ml_dtypes``' type) becomes a ``torch.bfloat16`` tensor of the
    same bits."""
    array = np.asarray(array)
    if array.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(array).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.tensor(array)
