"""Base error type, number types and dtype helpers (counterpart of
``mxnet_tpu/base.py``: ``MXNetError``, ``numeric_types``,
``integer_types`` and ``attrs_key``, :18-65; and of the dtype aliases of
``mxnet_tpu/ndarray/ndarray.py:34-56``).

numpy has no bfloat16 of its own: the JAX package hands out ``ml_dtypes``'
type, which this package recognises by name and never imports.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "numeric_types", "integer_types", "attrs_key",
           "as_dtype", "tensor_from_numpy"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16}

numeric_types = (float, int, np.generic)
integer_types = (int, np.integer)


class MXNetError(RuntimeError):
    """Error raised by framework internals (``mxnet_tpu.base.MXNetError``)."""


def _make_hashable(v):
    """An attribute value as a hashable key component."""
    if isinstance(v, (list, tuple)):
        return tuple(_make_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _make_hashable(x)) for k, x in v.items()))
    if isinstance(v, np.dtype):
        return v.name
    if isinstance(v, np.ndarray):
        return (v.shape, v.dtype.name, v.tobytes())
    return v


def attrs_key(attrs, skip=None):
    """A stable hashable key for an op's attribute dict, leaving out the
    key ``skip``: what a cache of per-attrs compiled ops keys on (the JAX
    package's jit caches; the port's eager dispatch keeps none yet)."""
    return tuple(sorted((k, _make_hashable(v)) for k, v in attrs.items()
                        if k != skip))


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
