"""Base error type (counterpart of ``mxnet_tpu/base.py``).

Only :class:`MXNetError` is ported; the rest of that module serves the op
registry and NDArray, which later slices bring over.
"""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Error raised by framework internals (``mxnet_tpu.base.MXNetError``)."""
