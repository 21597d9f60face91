"""``mx.nd``, the imperative array package (counterpart of
``mxnet_tpu/ndarray/__init__.py``): :class:`NDArray`, its creators,
``moveaxis``, one function per registered op, ``random`` (the samplers),
``linalg``, and ``save``/``load`` (``.params`` files)."""
import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers the built-in ops)
from . import linalg, random  # noqa: F401
from . import register as _register
from .ndarray import (NDArray, arange, array, concat, empty, full, invoke,
                      moveaxis, ones, stack, waitall, zeros)
from .utils import load, save

_register.install_ops(_sys.modules[__name__])


class _Internal:
    """``mx.nd._internal``: the ``_``-prefixed ops, which live on ``nd``
    itself as in the JAX package."""

    def __getattr__(self, name):
        from ..ops.registry import list_ops
        # registry-gated: nd also holds underscore names that are not ops
        if name.startswith("_") and not name.startswith("__") \
                and name in list_ops():
            return getattr(_sys.modules[__name__], name)
        raise AttributeError("mx.nd._internal has no op %r" % name)


_internal = _Internal()
