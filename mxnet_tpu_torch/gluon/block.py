"""Blocks (counterpart of ``mxnet_tpu/gluon/block.py``).

:class:`Block` is the ``torch.nn.Module`` every layer, loss and model of
the port derives from.  It holds ``Block.cast`` (:259-263) and Gluon's
boundary for NDArrays (:265, :378-384): a block called with NDArray
arguments runs on their tensors and returns NDArrays; called with tensors
it returns tensors.  ``functional_call`` and ``param_values`` wait for
their port.
"""
from __future__ import annotations

from torch import nn

from ..base import as_dtype
from ..ndarray.ndarray import NDArray
from . import parameter

__all__ = ["Block"]


class Block(nn.Module):
    """An ``nn.Module`` with Gluon's ``cast`` and NDArray boundary."""

    def __call__(self, *args, **kwargs):
        if not any(isinstance(a, NDArray) for a in args):
            return super().__call__(*args, **kwargs)
        out = super().__call__(*(a._data if isinstance(a, NDArray) else a
                                 for a in args), **kwargs)
        if isinstance(out, (tuple, list)):
            return type(out)(NDArray(o) for o in out)
        return NDArray(out)

    def cast(self, dtype):
        """Cast the children (by their own rule), then this block's own
        parameters and floating-point buffers (BatchNorm's running
        statistics, which Gluon keeps as parameters), to ``dtype``: a name
        such as ``"bfloat16"``, a numpy or a torch dtype."""
        dtype = as_dtype(dtype)
        for child in self.children():
            if isinstance(child, Block):
                child.cast(dtype)
            else:
                Block.cast(child, dtype)
        for param in self._parameters.values():
            if param is not None:
                parameter.cast(param, dtype)
        for name, buf in self._buffers.items():
            if buf is not None and buf.is_floating_point():
                self._buffers[name] = buf.to(dtype)
        return self
