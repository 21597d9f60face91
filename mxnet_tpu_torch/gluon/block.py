"""Blocks (counterpart of ``mxnet_tpu/gluon/block.py``).

:class:`Block` is the ``torch.nn.Module`` every layer and model of the port
derives from.  It holds only ``Block.cast`` (:259-263) so far:
``functional_call`` and ``param_values`` wait for their port.
"""
from __future__ import annotations

from torch import nn

from ..base import as_dtype
from . import parameter

__all__ = ["Block"]


class Block(nn.Module):
    """An ``nn.Module`` with Gluon's ``cast``."""

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
