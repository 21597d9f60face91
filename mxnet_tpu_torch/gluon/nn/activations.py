"""Activation blocks (counterpart of ``mxnet_tpu/gluon/nn/activations.py``).

Only :class:`Activation`, with the ``act_type``s the JAX ``Activation`` op
accepts (``mxnet_tpu/ops/nn_ops.py:416``): relu, sigmoid, tanh, softrelu
(softplus) and softsign.
"""
from __future__ import annotations

from ...ops.nn_ops import ACTIVATIONS
from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    def __init__(self, activation, prefix=None, params=None):
        if activation not in ACTIVATIONS:
            raise ValueError("unknown act_type %s" % activation)
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def forward(self, x):
        return ACTIVATIONS[self._act_type](x)

    def extra_repr(self):
        return self._act_type
