"""Activation blocks (counterpart of ``mxnet_tpu/gluon/nn/activations.py``).

Only :class:`Activation`, with the ``act_type``s the JAX ``Activation`` op
accepts (``mxnet_tpu/ops/nn_ops.py:416``): relu, sigmoid, tanh, softrelu
(softplus) and softsign.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..block import Block

__all__ = ["Activation"]

_ACT = {"relu": F.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
        "softrelu": F.softplus, "softsign": F.softsign}


class Activation(Block):
    def __init__(self, activation):
        super().__init__()
        if activation not in _ACT:
            raise ValueError("unknown act_type %s" % activation)
        self._act_type = activation

    def forward(self, x):
        return _ACT[self._act_type](x)

    def extra_repr(self):
        return self._act_type
