"""Basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``).

Only the layers the TransformerLM uses: :class:`Dense`, :class:`Embedding`,
:class:`LayerNorm` and :class:`HybridSequential`.  Parameters keep the JAX
package's shapes and names (Dense weight ``[units, in_units]``, LayerNorm
``gamma``/``beta``), so weights carry across unchanged.  Parameters are
allocated uninitialized in fp32 on ``device`` (default ``cuda:0``) and take
gradients; fill them with ``initializer.initialize`` or
``convert.load_mxnet_params``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...context import resolve_device

__all__ = ["Dense", "Embedding", "LayerNorm", "HybridSequential"]


def _param(shape, device):
    # trainable, as Gluon's grad_req='write'; freeze with
    # requires_grad_(False) (grad_req='null')
    return nn.Parameter(torch.empty(shape, device=device))


class Dense(nn.Module):
    """y = act(x W^T + b); with ``flatten`` the input is (B, -1) first."""

    def __init__(self, units, in_units, activation=None, use_bias=True,
                 flatten=True, device=None):
        super().__init__()
        if activation not in (None, "relu"):
            raise ValueError("Dense supports activation None or 'relu', got "
                             "%r" % (activation,))
        device = resolve_device(device)
        self._flatten = flatten
        self._activation = activation
        self.weight = _param((units, in_units), device)
        self.bias = _param((units,), device) if use_bias else None

    def forward(self, x):
        if self._flatten:
            x = x.reshape(x.shape[0], -1)
        y = F.linear(x, self.weight, self.bias)
        return F.relu(y) if self._activation == "relu" else y


class Embedding(nn.Module):
    """Row lookup in a ``[input_dim, output_dim]`` table (int32 or int64
    indices)."""

    def __init__(self, input_dim, output_dim, device=None):
        super().__init__()
        self.weight = _param((input_dim, output_dim), resolve_device(device))

    def forward(self, x):
        return F.embedding(x, self.weight)


class LayerNorm(nn.Module):
    """Normalise over the last axis with the biased variance, eps 1e-5."""

    def __init__(self, in_channels, device=None):
        super().__init__()
        device = resolve_device(device)
        self.gamma = _param((in_channels,), device)
        self.beta = _param((in_channels,), device)

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.gamma, self.beta,
                            1e-5)


class HybridSequential(nn.Sequential):
    """Children run in order; ``add`` appends, as in Gluon."""

    def add(self, *blocks):
        for block in blocks:
            self.append(block)
