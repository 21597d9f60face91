"""Basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``).

Only the layers the ported models use: :class:`Dense`, :class:`Embedding`,
:class:`LayerNorm`, :class:`BatchNorm`, :class:`Flatten` and
:class:`HybridSequential`.  Parameters keep the JAX package's shapes and
names (Dense weight ``[units, in_units]``, LayerNorm and BatchNorm
``gamma``/``beta``, BatchNorm's ``running_mean``/``running_var``), so
weights carry across unchanged.  Parameters are allocated uninitialized in
fp32 on ``device`` (default ``cuda:0``) and take gradients; fill them with
``initializer.initialize`` or ``convert.load_mxnet_params``, and change
their dtype with ``cast`` (``gluon.block.Block``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ... import autograd
from ...base import as_dtype
from ...context import resolve_device
from ...ops.nn_ops import (batch_norm_output, batch_stats, fully_connected,
                           layer_norm)
from ..block import Block

__all__ = ["Dense", "Embedding", "LayerNorm", "BatchNorm", "Flatten",
           "HybridSequential"]


def _param(shape, device):
    # trainable, as Gluon's grad_req='write'; freeze with
    # requires_grad_(False) (grad_req='null')
    return nn.Parameter(torch.empty(shape, device=device))


class Dense(Block):
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
        y = fully_connected(x, self.weight, self.bias, self._flatten)
        return F.relu(y) if self._activation == "relu" else y


class Embedding(Block):
    """Row lookup in a ``[input_dim, output_dim]`` table (int32 or int64
    indices)."""

    def __init__(self, input_dim, output_dim, device=None):
        super().__init__()
        self.weight = _param((input_dim, output_dim), resolve_device(device))

    def forward(self, x):
        return F.embedding(x, self.weight)


class LayerNorm(Block):
    """Normalise over the last axis with the biased variance, eps 1e-5."""

    def __init__(self, in_channels, device=None):
        super().__init__()
        device = resolve_device(device)
        self.gamma = _param((in_channels,), device)
        self.beta = _param((in_channels,), device)

    def forward(self, x):
        return layer_norm(x, self.gamma, self.beta)


class BatchNorm(Block):
    """Batch normalization over ``axis`` (1, or -1 inside
    ``nn.channels_last()``), as the JAX layer (``basic_layers.py:164-248``)
    and op (``mxnet_tpu/ops/nn_ops.py:304-350``) compute it.

    Batch statistics are used while ``autograd.is_training()`` and not
    ``use_global_stats`` (``nn.Module.training`` plays no part); the running
    statistics otherwise.  With batch statistics the running ones are folded
    as ``running * momentum + batch * (1 - momentum)``: not torch's own
    update, whose variance is unbiased and whose momentum is
    ``1 - momentum``.  The batch variance is the reference's: its op hands
    out ``invstd = 1 / sqrt(var + eps)`` of the biased variance, and its
    layer folds ``1 / invstd**2 - eps`` (``bn_invstd_to_var``), all in the
    running statistics' dtype.  That round trip keeps a variance far below
    ``eps`` only to multiples of ``eps``'s last bit.  Torch's batch norm
    rounds its own ``invstd`` once, from a float64 quotient, one bit away
    from the reference's on a constant channel, where the fold then flips
    sign; so the layer takes the biased variance from ``torch.var_mean`` and
    runs the reference's arithmetic on it.

    ``scale=False`` normalizes with a gamma of ones (the op's
    ``fix_gamma``); gamma, and beta with ``center=False``, then stay in the
    parameter list without a gradient (``grad_req='null'``).  The running
    statistics are buffers, which a ``Trainer`` built from
    ``named_parameters()`` never sees.

    ``cast`` follows the JAX layer (``basic_layers.py:219-222``): under
    ``float16`` the layer stays fp32; under ``bfloat16`` gamma, beta and
    both running statistics become bf16, and the statistics are folded in
    bf16."""

    def __init__(self, axis=None, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0,
                 device=None):
        super().__init__()
        if not in_channels:
            raise ValueError("in_channels must be given: the port does not "
                             "infer shapes from the first batch")
        if axis is None:
            from .conv_layers import default_batchnorm_axis
            axis = default_batchnorm_axis()
        device = resolve_device(device)
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._fix_gamma = not scale
        self._use_global_stats = use_global_stats
        self.gamma = _param((in_channels,), device)
        self.gamma.requires_grad_(scale)
        self.beta = _param((in_channels,), device)
        self.beta.requires_grad_(center)
        self.register_buffer("running_mean",
                             torch.zeros(in_channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(in_channels, device=device))

    def cast(self, dtype):
        if as_dtype(dtype) == torch.float16:
            dtype = torch.float32
        return super().cast(dtype)

    def forward(self, x):
        axis = self._axis % x.dim()
        x = x.movedim(axis, 1)   # a view; channels-last memory stays so
        gamma = torch.ones_like(self.gamma) if self._fix_gamma \
            else self.gamma
        if autograd.is_training() and not self._use_global_stats:
            y = batch_norm_output(x, gamma, self.beta, None, None, self._eps)
            # the op's mean and invstd, then the layer's variance from it
            # (bn_invstd_to_var); in place and multi-tensor, since the host
            # launches every one of these for every layer
            mean, invstd = batch_stats(x, self.running_var.dtype, self._eps)
            with torch.no_grad():
                var = invstd.square_().reciprocal_().sub_(self._eps)
                stats = [self.running_mean, self.running_var]
                torch._foreach_mul_(stats, self._momentum)
                torch._foreach_add_(stats, [mean, var],
                                    alpha=1 - self._momentum)
        else:
            y = batch_norm_output(x, gamma, self.beta, self.running_mean,
                                  self.running_var, self._eps)
        return y.movedim(1, axis)


class Flatten(Block):
    """(B, ...) -> (B, -1)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class HybridSequential(Block, nn.Sequential):
    """Children run in order; ``add`` appends, as in Gluon."""

    def add(self, *blocks):
        for block in blocks:
            self.append(block)
