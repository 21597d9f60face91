"""Basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``).

Only the layers the ported models use: :class:`Dense`, :class:`Embedding`,
:class:`LayerNorm`, :class:`BatchNorm`, :class:`Flatten` and
:class:`HybridSequential`.  Parameters keep the JAX package's names,
shapes, initializers and order (Dense weight ``[units, in_units]``,
LayerNorm and BatchNorm ``gamma``/``beta``, BatchNorm's ``running_mean``/
``running_var``), so weights, names and files carry across unchanged.  A
dimension left 0 (``in_units``, ``in_channels``) is filled from the first
batch by the layer's ``_shape_hook`` (:129, :214, :303, :336), as Gluon
does.  Tensors are made in fp32 on ``device`` (default ``cuda:0``) and
filled by ``initialize`` (or a load); ``cast`` changes their dtype
(``gluon.block.Block``).
"""
from __future__ import annotations

import math

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


class Dense(Block):
    """y = act(x W^T + b); with ``flatten`` the input is (B, -1) first."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        if activation not in (None, "relu"):
            raise ValueError("Dense supports activation None or 'relu', got "
                             "%r" % (activation,))
        self._device = resolve_device(device)
        self._flatten = flatten
        self._units = units
        self._activation = activation
        with self.name_scope():
            self.weight = self.params.get("weight", shape=(units, in_units),
                                          init=weight_initializer,
                                          dtype=dtype,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(units,),
                                            init=bias_initializer,
                                            dtype=dtype,
                                            allow_deferred_init=True)
            else:
                self.bias = None

    def _shape_hook(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self._reg_params["weight"].shape = (self._units, in_units)

    def forward(self, x):
        y = fully_connected(x, self.weight, self.bias, self._flatten)
        return F.relu(y) if self._activation == "relu" else y


class Embedding(Block):
    """Row lookup in a ``[input_dim, output_dim]`` table (int32 or int64
    indices)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, prefix=None, params=None,
                 device=None):
        super().__init__(prefix=prefix, params=params)
        self._device = resolve_device(device)
        with self.name_scope():
            self.weight = self.params.get("weight",
                                          shape=(input_dim, output_dim),
                                          init=weight_initializer,
                                          dtype=dtype,
                                          allow_deferred_init=True)

    def forward(self, x):
        return F.embedding(x, self.weight)


class LayerNorm(Block):
    """Normalise over the last axis with the biased variance, eps 1e-5."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        if axis != -1 or epsilon != 1e-5 or not (center and scale):
            raise ValueError("LayerNorm is ported for axis=-1, epsilon=1e-5, "
                             "center and scale only")
        self._device = resolve_device(device)
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=gamma_initializer,
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=beta_initializer,
                                        allow_deferred_init=True)

    def _shape_hook(self, x, *args):
        for name in ("gamma", "beta"):
            self._reg_params[name].shape = (x.shape[-1],)

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
    batch's dtype.  That round trip keeps a variance far below ``eps``
    only to multiples of ``eps``'s last bit.  Torch's batch norm rounds its
    own ``invstd`` once, from a float64 quotient, one bit away from the
    reference's on a constant channel, where the fold then flips sign; so
    the layer takes the biased variance from ``torch.var_mean`` and runs the
    reference's arithmetic on it.  A bf16 batch with fp32 running
    statistics (fp32 aux beside bf16 weights, as bench.py's step runs it)
    is normalized in bf16 and folded as the JAX arrays promote: the batch
    terms round to bf16 times ``1 - momentum``, then add in fp32 (the JAX
    layer's eager arithmetic; under ``jax.jit``, as bench.py runs it, XLA
    keeps those terms in fp32).

    ``scale=False`` normalizes with a gamma of ones (the op's
    ``fix_gamma``); gamma, and beta with ``center=False``, then stay in the
    parameter list without a gradient (``grad_req='null'``).  The running
    statistics are buffers (Gluon's aux parameters, ``grad_req='null'``),
    which a ``Trainer`` skips.

    ``cast`` follows the JAX layer (``basic_layers.py:219-222``): under
    ``float16`` the layer stays fp32; under ``bfloat16`` gamma, beta and
    both running statistics become bf16, and the statistics are folded in
    bf16."""

    def __init__(self, axis=None, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        if axis is None:
            from .conv_layers import default_batchnorm_axis
            axis = default_batchnorm_axis()
        self._device = resolve_device(device)
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._fix_gamma = not scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def _shape_hook(self, x, *args):
        ch = x.shape[self._axis]
        for name in ("gamma", "beta", "running_mean", "running_var"):
            self._reg_params[name].shape = (ch,)

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
            mean, invstd = batch_stats(x, x.dtype, self._eps)
            m = self._momentum
            with torch.no_grad():
                var = invstd.square_().reciprocal_().sub_(self._eps)
                stats = [self.running_mean, self.running_var]
                torch._foreach_mul_(stats, m)
                if mean.dtype == self.running_mean.dtype:
                    torch._foreach_add_(stats, [mean, var], alpha=1 - m)
                else:
                    torch._foreach_add_(stats,
                                        torch._foreach_mul([mean, var],
                                                           1 - m))
        else:
            y = batch_norm_output(x, gamma, self.beta, self.running_mean,
                                  self.running_var, self._eps)
        return y.movedim(1, axis)


class Flatten(Block):
    """(B, ...) -> (B, -1)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class HybridSequential(Block, nn.Sequential):
    """Children run in order; ``add`` appends, as in Gluon (children given
    to the constructor are added first)."""

    def __init__(self, *blocks, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.add(*blocks)

    def add(self, *blocks):
        for block in blocks:
            self.append(block)
