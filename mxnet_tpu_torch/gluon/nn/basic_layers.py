"""Basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``).

:class:`Dense`, :class:`Dropout`, :class:`Embedding`, :class:`LayerNorm`,
:class:`BatchNorm`, :class:`InstanceNorm`, :class:`Flatten`,
:class:`Sequential`, :class:`HybridSequential`, :class:`Lambda` and
:class:`HybridLambda`.  Parameters keep the JAX package's names,
shapes, initializers and order (Dense weight ``[units, in_units]``,
LayerNorm and BatchNorm ``gamma``/``beta``, BatchNorm's ``running_mean``/
``running_var``), so weights, names and files carry across unchanged.  A
dimension left 0 (``in_units``, ``in_channels``) is filled from the first
batch by the layer's ``_shape_hook`` (:129, :214, :303, :336), as Gluon
does.  Tensors are made in fp32 on ``device`` (default ``cuda:0``) and
filled by ``initialize`` (or a load); ``cast`` changes their dtype
(``gluon.block.Block``).

Each layer computes in torch (``forward``) and traces into ``sym.*``
(``hybrid_forward(F, ...)``, for ``export``), writing the nodes,
attributes and names the JAX layer writes.
"""
from __future__ import annotations

import math
import warnings

import torch
from torch import nn

from ... import autograd
from ...base import as_dtype
from ...context import resolve_device
from ...ops.nn_ops import (batch_norm_output, batch_stats, fully_connected,
                           layer_norm)
from ...ops.tensor_ops import embedding
from ... import random as _random
from ...ndarray.ndarray import NDArray
from ...ops.nn_ops import dropout, instance_norm
from ..block import Block, HybridBlock
from .activations import Activation

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm", "BatchNorm",
           "InstanceNorm", "Flatten", "Sequential", "HybridSequential",
           "Lambda", "HybridLambda"]


class Dense(HybridBlock):
    """y = act(x W^T + b); with ``flatten`` the input is (B, -1) first.
    ``activation`` is any ``Activation``'s, a child block named
    ``<prefix><activation>_``, as in the JAX layer."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._device = resolve_device(device)
        self._flatten = flatten
        self._units = units
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
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _shape_hook(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self._reg_params["weight"].shape = (self._units, in_units)

    def forward(self, x):
        y = fully_connected(x, self.weight, self.bias, self._flatten)
        return y if self.act is None else self.act(y)

    def hybrid_forward(self, F, x, weight, bias=None):
        act = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten,
                               name="fwd")
        return act if self.act is None else self.act(act)


class Embedding(HybridBlock):
    """Row lookup in a ``[input_dim, output_dim]`` table; indices of any
    dtype, floats too, as the op ``Embedding`` takes them."""

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
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}

    def forward(self, x):
        return embedding(x, self.weight)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, name="fwd", **self._kwargs)


class LayerNorm(HybridBlock):
    """Normalise over ``axis`` with the biased variance plus ``epsilon``.
    ``scale=False`` (``center=False``) leaves gamma (beta) at its
    initializer, without a gradient, as in the JAX layer."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._device = resolve_device(device)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def _shape_hook(self, x, *args):
        for name in ("gamma", "beta"):
            self._reg_params[name].shape = (x.shape[self._axis],)

    def forward(self, x):
        return layer_norm(x, self.gamma, self.beta, self._axis,
                          self._epsilon)

    def hybrid_forward(self, F, data, gamma, beta):
        return F.LayerNorm(data, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class Dropout(HybridBlock):
    """Zero each element (or, with ``axes``, each slice along them) with
    probability ``rate`` in training, scaling the rest by ``1/(1-rate)``
    (:150-162).  Every call draws a key (``random.next_key()``), in
    prediction too, as the JAX layer's op does; so the masks, and the keys
    after them, are the JAX package's for one ``mx.random.seed``."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        key = _random.next_key()
        if not autograd.is_training() or self._rate <= 0:
            return x
        return dropout(x, self._rate, key, self._axes)

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes, name="fwd")

    def extra_repr(self):
        return "p = %s, axes=%s" % (self._rate, self._axes)


class BatchNorm(HybridBlock):
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

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        # the op's mean and invstd outputs stay out of the graph's result;
        # the running statistics are the graph's aux states
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", axis=self._axis, eps=self._eps,
                           momentum=self._momentum,
                           fix_gamma=self._fix_gamma,
                           use_global_stats=self._use_global_stats)[0]


class InstanceNorm(HybridBlock):
    """Normalize each sample's channels over their spatial axes (the
    ``InstanceNorm`` op), then ``gamma`` and ``beta`` per channel
    (:282-315).  ``scale=False`` (the default) leaves gamma at its
    initializer without a gradient, ``center=False`` beta.  The
    statistics are over the axes after 1 whatever ``axis`` is, as in the
    JAX layer, whose NDArrays have no ``swapaxes``: ``axis`` only sizes
    gamma and beta."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._device = resolve_device(device)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def _shape_hook(self, x, *args):
        for name in ("gamma", "beta"):
            self._reg_params[name].shape = (x.shape[self._axis],)

    def forward(self, x):
        return instance_norm(x, self.gamma, self.beta, self._epsilon)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis != 1 and hasattr(x, "swapaxes"):
            x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta, name="fwd", eps=self._epsilon)


class Flatten(HybridBlock):
    """(B, ...) -> (B, -1)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class Sequential(Block, nn.Sequential):
    """A stack of blocks run in order, not hybridizable as a whole
    (:12-52): ``add`` appends, ``net[i]`` is a child and ``net[i:j]`` a new
    Sequential of those children under this one's prefix."""

    def __init__(self, *blocks, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.add(*blocks)

    def add(self, *blocks):
        for block in blocks:
            self.append(block)

    forward = nn.Sequential.forward

    def __getitem__(self, key):
        layers = list(self._modules.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def hybridize(self, active=True, **kwargs):
        if self._modules and all(isinstance(c, HybridBlock)
                                 for c in self._modules.values()):
            warnings.warn("All children of this Sequential layer '%s' are "
                          "HybridBlocks. Consider using HybridSequential for "
                          "the best performance." % self.prefix, stacklevel=2)
        super().hybridize(active, **kwargs)


class HybridSequential(HybridBlock, nn.Sequential):
    """Children run in order; ``add`` appends, as in Gluon (children given
    to the constructor are added first)."""

    def __init__(self, *blocks, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.add(*blocks)

    def add(self, *blocks):
        for block in blocks:
            self.append(block)

    forward = nn.Sequential.forward

    def _build_symbol(self, *inputs):
        # no name scope of its own, as in the JAX block: each child traces
        # in its own
        x = inputs[0]
        for block in self._modules.values():
            x = block._build_symbol(x)
        return x


def _nd_call(fn, args):
    """``fn`` over NDArray views of tensor ``args``; the result's tensors."""
    out = fn(*[NDArray(a) if isinstance(a, torch.Tensor) else a
               for a in args])
    if isinstance(out, (list, tuple)):
        return type(out)(o._data if isinstance(o, NDArray) else o
                         for o in out)
    return out._data if isinstance(out, NDArray) else out


class Lambda(Block):
    """A block of a function (:345-364): the name of an ``nd`` function, or
    a callable, called on the block's arguments as NDArrays."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd_mod
            if not hasattr(nd_mod, function):
                raise AssertionError("Function name %s is not found in "
                                     "ndarray." % function)
            self._func_impl = getattr(nd_mod, function)
        elif callable(function):
            self._func_impl = function
        else:
            raise ValueError("Unrecognized function in lambda: %r"
                             % (function,))
        self._func_name = getattr(self._func_impl, "__name__", "custom")

    def forward(self, *args):
        return _nd_call(self._func_impl, args)

    def extra_repr(self):
        return self._func_name


class HybridLambda(HybridBlock):
    """A hybridizable block of a function (:367-389): the name of a
    function that both ``nd`` and ``sym`` have, or a callable
    ``function(F, x, *args)``; eagerly ``F`` is the registered ops over
    tensors, traced it is ``sym``."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd_mod
            from ... import symbol as sym_mod
            if not (hasattr(nd_mod, function)
                    and hasattr(sym_mod, function)):
                raise AssertionError("Function name %s is not found in "
                                     "ndarray/symbol." % function)
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        elif callable(function):
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")
        else:
            raise ValueError("Unrecognized function in lambda: %r"
                             % (function,))

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def extra_repr(self):
        return self._func_name
