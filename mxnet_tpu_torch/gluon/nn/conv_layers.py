"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``: ``channels_last``,
``_resolve_layout`` and ``default_batchnorm_axis``, :23-59; ``_pair``, :62;
``_Conv`` and ``Conv1D/2D/3D``, :71-204; ``_Pooling`` and the 2-D pools,
:255-360).

Layouts are the JAX package's: channel-first (``NCW``/``NCHW``/``NCDHW``)
unless ``layout=`` names a channel-last one (``NWC``/``NHWC``/``NDHWC``) or
the layer is built inside :func:`channels_last`.  Weights keep its shapes,
``(O, I/groups, *kernel)`` channel-first and ``(O, *kernel, I/groups)``
channel-last, so they carry across unchanged.  A channel-last layer hands
torch permuted views of its input and weight: channel-first in shape and
channels-last in memory (``torch.channels_last``, the layout cuDNN runs
natively), so nothing is copied, and it permutes the result back.

``in_channels=0`` (the default) leaves the weight's input dimension to the
first batch (``_shape_hook``, :130-140), as Gluon does; a channel-last
weight's is its last.  Transposed convolutions, the 1-D and 3-D pools and
``ReflectionPad2D`` are not ported yet.
"""
from __future__ import annotations

import contextvars
from contextlib import contextmanager

from ...context import resolve_device
from ...ops.nn_ops import _channel_first, convolution, pooling  # noqa: F401
from ..block import Block
from .activations import Activation

__all__ = ["channels_last", "Conv1D", "Conv2D", "Conv3D", "MaxPool2D",
           "AvgPool2D", "GlobalMaxPool2D", "GlobalAvgPool2D"]

# the layout layers built inside channels_last() default to
_channels_last_scope = contextvars.ContextVar("mxnet_tpu_torch_channels_last",
                                              default=False)

_CHANNEL_FIRST = {1: "NCW", 2: "NCHW", 3: "NCDHW"}
_CHANNEL_LAST = {1: "NWC", 2: "NHWC", 3: "NDHWC"}


@contextmanager
def channels_last(active=True):
    """Scope under which conv and pool layers default to channel-last
    layouts and BatchNorm to ``axis=-1``; explicit ``layout=``/``axis=``
    arguments win."""
    token = _channels_last_scope.set(bool(active))
    try:
        yield
    finally:
        _channels_last_scope.reset(token)


def _resolve_layout(layout, rank):
    if layout is not None:
        return layout
    return (_CHANNEL_LAST if _channels_last_scope.get()
            else _CHANNEL_FIRST)[rank]


def default_batchnorm_axis():
    """1, or -1 inside a :func:`channels_last` scope."""
    return -1 if _channels_last_scope.get() else 1


def _pair(v, n):
    """An int or a sequence of n ints as an n-tuple of ints."""
    if isinstance(v, (list, tuple)):
        if len(v) != n:
            raise ValueError("expected %d-tuple, got %r" % (n, v))
        return tuple(int(x) for x in v)
    return (int(v),) * n


class _Conv(Block):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels, activation, use_bias,
                 weight_initializer, bias_initializer, prefix, params,
                 device):
        super().__init__(prefix=prefix, params=params)
        nd = len(kernel_size)
        if in_channels % groups or channels % groups:
            raise ValueError("in_channels %d and channels %d must be "
                             "multiples of groups %d"
                             % (in_channels, channels, groups))
        self._device = resolve_device(device)
        with self.name_scope():
            self._channels = channels
            self._kernel = tuple(kernel_size)
            self._strides = _pair(strides, nd)
            self._padding = _pair(padding, nd)
            self._dilation = _pair(dilation, nd)
            self._groups = groups
            self._layout = _resolve_layout(layout, nd)
            self._channel_last = not self._layout.startswith("NC")
            per_group = in_channels // groups
            if self._channel_last:
                wshape = (channels,) + self._kernel + (per_group,)
                # stored = canonical (O, I, *kernel) permuted: initializers
                # draw in canonical order
                init_perm = (0,) + tuple(range(2, 2 + nd)) + (1,)
            else:
                wshape = (channels, per_group) + self._kernel
                init_perm = None
            self.weight = self.params.get("weight", shape=wshape,
                                          init=weight_initializer,
                                          allow_deferred_init=True,
                                          init_perm=init_perm)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer,
                                            allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _shape_hook(self, x, *args):
        per_group = x.shape[-1 if self._channel_last else 1] // self._groups
        self._reg_params["weight"].shape = (
            (self._channels,) + self._kernel + (per_group,)
            if self._channel_last
            else (self._channels, per_group) + self._kernel)

    def forward(self, x):
        y = convolution(x, self.weight, self.bias, self._strides,
                        self._padding, self._dilation, self._groups,
                        self._channel_last)
        return y if self.act is None else self.act(y)


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout=None, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None, device=None):
        super().__init__(channels, _pair(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         prefix, params, device)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout=None, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None, device=None):
        super().__init__(channels, _pair(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         prefix, params, device)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout=None, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, prefix=None, params=None, device=None):
        super().__init__(channels, _pair(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         prefix, params, device)


class _Pooling(Block):
    """2-D max or average pooling (``ops.nn_ops.pooling``, the JAX
    ``Pooling`` op, ``mxnet_tpu/ops/nn_ops.py:161``).  ``ceil_mode`` is its
    'full' convention.  Global pools reduce the spatial axes, keeping
    them."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=True, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._layout = _resolve_layout(layout, 2)
        self._channel_last = not self._layout.startswith("NC")
        self._kernel = _pair(pool_size, 2)
        self._strides = self._kernel if strides is None \
            else _pair(strides, 2)
        self._padding = _pair(padding, 2)
        self._ceil_mode = ceil_mode
        self._global = global_pool
        self._type = pool_type
        self._count_include_pad = count_include_pad

    def _alias(self):
        return "pool"

    def forward(self, x):
        return pooling(x, self._kernel, self._strides, self._padding,
                       self._type, self._ceil_mode, self._global,
                       self._count_include_pad, self._channel_last)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", layout, count_include_pad, **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout=None, **kwargs):
        super().__init__((1, 1), None, 0, True, True, "max", layout,
                         **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout=None, **kwargs):
        super().__init__((1, 1), None, 0, True, True, "avg", layout,
                         **kwargs)
