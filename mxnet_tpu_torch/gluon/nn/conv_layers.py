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

Gluon infers ``in_channels`` from the first batch; here it is an explicit
argument, as ``Dense``'s ``in_units`` is.  Transposed convolutions, the
1-D and 3-D pools and ``ReflectionPad2D`` are not ported yet.
"""
from __future__ import annotations

import contextvars
import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from ...context import resolve_device
from ..block import Block
from .activations import Activation
from .basic_layers import _param

__all__ = ["channels_last", "Conv1D", "Conv2D", "Conv3D", "MaxPool2D",
           "AvgPool2D", "GlobalMaxPool2D", "GlobalAvgPool2D"]

# the layout layers built inside channels_last() default to
_channels_last_scope = contextvars.ContextVar("mxnet_tpu_torch_channels_last",
                                              default=False)

_CHANNEL_FIRST = {1: "NCW", 2: "NCHW", 3: "NCDHW"}
_CHANNEL_LAST = {1: "NWC", 2: "NHWC", 3: "NDHWC"}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


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


def _channel_first(x):
    """(N, *spatial, C) -> (N, C, *spatial), a view."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _channel_last(x):
    """(N, C, *spatial) -> (N, *spatial, C), a view."""
    return x.permute(0, *range(2, x.dim()), 1)


class _Conv(Block):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels, activation, use_bias, device):
        super().__init__()
        nd = len(kernel_size)
        if not in_channels:
            raise ValueError("in_channels must be given: the port does not "
                             "infer shapes from the first batch")
        if in_channels % groups or channels % groups:
            raise ValueError("in_channels %d and channels %d must be "
                             "multiples of groups %d"
                             % (in_channels, channels, groups))
        device = resolve_device(device)
        self._kernel = tuple(kernel_size)
        self._strides = _pair(strides, nd)
        self._padding = _pair(padding, nd)
        self._dilation = _pair(dilation, nd)
        self._groups = groups
        self._layout = _resolve_layout(layout, nd)
        self._channel_last = not self._layout.startswith("NC")
        per_group = in_channels // groups
        if self._channel_last:
            self.weight = _param((channels,) + self._kernel + (per_group,),
                                 device)
            # stored = canonical (O, I, *kernel) permuted: initializers
            # draw in canonical order (the JAX Parameter's init_perm)
            self.weight.init_perm = (0,) + tuple(range(2, 2 + nd)) + (1,)
        else:
            self.weight = _param((channels, per_group) + self._kernel,
                                 device)
        self.bias = _param((channels,), device) if use_bias else None
        self.act = Activation(activation) if activation is not None else None

    def forward(self, x):
        weight = self.weight
        if self._channel_last:
            x, weight = _channel_first(x), _channel_first(weight)
        y = _CONV[len(self._kernel)](x, weight, self.bias, self._strides,
                                     self._padding, self._dilation,
                                     self._groups)
        if self._channel_last:
            y = _channel_last(y)
        return y if self.act is None else self.act(y)


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout=None, activation=None,
                 use_bias=True, in_channels=0, device=None):
        super().__init__(channels, _pair(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, device)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout=None, activation=None,
                 use_bias=True, in_channels=0, device=None):
        super().__init__(channels, _pair(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, device)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout=None, activation=None, use_bias=True, in_channels=0,
                 device=None):
        super().__init__(channels, _pair(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, device)


class _Pooling(Block):
    """2-D max or average pooling, as the JAX ``Pooling`` op computes it
    (``mxnet_tpu/ops/nn_ops.py:161``).  ``ceil_mode`` is its 'full'
    convention: the right edge is padded until ceil((x + 2p - k) / s) + 1
    windows fit; a max pads with -inf, and an average divides by the
    window clipped to the symmetric padding (``count_include_pad``) or to
    the input.  Global pools reduce the spatial axes, keeping them."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=True):
        super().__init__()
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

    def forward(self, x):
        if self._channel_last:
            x = _channel_first(x)
        y = self._pool(x)
        return _channel_last(y) if self._channel_last else y

    def _pool(self, x):
        if self._global:
            return (x.amax(dim=(2, 3), keepdim=True) if self._type == "max"
                    else x.mean(dim=(2, 3), keepdim=True))
        k, s, p = self._kernel, self._strides, self._padding
        extra = [0, 0]
        if self._ceil_mode:
            for i in range(2):
                rem = (x.shape[2 + i] + 2 * p[i] - k[i]) % s[i]
                extra[i] = 0 if rem == 0 else s[i] - rem
        if not any(extra) and all(2 * p[i] <= k[i] for i in range(2)):
            # torch's own padding: -inf for a max, counted or not for an
            # average; its divisor is then the whole window or the part
            # inside the input, as the JAX op's
            if self._type == "max":
                return F.max_pool2d(x, k, s, p)
            return F.avg_pool2d(x, k, s, p,
                                count_include_pad=self._count_include_pad)
        # pad explicitly: F.pad's order is (W left, W right, H top,
        # H bottom)
        pads = (p[1], p[1] + extra[1], p[0], p[0] + extra[0])
        if self._type == "max":
            return F.max_pool2d(F.pad(x, pads, value=-math.inf), k, s)
        # the mean of the padded window over the mean of a mask that is 1
        # where a cell counts: the window's area cancels
        mask = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        if self._count_include_pad:
            mask = F.pad(mask, (p[1], p[1], p[0], p[0]), value=1.0)
            mask_pads = (0, extra[1], 0, extra[0])
        else:
            mask_pads = pads
        return (F.avg_pool2d(F.pad(x, pads), k, s)
                / F.avg_pool2d(F.pad(mask, mask_pads), k, s))


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", layout, count_include_pad)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout=None):
        super().__init__((1, 1), None, 0, True, True, "max", layout)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout=None):
        super().__init__((1, 1), None, 0, True, True, "avg", layout)
