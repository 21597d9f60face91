"""Neural-network ops (the ResNet and LM subset of
``mxnet_tpu/ops/nn_ops.py``): ``FullyConnected`` :47, ``Convolution`` :79,
``Pooling`` :161, ``BatchNorm`` :329, ``LayerNorm`` :354, ``Activation``
:416, ``softmax`` :476, ``log_softmax`` :486, ``SoftmaxOutput`` :512 and
``softmax_cross_entropy`` :633.

The Gluon layers compute through the functions here
(:func:`fully_connected`, :func:`convolution`, :func:`pooling`,
:func:`batch_norm_output` and :func:`batch_stats`, :func:`layer_norm`,
``ACTIVATIONS``), so a layer and its op share one arithmetic.  The
reference's convolution, pooling and batch norm are XLA ops, not Pallas
kernels, so these run PyTorch's (cuDNN's) kernels.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import alias, register

__all__ = ["ACTIVATIONS", "fully_connected", "convolution", "pooling",
           "batch_norm_output", "batch_stats", "layer_norm"]

ACTIVATIONS = {"relu": F.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
               "softrelu": F.softplus, "softsign": F.softsign}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
BN_EPS_DEFAULT = 1e-3   # the reference op's eps (batch_norm-inl.h)


def _pair(v, n):
    if isinstance(v, (list, tuple)):
        t = tuple(int(x) for x in v)
        return t if len(t) == n else t * n
    return (int(v),) * n


def _channel_first(x):
    """(N, *spatial, C) -> (N, C, *spatial), a view."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _channel_last(x):
    """(N, C, *spatial) -> (N, *spatial, C), a view."""
    return x.permute(0, *range(2, x.dim()), 1)


# ---------------------------------------------------------------------------
# FullyConnected

def fully_connected(x, weight, bias=None, flatten=True):
    """y = x W^T + b; with ``flatten`` the input is (B, -1) first."""
    if flatten:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, bias)


@register("FullyConnected")
def _fully_connected(attrs, data, weight, bias=None):
    if attrs.get("no_bias", False):
        bias = None
    return fully_connected(data, weight, bias,
                           bool(attrs.get("flatten", True)))


# ---------------------------------------------------------------------------
# Convolution and Pooling

def convolution(x, weight, bias, stride, pad, dilate, groups,
                channel_last):
    """N-d convolution.  Channel-last data and weights, ``(N, *spatial,
    C)`` and ``(O, *kernel, I)``, are handed to torch as permuted views:
    channel-first in shape, channels-last in memory (the layout cuDNN runs
    natively), and the result is permuted back."""
    if channel_last:
        x, weight = _channel_first(x), _channel_first(weight)
    y = _CONV[x.dim() - 2](x, weight, bias, stride, pad, dilate, groups)
    return _channel_last(y) if channel_last else y


@register("Convolution")
def _convolution(attrs, data, weight, bias=None):
    nd = data.dim() - 2
    layout = attrs.get("layout")
    return convolution(
        data, weight, None if attrs.get("no_bias", False) else bias,
        _pair(attrs.get("stride", 1), nd), _pair(attrs.get("pad", 0), nd),
        _pair(attrs.get("dilate", 1), nd), int(attrs.get("num_group", 1)),
        layout is not None and not layout.startswith("NC"))


def pooling(x, kernel, stride, pad, pool_type, ceil_mode, global_pool,
            count_include_pad, channel_last):
    """2-d max or average pooling, as the JAX ``Pooling`` op computes it.
    ``ceil_mode`` is its 'full' convention: the right edge is padded until
    ceil((x + 2p - k) / s) + 1 windows fit; a max pads with -inf, and an
    average divides by the window clipped to the symmetric padding
    (``count_include_pad``) or to the input.  Global pools reduce the
    spatial axes, keeping them."""
    if channel_last:
        x = _channel_first(x)
    y = _pool2d(x, kernel, stride, pad, pool_type, ceil_mode, global_pool,
                count_include_pad)
    return _channel_last(y) if channel_last else y


def _pool2d(x, k, s, p, pool_type, ceil_mode, global_pool,
            count_include_pad):
    if global_pool:
        return (x.amax(dim=(2, 3), keepdim=True) if pool_type == "max"
                else x.mean(dim=(2, 3), keepdim=True))
    extra = [0, 0]
    if ceil_mode:
        for i in range(2):
            rem = (x.shape[2 + i] + 2 * p[i] - k[i]) % s[i]
            extra[i] = 0 if rem == 0 else s[i] - rem
    if not any(extra) and all(2 * p[i] <= k[i] for i in range(2)):
        # torch's own padding: -inf for a max, counted or not for an
        # average; its divisor is then the whole window or the part inside
        # the input, as the JAX op's
        if pool_type == "max":
            return F.max_pool2d(x, k, s, p)
        return F.avg_pool2d(x, k, s, p, count_include_pad=count_include_pad)
    # pad explicitly: F.pad's order is (W left, W right, H top, H bottom)
    pads = (p[1], p[1] + extra[1], p[0], p[0] + extra[0])
    if pool_type == "max":
        return F.max_pool2d(F.pad(x, pads, value=-math.inf), k, s)
    # the mean of the padded window over the mean of a mask that is 1 where
    # a cell counts: the window's area cancels
    mask = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    if count_include_pad:
        mask = F.pad(mask, (p[1], p[1], p[0], p[0]), value=1.0)
        mask_pads = (0, extra[1], 0, extra[0])
    else:
        mask_pads = pads
    return (F.avg_pool2d(F.pad(x, pads), k, s)
            / F.avg_pool2d(F.pad(mask, mask_pads), k, s))


@register("Pooling")
def _pooling(attrs, data):
    """2-d only; the 'same' convention is 'full' in 2-d (pooling.cc)."""
    if data.dim() != 4:
        raise ValueError("Pooling is ported for 2-d data only, got %d-d"
                         % (data.dim() - 2))
    pool_type = attrs.get("pool_type", "max")
    if pool_type not in ("max", "avg"):
        raise ValueError("Pooling: pool_type %r is not ported" % pool_type)
    layout = attrs.get("layout")
    global_pool = bool(attrs.get("global_pool", False))
    kernel = (1, 1) if global_pool else _pair(attrs["kernel"], 2)
    return pooling(data, kernel, _pair(attrs.get("stride", 1), 2),
                   _pair(attrs.get("pad", 0), 2), pool_type,
                   attrs.get("pooling_convention", "valid") != "valid",
                   global_pool, bool(attrs.get("count_include_pad", True)),
                   layout is not None and not layout.startswith("NC"))


# ---------------------------------------------------------------------------
# Normalization

def batch_norm_output(x, gamma, beta, mean, var, eps):
    """Normalize ``x`` (channels on axis 1) by its batch statistics (mean
    and var None) or by ``mean``/``var``."""
    return F.batch_norm(x, mean, var, gamma, beta, training=mean is None,
                        eps=eps)


def batch_stats(x, dtype, eps):
    """The batch mean of ``x`` (channels on axis 1) and the op's ``invstd =
    1 / sqrt(var + eps)`` of the biased variance, in ``dtype``, without a
    gradient (MXNet's BatchNorm passes none through them).  The variance
    comes from ``torch.var_mean``: torch's batch norm rounds its own invstd
    once, from a float64 quotient, one bit away from the reference's."""
    dims = [d for d in range(x.dim()) if d != 1]
    with torch.no_grad():
        var, mean = (t.to(dtype) for t in
                     torch.var_mean(x, dim=dims, correction=0))
        return mean, torch.sqrt(var + eps).reciprocal_()


@register("BatchNorm", num_outputs=3, visible_outputs=1,
          mode_dependent=True)
def _batch_norm(attrs, data, gamma, beta, moving_mean, moving_var):
    """Returns (out, mean, invstd), invstd = 1/sqrt(var + eps), from the
    batch in training (``_training`` and not ``use_global_stats``), from
    the moving statistics otherwise."""
    axis = int(attrs.get("axis", 1)) % data.dim()
    eps = float(attrs.get("eps", BN_EPS_DEFAULT))
    x = data.movedim(axis, 1)
    if attrs.get("fix_gamma", True):
        gamma = torch.ones_like(gamma)
    if attrs.get("_training", False) and \
            not attrs.get("use_global_stats", False):
        out = batch_norm_output(x, gamma, beta, None, None, eps)
        mean, invstd = batch_stats(x, moving_var.dtype, eps)
    else:
        out = batch_norm_output(x, gamma, beta, moving_mean, moving_var,
                                eps)
        mean, invstd = moving_mean, torch.sqrt(moving_var + eps).reciprocal()
    return out.movedim(1, axis), mean, invstd


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """Normalize over ``axis`` with the biased variance."""
    axis %= x.dim()
    if axis != x.dim() - 1:
        return layer_norm(x.movedim(axis, -1), gamma, beta, -1,
                          eps).movedim(-1, axis)
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)


@register("LayerNorm")
def _layer_norm(attrs, data, gamma, beta):
    return layer_norm(data, gamma, beta, int(attrs.get("axis", -1)),
                      float(attrs.get("eps", 1e-5)))


# ---------------------------------------------------------------------------
# Activations and softmax

@register("Activation")
def _activation(attrs, data):
    act = attrs.get("act_type", "relu")
    if act not in ACTIVATIONS:
        raise ValueError("unknown act_type %s" % act)
    return ACTIVATIONS[act](data)


def _temper(attrs, data):
    temperature = attrs.get("temperature")
    return data / float(temperature) if temperature else data


@register("softmax")
def _softmax(attrs, data):
    return torch.softmax(_temper(attrs, data), dim=int(attrs.get("axis", -1)))


@register("log_softmax")
def _log_softmax(attrs, data):
    return torch.log_softmax(_temper(attrs, data),
                             dim=int(attrs.get("axis", -1)))


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the reference's implicit cross-entropy gradient
    backward (softmax_output-inl.h:150-262), all three branches: a label of
    the output's shape (soft targets), ``multi_output`` (softmax over axis
    1, one label per position) and hard labels over the flattened class
    axis (with ``smooth_alpha``).  The head gradient is ignored unless
    ``out_grad``; ``normalization`` divides by nothing (``null``), the
    batch or the valid labels (``valid``, counted with ``ignore_label``
    whether or not ``use_ignore`` masks them)."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        if attrs.get("multi_output", False):
            out = torch.softmax(data, dim=1)
        elif attrs.get("preserve_shape", False) or data.dim() <= 2:
            out = torch.softmax(data, dim=-1)
        else:
            out = torch.softmax(data.reshape(data.shape[0], -1),
                                dim=-1).reshape(data.shape)
        ctx.save_for_backward(out, label)
        ctx.attrs = attrs
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        a = ctx.attrs
        grad_scale = float(a.get("grad_scale", 1.0))
        ignore = int(float(a.get("ignore_label", -1.0)))
        use_ignore = bool(a.get("use_ignore", False))
        normalization = a.get("normalization", "null")
        use_out_grad = bool(a.get("out_grad", False))
        if label.shape == out.shape:   # soft targets
            grad = (out - label.to(out.dtype)) * grad_scale
            return (grad * g if use_out_grad else grad), None, None
        if a.get("multi_output", False):   # (n, k, s), softmax over k
            n, k = out.shape[0], out.shape[1]
            s = out[0, 0].numel()
            out3 = out.reshape(n, k, s)
            lab = label.reshape(n, s).long()
            grad = out3 - F.one_hot(lab.clamp(0, k - 1), k).transpose(
                1, 2).to(out.dtype) * ((lab >= 0) & (lab < k)).unsqueeze(1)
            keep = lab != ignore
            if use_ignore:
                grad = grad * keep.unsqueeze(1)
            if normalization == "batch":
                grad = grad * (grad_scale / (s * n))
            elif normalization == "valid":
                grad = grad * (grad_scale / keep.sum().clamp(min=1))
            else:
                grad = grad * (grad_scale / s)
            if use_out_grad:
                grad = grad * g.reshape(n, k, s)
            return grad.reshape(out.shape).to(out.dtype), None, None
        out2 = (out.reshape(-1, out.shape[-1])
                if a.get("preserve_shape", False)
                else out.reshape(out.shape[0], -1))
        k = out2.shape[1]
        lab = label.reshape(-1).long()
        target = (lab.unsqueeze(1) == torch.arange(
            k, device=lab.device)).to(out.dtype)
        alpha = float(a.get("smooth_alpha", 0.0))
        if alpha > 0.0:
            target = target * (1.0 - alpha) \
                + (1.0 - target) * (alpha / max(k - 1, 1))
        grad = out2 - target
        keep = lab != ignore
        if use_ignore:
            grad = grad * keep.unsqueeze(1)
        if normalization == "batch":
            grad = grad * (grad_scale / lab.shape[0])
        elif normalization == "valid":
            grad = grad * (grad_scale / keep.sum().clamp(min=1))
        else:
            grad = grad * grad_scale
        if use_out_grad:
            grad = grad * g.reshape(out2.shape)
        return grad.reshape(out.shape).to(out.dtype), None, None


@register("SoftmaxOutput")
def _softmax_output(attrs, data, label):
    """Softmax forward with the reference's implicit cross-entropy
    backward (see :class:`_SoftmaxOutput`)."""
    return _SoftmaxOutput.apply(data, label, attrs)


alias("Softmax", "SoftmaxOutput")


@register("softmax_cross_entropy")
def _softmax_cross_entropy(attrs, data, label):
    """-sum(log softmax(data)[label]) over the batch, shape (1,).  A label
    outside [0, classes) adds nothing, as the JAX op's one-hot does."""
    logp = torch.log_softmax(data, dim=-1)
    idx = label.long()
    valid = (idx >= 0) & (idx < data.shape[-1])
    picked = torch.gather(logp, -1, idx.clamp(0, data.shape[-1] - 1)
                          .unsqueeze(-1)).squeeze(-1)
    return -(picked * valid).sum().reshape(1)
