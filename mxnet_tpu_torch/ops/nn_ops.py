"""Neural-network ops (counterpart of ``mxnet_tpu/ops/nn_ops.py``):
``FullyConnected`` :47, ``Convolution`` :79, ``Deconvolution`` :110,
``Pooling`` :161, ``UpSampling`` :257, ``BatchNorm`` :329, ``LayerNorm``
:354, ``InstanceNorm`` :367, ``L2Normalization`` :379, ``LRN`` :396,
``Activation`` :416, ``LeakyReLU`` :441, ``softmax`` :476,
``log_softmax`` :486, ``softmin`` :496, ``SoftmaxActivation`` :503,
``SoftmaxOutput`` :512, ``softmax_cross_entropy`` :633, the regression
outputs :642-704, ``Dropout`` :711, ``SequenceMask``/``Last``/``Reverse``
:735-785, ``RNN`` :786-900, ``Correlation`` :907, ``CTCLoss`` :966,
``GridGenerator`` :1111, ``BilinearSampler`` :1137,
``SpatialTransformer`` :1171 and ``IdentityAttachKLSparseReg`` :1179.
``_contrib_SyncBatchNorm`` is not ported yet.

The Gluon layers compute through the functions here
(:func:`fully_connected`, :func:`convolution`, :func:`deconvolution`,
:func:`pooling`, :func:`batch_norm_output` and :func:`batch_stats`,
:func:`layer_norm`, ``ACTIVATIONS``), so a layer and its op share one
arithmetic.  The
reference's convolution, pooling and batch norm are XLA ops, not Pallas
kernels, so these run PyTorch's (cuDNN's) kernels.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import alias, register
from .tensor_ops import _index

__all__ = ["ACTIVATIONS", "fully_connected", "convolution",
           "deconvolution", "pooling",
           "batch_norm_output", "batch_stats", "layer_norm", "dropout",
           "instance_norm", "rnn", "RNN_GATES"]

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


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def deconvolution(x, weight, bias, stride, pad, adj, dilate, groups):
    """N-d transposed convolution of channel-first data, MXNet's
    ``Deconvolution``: the weight is ``(in, out/groups, *kernel)``, the
    output ``(i-1)*s + (k-1)*d + 1 - 2p + adj`` long, ``adj`` added on the
    trailing side (torch's ``output_padding``, which must stay below the
    stride or the dilation)."""
    return _CONV_T[x.dim() - 2](x, weight, bias, stride, pad, adj, groups,
                                dilate)


@register("Deconvolution")
def _deconvolution(attrs, data, weight, bias=None):
    """Transposed convolution (``nn_ops.py:110``); channel-first layouts
    only, as in the JAX op."""
    nd = data.dim() - 2
    layout = attrs.get("layout")
    if layout is not None and not layout.startswith("NC"):
        raise ValueError("Deconvolution supports channel-first layouts "
                         "only; got layout=%r" % (layout,))
    return deconvolution(
        data, weight, None if attrs.get("no_bias", True) else bias,
        _pair(attrs.get("stride", 1), nd), _pair(attrs.get("pad", 0), nd),
        _pair(attrs.get("adj", 0), nd), _pair(attrs.get("dilate", 1), nd),
        int(attrs.get("num_group", 1)))


def pooling(x, kernel, stride, pad, pool_type, ceil_mode, global_pool,
            count_include_pad, channel_last, convention=None):
    """1-, 2- or 3-d max, average or sum pooling, as the JAX ``Pooling``
    op computes it.  ``ceil_mode`` is its 'full' convention: the right
    edge is padded until ceil((x + 2p - k) / s) + 1 windows fit
    (``convention='same'`` on 1-d data: ceil((x + 2p) / s) windows); a max
    pads with -inf, and an average divides by the window clipped to the
    symmetric padding (``count_include_pad``) or to the input.  Global
    pools reduce the spatial axes, keeping them."""
    if channel_last:
        x = _channel_first(x)
    y = _pool(x, kernel, stride, pad, pool_type, ceil_mode, global_pool,
              count_include_pad, convention)
    return _channel_last(y) if channel_last else y


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _avg_pool(x, k, s, p, count_include_pad=True, divisor_override=None):
    """torch's average pool of 2-d or 3-d data, 1-d as 2-d over a unit
    axis (``avg_pool1d`` takes no ``divisor_override``)."""
    if x.dim() == 3:
        return _avg_pool(x.unsqueeze(-2), (1,) + k, (1,) + s, (0,) + p,
                         count_include_pad, divisor_override).squeeze(-2)
    fn = F.avg_pool2d if x.dim() == 4 else F.avg_pool3d
    return fn(x, k, s, p, count_include_pad=count_include_pad,
              divisor_override=divisor_override)


def _torch_pads(before, after):
    """Per-axis (before, after) padding in ``F.pad``'s order: from the
    last axis back."""
    return sum(((b, a) for b, a in zip(reversed(before), reversed(after))),
               ())


def _pool(x, k, s, p, pool_type, ceil_mode, global_pool, count_include_pad,
          convention):
    nd = x.dim() - 2
    spatial = tuple(range(2, x.dim()))
    if global_pool:
        if pool_type == "max":
            return x.amax(dim=spatial, keepdim=True)
        if pool_type == "sum":
            return x.sum(dim=spatial, keepdim=True)
        return x.mean(dim=spatial, keepdim=True)
    extra = [0] * nd
    for i in range(nd):
        size = x.shape[2 + i] + 2 * p[i]
        if convention == "same" and nd == 1:
            n_win = -(-size // s[i])
            extra[i] = max((n_win - 1) * s[i] + k[i] - size, 0)
        elif ceil_mode:
            rem = (size - k[i]) % s[i]
            extra[i] = 0 if rem == 0 else s[i] - rem
    if not any(extra) and all(2 * p[i] <= k[i] for i in range(nd)):
        # torch's own padding: -inf for a max, counted or not for an
        # average; its divisor is then the whole window or the part inside
        # the input, as the JAX op's
        if pool_type == "max":
            return _MAX_POOL[nd](x, k, s, p)
        if pool_type == "sum":
            return _avg_pool(x, k, s, p, divisor_override=1)
        return _avg_pool(x, k, s, p, count_include_pad)
    # pad explicitly
    zero = (0,) * nd
    pads = _torch_pads(p, [a + b for a, b in zip(p, extra)])
    if pool_type == "max":
        return _MAX_POOL[nd](F.pad(x, pads, value=-math.inf), k, s)
    if pool_type == "sum":
        return _avg_pool(F.pad(x, pads), k, s, zero, divisor_override=1)
    # the mean of the padded window over the mean of a mask that is 1 where
    # a cell counts: the window's area cancels
    mask = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    if count_include_pad:
        mask = F.pad(mask, _torch_pads(p, p), value=1.0)
        mask_pads = _torch_pads(zero, extra)
    else:
        mask_pads = pads
    return (_avg_pool(F.pad(x, pads), k, s, zero)
            / _avg_pool(F.pad(mask, mask_pads), k, s, zero))


@register("Pooling")
def _pooling(attrs, data):
    """max, avg or sum pooling of 1-, 2- or 3-d data; 'same' is 'full'
    beyond 1-d (pooling.cc)."""
    nd = data.dim() - 2
    pool_type = attrs.get("pool_type", "max")
    if pool_type not in ("max", "avg", "sum"):
        raise ValueError("unsupported pool_type %s" % pool_type)
    layout = attrs.get("layout")
    global_pool = bool(attrs.get("global_pool", False))
    kernel = (1,) * nd if global_pool else _pair(attrs["kernel"], nd)
    convention = attrs.get("pooling_convention", "valid")
    return pooling(data, kernel, _pair(attrs.get("stride", 1), nd),
                   _pair(attrs.get("pad", 0), nd), pool_type,
                   convention != "valid", global_pool,
                   bool(attrs.get("count_include_pad", True)),
                   layout is not None and not layout.startswith("NC"),
                   convention)


@register("UpSampling")
def _upsampling(attrs, *inputs):
    """``nearest``: each input repeated up to the first input's scaled
    extent, then concatenated on channels (``multi_input_mode`` concat) or
    summed; ``bilinear``: a grouped Deconvolution over the weight input
    (kernel 2s - s % 2, stride s, pad ceil((s - 1) / 2), no bias), as the
    reference implements it (upsampling-inl.h:170-206)."""
    scale = int(attrs["scale"])
    sample_type = attrs.get("sample_type", "nearest")
    if sample_type == "nearest":
        out_h = inputs[0].shape[2] * scale
        ups = []
        for x in inputs:
            s_i = out_h // x.shape[2]
            ups.append(x.repeat_interleave(s_i, dim=2)
                       .repeat_interleave(s_i, dim=3))
        if len(ups) == 1:
            return ups[0]
        if attrs.get("multi_input_mode") == "sum":
            out = ups[0]
            for u in ups[1:]:
                out = out + u
            return out
        return torch.cat(ups, dim=1)
    if sample_type == "bilinear":
        if len(inputs) < 2:
            raise ValueError(
                "UpSampling(sample_type='bilinear') takes (data, weight): "
                "it is a grouped Deconvolution over a learnable kernel")
        data, weight = inputs[0], inputs[1]
        kernel = 2 * scale - scale % 2
        pad = int(math.ceil((scale - 1) / 2.0))
        num_filter = int(attrs.get("num_filter", data.shape[1]))
        return _deconvolution(
            {"kernel": (kernel, kernel), "stride": (scale, scale),
             "pad": (pad, pad), "num_group": num_filter,
             "num_filter": num_filter, "no_bias": True}, data, weight)
    raise ValueError(sample_type)


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


def _is_rrelu(attrs):
    return attrs.get("act_type", "leaky") == "rrelu"


@register("LeakyReLU", mode_dependent=_is_rrelu, needs_rng=_is_rrelu)
def _leaky_relu(attrs, data, gamma=None):
    """leaky, elu, selu, prelu (slope ``gamma`` per channel, axis 1), gelu
    (tanh form, as ``jax.nn.gelu``) and rrelu, whose slopes are drawn per
    element from ``U(lower_bound, upper_bound)`` in training (the midpoint
    in prediction), from the call's key."""
    act = attrs.get("act_type", "leaky")
    slope = float(attrs.get("slope", 0.25))
    if act == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act == "elu":
        return torch.where(data >= 0, data, slope * (torch.exp(data) - 1))
    if act == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(data >= 0, data,
                                   alpha * (torch.exp(data) - 1))
    if act == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 else gamma
        return torch.where(data >= 0, data, g * data)
    if act == "gelu":
        return F.gelu(data, approximate="tanh")
    if act == "rrelu":
        lower = float(attrs.get("lower_bound", 0.125))
        upper = float(attrs.get("upper_bound", 0.334))
        if attrs.get("_training", False):
            from .random_ops import uniform
            sl = uniform(attrs["_rng_key"], data.shape, data.dtype, lower,
                         upper, data.device)
            return torch.where(data >= 0, data, sl * data)
        return torch.where(data >= 0, data, (lower + upper) / 2 * data)
    raise ValueError("unknown act_type %s" % act)


@register("L2Normalization")
def _l2_normalization(attrs, data):
    """``data`` over sqrt(sum of squares + eps) across every axis but the
    batch (``instance``), the channels (``channel``) or the spatial axes
    (``spatial``)."""
    eps = float(attrs.get("eps", 1e-10))
    mode = attrs.get("mode", "instance")
    if mode == "instance":
        axes = tuple(range(1, data.dim()))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, data.dim()))
    else:
        raise ValueError(mode)
    return data / torch.sqrt(torch.sum(torch.square(data), dim=axes,
                                       keepdim=True) + eps)


@register("LRN")
def _lrn(attrs, data):
    """Local response normalization across ``nsize`` channels:
    x / (knorm + alpha * sum(x^2) / nsize)^beta."""
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    knorm = float(attrs.get("knorm", 2.0))
    nsize = int(attrs["nsize"])
    pad = nsize // 2
    sq_pad = F.pad(torch.square(data), (0, 0, 0, 0, pad, pad))
    acc = torch.zeros_like(data)
    for i in range(nsize):
        acc = acc + sq_pad[:, i:i + data.shape[1]]
    return data / torch.pow(knorm + alpha * acc / nsize, beta)


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


@register("softmin")
def _softmin(attrs, data):
    return torch.softmax(-data, dim=int(attrs.get("axis", -1)))


@register("SoftmaxActivation")
def _softmax_activation(attrs, data):
    """Softmax over the channels (``mode='channel'``) or over all but the
    batch axis (``instance``)."""
    if attrs.get("mode", "instance") == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


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


# ---------------------------------------------------------------------------
# Dropout, InstanceNorm, CTCLoss

def dropout_mask_shape(shape, axes):
    """The mask's shape: 1 along ``axes`` (as given, not normalized, as in
    the JAX op), the data's elsewhere."""
    axes = tuple(axes)
    return tuple(1 if i in axes else s for i, s in enumerate(shape))


def dropout(x, p, key, axes=()):
    """``x * bernoulli(key, 1 - p, mask shape).astype(x.dtype) / (1 - p)``,
    bit for bit the JAX op's (the divisor rounded to ``x``'s dtype first,
    as JAX's weak-typed scalar is)."""
    from .random_ops import bernoulli
    keep = 1.0 - p
    mask = bernoulli(key, keep, dropout_mask_shape(x.shape, axes), x.device)
    divisor = float(torch.tensor(keep, dtype=x.dtype))
    return x * mask.to(x.dtype).div_(divisor)


@register("Dropout", mode_dependent=True, needs_rng=True)
def _dropout(attrs, data):
    """The identity in prediction (unless ``mode='always'``) and at
    ``p <= 0``; else :func:`dropout` with the call's key
    (``mxnet_tpu/ops/nn_ops.py:711-729``).  Its gradient is the mask."""
    p = float(attrs.get("p", 0.5))
    training = bool(attrs.get("_training", False))
    if (not training and attrs.get("mode", "training") != "always") \
            or p <= 0:
        return data
    return dropout(data, p, attrs["_rng_key"], attrs.get("axes", ()))


def instance_norm(x, gamma, beta, eps):
    """Normalize each sample's channels over the spatial axes with the
    biased variance, then scale and shift per channel (axis 1)."""
    axes = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    out = (x - mean) / torch.sqrt(var + eps)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


@register("InstanceNorm")
def _instance_norm(attrs, data, gamma, beta):
    return instance_norm(data, gamma, beta, float(attrs.get("eps", 1e-3)))


@register("CTCLoss")
def _ctc_loss(attrs, data, label, data_lengths=None, label_lengths=None):
    """Connectionist temporal classification loss per sample, (N,), of
    ``data`` (T, N, C) activations (log-softmax taken here) and ``label``
    (N, L) (``mxnet_tpu/ops/nn_ops.py:966-1068``).  ``blank_label='first'``
    reserves class 0 (labels from 1, padding 0), ``'last'`` class C-1
    (labels from 0, padding -1).  A length input is taken only where its
    flag (``use_data_lengths``, ``use_label_lengths``) is set; else a
    sample's label length counts its non-padding entries and its data
    length is T.  The loss is torch's ``ctc_loss`` (a jnp scan in the
    reference, not a Pallas kernel)."""
    T, N, C = data.shape
    blank_first = str(attrs.get("blank_label", "first")) == "first"
    blank = 0 if blank_first else C - 1
    pad_val = 0 if blank_first else -1
    use_dl = bool(attrs.get("use_data_lengths", False))
    use_ll = bool(attrs.get("use_label_lengths", False))
    extras = [x for x in (data_lengths, label_lengths) if x is not None]
    if not attrs:   # a direct call: trust the keyword positions
        use_dl, use_ll = data_lengths is not None, label_lengths is not None
    dl = extras.pop(0) if use_dl and extras else None
    ll = extras.pop(0) if use_ll and extras else None
    if extras:
        raise ValueError(
            "CTCLoss got %d length input(s) not covered by use_data_lengths/"
            "use_label_lengths; set the matching flag(s)" % len(extras))
    label = label.to(torch.int64)
    lab_len = ll.to(torch.int64) if ll is not None \
        else (label != pad_val).sum(dim=1)
    seq_len = dl.to(torch.int64) if dl is not None \
        else torch.full((N,), T, dtype=torch.int64, device=data.device)
    logp = torch.log_softmax(data.to(torch.float32), dim=-1)
    targets = torch.where(label == pad_val, torch.zeros_like(label), label) \
        if label.shape[1] else label
    loss = F.ctc_loss(logp, targets, seq_len, lab_len, blank=blank,
                      reduction="none", zero_infinity=False)
    return loss.to(data.dtype)


alias("ctc_loss", "CTCLoss")
alias("_contrib_CTCLoss", "CTCLoss")
alias("_contrib_ctc_loss", "CTCLoss")


# ---------------------------------------------------------------------------
# regression output layers: the forward is the prediction, the gradient
# grad_scale * (pred - label) (its sign for MAE) over the outputs a sample,
# whatever the head gradient

class _RegressionOutput(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(data if kind != "logistic" else out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        pred, label = ctx.saved_tensors
        num_out = max(math.prod(pred.shape[1:]), 1)
        diff = pred - label.reshape(pred.shape)
        if ctx.kind == "mae":
            diff = torch.sign(diff)
        return ctx.grad_scale * diff / num_out, None, None, None


def _regression(kind):
    def fcompute(attrs, data, label):
        return _RegressionOutput.apply(data, label, kind,
                                       float(attrs.get("grad_scale", 1.0)))
    return fcompute


register("LinearRegressionOutput")(_regression("linear"))
register("MAERegressionOutput")(_regression("mae"))
register("LogisticRegressionOutput")(_regression("logistic"))


# ---------------------------------------------------------------------------
# sequence ops (sequence_mask.cc, sequence_last.cc, sequence_reverse.cc):
# time on axis 0 (T, B, ...) or, for Mask and Last, on axis 1 (B, T, ...)

@register("SequenceMask")
def _sequence_mask(attrs, data, sequence_length=None):
    """``value`` at the steps of each sequence past its length."""
    if not attrs.get("use_sequence_length", False) \
            or sequence_length is None:
        return data
    axis = int(attrs.get("axis", 0))
    pos = torch.arange(data.shape[axis], device=data.device)
    lens = _index(sequence_length)
    mask = pos[:, None] < lens[None, :] if axis == 0 \
        else pos[None, :] < lens[:, None]
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.full_like(
        data, float(attrs.get("value", 0.0))))


@register("SequenceLast")
def _sequence_last(attrs, data, sequence_length=None):
    """Each sequence's last step (at its length, or the axis's end)."""
    axis = int(attrs.get("axis", 0))
    if not attrs.get("use_sequence_length", False) \
            or sequence_length is None:
        return data.select(axis, -1)
    last = _index(sequence_length) - 1
    shape = ((1, -1) if axis == 0 else (-1, 1)) + (1,) * (data.dim() - 2)
    idx = last.reshape(shape).expand(
        *[1 if d == axis else n for d, n in enumerate(data.shape)])
    return torch.gather(data, axis, idx).squeeze(axis)


@register("SequenceReverse")
def _sequence_reverse(attrs, data, sequence_length=None):
    """The first ``length`` steps of each sequence reversed (axis 0), the
    rest in place."""
    if not attrs.get("use_sequence_length", False) \
            or sequence_length is None:
        return torch.flip(data, dims=(0,))
    lens = _index(sequence_length)[None, :]
    pos = torch.arange(data.shape[0], device=data.device)[:, None]
    rev = torch.where(pos < lens, lens - 1 - pos, pos)
    rev = rev.reshape(tuple(rev.shape) + (1,) * (data.dim() - 2))
    return torch.gather(data, 0, rev.expand(data.shape))


@register("IdentityAttachKLSparseReg")
def _identity_attach_kl(attrs, data):
    return data


# ---------------------------------------------------------------------------
# the spatial samplers and the correlation layer (``:907``, ``:1111-1177``)

@register("Correlation")
def _correlation(attrs, data1, data2):
    """FlowNet's correlation (correlation.cc): for every output position
    and each of the (2 * max_displacement / stride2 + 1)^2 displacements,
    the kernel window's product (or absolute difference) of data1 with
    data2 displaced, averaged over kernel_size^2 * channels.  Each
    displacement is one shifted elementwise pass and a strided window sum,
    as in the JAX op."""
    K = int(attrs.get("kernel_size", 1))
    md = int(attrs.get("max_displacement", 1))
    s1 = int(attrs.get("stride1", 1))
    s2 = int(attrs.get("stride2", 1))
    pad = int(attrs.get("pad_size", 0))
    is_multiply = bool(attrs.get("is_multiply", True))
    N, C, H, W = data1.shape
    kr = (K - 1) // 2
    border = md + kr
    Hp, Wp = H + 2 * pad, W + 2 * pad
    top_h = -(-(Hp - 2 * border) // s1)
    top_w = -(-(Wp - 2 * border) // s1)
    grid_r = md // s2
    y_hi = md + (top_h - 1) * s1 + K
    x_hi = md + (top_w - 1) * s1 + K
    HA, WA = max(Hp, y_hi), max(Wp, x_hi)
    t1 = data1.new_zeros((N, HA, WA, C))
    t1[:, pad:pad + H, pad:pad + W] = _channel_last(data1)
    t2 = data2.new_zeros((N, HA + 2 * md, WA + 2 * md, C))
    t2[:, md + pad:md + pad + H, md + pad:md + pad + W] = \
        _channel_last(data2)
    scale = 1.0 / (K * K * C)
    channels = []
    for dy in range(-grid_r, grid_r + 1):
        for dx in range(-grid_r, grid_r + 1):
            shifted = t2[:, md + dy * s2:md + dy * s2 + HA,
                         md + dx * s2:md + dx * s2 + WA]
            if is_multiply:
                prod = torch.sum(t1 * shifted, dim=-1)
            else:
                prod = torch.sum(torch.abs(t1 - shifted), dim=-1)
            acc = 0.0
            for h in range(K):
                for w in range(K):
                    acc = acc + prod[:, md + h:md + h + (top_h - 1) * s1 + 1:s1,
                                     md + w:md + w + (top_w - 1) * s1 + 1:s1]
            channels.append(acc * scale)
    # channel order: (dy + grid_r) * D + (dx + grid_r)
    return torch.stack(channels, dim=1)


@register("GridGenerator")
def _grid_generator(attrs, data):
    """The sampling grid of an affine transform (data (N, 6)) over
    ``target_shape``, or of a flow field (``transform_type='warp'``, data
    (N, 2, H, W)), in [-1, 1] coordinates: (N, 2, H, W), x first."""
    transform_type = attrs.get("transform_type", "affine")
    if transform_type == "affine":
        H, W = tuple(attrs.get("target_shape", (0, 0)))
        f32 = dict(dtype=torch.float32, device=data.device)
        gy, gx = torch.meshgrid(torch.linspace(-1, 1, H, **f32),
                                torch.linspace(-1, 1, W, **f32),
                                indexing="ij")
        grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                            torch.ones_like(gx).reshape(-1)], dim=0)
        theta = data.reshape(-1, 2, 3)
        return torch.matmul(theta, grid).reshape(-1, 2, H, W)
    flow = data
    _, _, H, W = flow.shape
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=flow.dtype, device=flow.device),
        torch.arange(W, dtype=flow.dtype, device=flow.device),
        indexing="ij")
    gx2 = (gx[None] + flow[:, 0]) / max((W - 1) / 2.0, 1) - 1
    gy2 = (gy[None] + flow[:, 1]) / max((H - 1) / 2.0, 1) - 1
    return torch.stack([gx2, gy2], dim=1)


@register("BilinearSampler")
def _bilinear_sampler(attrs, data, grid):
    """Sample data (N, C, H, W) at grid (N, 2, Ho, Wo) in [-1, 1]
    coordinates, bilinearly; a corner outside the map counts zero
    (bilinear_sampler.cc:61-67), not the clamped edge."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1) * (h - 1) / 2.0
    x0 = _index(torch.floor(gx))
    y0 = _index(torch.floor(gy))
    x1, y1 = x0 + 1, y0 + 1
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]
    bidx = torch.arange(n, device=data.device).reshape(n, 1, 1)

    def gather(xi, yi):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        vals = data[bidx, :, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return vals * inb[..., None].to(vals.dtype)    # (n, Ho, Wo, c)

    out = (gather(x0, y0) * (1 - wx) * (1 - wy)
           + gather(x1, y0) * wx * (1 - wy)
           + gather(x0, y1) * (1 - wx) * wy
           + gather(x1, y1) * wx * wy)
    return _channel_first(out)


@register("SpatialTransformer")
def _spatial_transformer(attrs, data, loc):
    """An affine ``GridGenerator`` over ``target_shape`` feeding
    ``BilinearSampler``."""
    grid = _grid_generator({"transform_type": "affine",
                            "target_shape": tuple(attrs.get(
                                "target_shape", (0, 0)))}, loc)
    return _bilinear_sampler({}, data, grid)


# ---------------------------------------------------------------------------
# the fused RNN (``:786-900``): a loop over time in torch ops, as the
# reference's is a ``lax.scan`` of jnp ops (no Pallas kernel)

RNN_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_num_outputs(attrs):
    """The registered count (``:793-795``): 3 for an LSTM with
    ``state_outputs``, 2 for the other modes with it, 1 without."""
    if not attrs.get("state_outputs", False):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


def rnn_unpack(parameters, mode, input_size, state_size, num_layers, ndir):
    """Views of the packed blob (``:827-838``): every layer's and
    direction's ``Wx (G*H, in)`` then ``Wh (G*H, H)``, then all the biases,
    ``Bx`` then ``Bh`` for each; lists indexed by ``layer * ndir + d``."""
    G, H = RNN_GATES[mode], state_size
    offset = 0

    def take(shape):
        nonlocal offset
        n = math.prod(shape)
        w = parameters[offset:offset + n].reshape(shape)
        offset += n
        return w

    wx, wh, bx, bh = [], [], [], []
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else H * ndir
        for _ in range(ndir):
            wx.append(take((G * H, in_size)))
            wh.append(take((G * H, H)))
    for _ in range(num_layers * ndir):
        bx.append(take((G * H,)))
        bh.append(take((G * H,)))
    return wx, wh, bx, bh


def _rnn_step(mode, xp, h, c, whh, bh):
    """One step from the precomputed input projection ``xp`` (``:840-862``;
    the GRU is cuDNN's, ``n = tanh(xn + r * (hn + bn))``)."""
    if mode == "gru":
        xr, xz, xn = torch.chunk(xp, 3, dim=-1)
        hr, hz, hn = torch.chunk(torch.matmul(h, whh.t()), 3, dim=-1)
        br, bz, bn = torch.chunk(bh, 3)
        r = torch.sigmoid(xr + hr + br)
        z = torch.sigmoid(xz + hz + bz)
        n = torch.tanh(xn + r * (hn + bn))
        return (1 - z) * n + z * h, c
    gates = xp + torch.matmul(h, whh.t()) + bh
    if mode == "rnn_relu":
        return torch.relu(gates), c
    if mode == "rnn_tanh":
        return torch.tanh(gates), c
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


def rnn(data, parameters, state, state_cell=None, mode="lstm",
        state_size=None, num_layers=1, bidirectional=False, p=0.0,
        training=False, key=None):
    """The fused multi-layer RNN over ``data`` (T, B, I), as the JAX op
    computes it: for each layer and direction the input projection of all
    steps at once (``x Wx^T + Bx``), then a step at a time ``xp + h Wh^T +
    Bh`` through the gates.  The backward direction runs over the flipped
    sequence and flips its outputs back.  Between layers, in training with
    ``p > 0``, dropout draws ``key, sub = split(key)`` and keeps
    ``bernoulli(sub, 1 - p)``: ``x * mask / (1 - p)``, the JAX op's masks
    and arithmetic.  Returns ``(out, h_T, c_T)``, the final states stacked
    at ``layer * ndir + d``; a missing ``state_cell`` is zeros."""
    from .random_ops import bernoulli
    from ..random import split
    T, B, I = data.shape
    ndir = 2 if bidirectional else 1
    wx, wh, bx, bh = rnn_unpack(parameters, mode, I, int(state_size),
                                num_layers, ndir)
    x = data
    h_finals, c_finals = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(ndir):
            li = layer * ndir + d
            h = state[li]
            c = state_cell[li] if mode == "lstm" and state_cell is not None \
                else torch.zeros_like(h)
            xs = torch.flip(x, dims=(0,)) if d == 1 else x
            xp = torch.matmul(xs, wx[li].t()) + bx[li]
            ys = []
            for t in range(T):
                h, c = _rnn_step(mode, xp[t], h, c, wh[li], bh[li])
                ys.append(h)
            ys = torch.stack(ys)
            outs.append(torch.flip(ys, dims=(0,)) if d == 1 else ys)
            h_finals.append(h)
            c_finals.append(c)
        x = torch.cat(outs, dim=-1) if ndir == 2 else outs[0]
        if p > 0 and training and layer < num_layers - 1 \
                and key is not None:
            key, sub = split(key)
            mask = bernoulli(sub, 1 - p, tuple(x.shape), x.device)
            # a divisor on the device: a host scalar would make CUDA
            # multiply by its reciprocal instead of dividing
            x = x * mask.to(x.dtype) / torch.full(
                (), 1 - p, dtype=x.dtype, device=x.device)
    return x, torch.stack(h_finals), torch.stack(c_finals)


@register("RNN", num_outputs=rnn_num_outputs, mode_dependent=True,
          needs_rng=True)
def _rnn(attrs, data, parameters, state, state_cell=None):
    """The fused RNN (``:793-900``), :func:`rnn` under the op's attributes;
    its outputs as :func:`rnn_num_outputs` counts them."""
    mode = attrs.get("mode", "lstm")
    out, hs, cs = rnn(
        data, parameters, state, state_cell, mode, int(attrs["state_size"]),
        int(attrs.get("num_layers", 1)), bool(attrs.get("bidirectional",
                                                        False)),
        float(attrs.get("p", 0.0)), bool(attrs.get("_training", False)),
        attrs.get("_rng_key"))
    if not attrs.get("state_outputs", False):
        return out
    return (out, hs, cs) if mode == "lstm" else (out, hs)


# ---------------------------------------------------------------------------
# the symbolic API's input specs and parameter shapes (the JAX package's
# ``nn_ops.py:1185-1340``, for the ops ported here)

def _with_bias(attrs):
    return ["data", "weight"] + ([] if attrs.get("no_bias") else ["bias"])


def _prod(t):
    n = 1
    for s in t:
        n *= s
    return n


def _fc_param_shapes(attrs, in_shapes):
    data = in_shapes[0]
    nh = int(attrs["num_hidden"])
    in_dim = _prod(data[1:]) if bool(attrs.get("flatten", True)) \
        else data[-1]
    out = {"weight": (nh, in_dim)}
    if not attrs.get("no_bias"):
        out["bias"] = (nh,)
    return out


def _conv_param_shapes(attrs, in_shapes):
    data = in_shapes[0]
    nf = int(attrs["num_filter"])
    ng = int(attrs.get("num_group", 1))
    kernel = (attrs["kernel"],) if isinstance(attrs["kernel"], int) \
        else tuple(attrs["kernel"])
    layout = attrs.get("layout")
    if layout is not None and not layout.startswith("NC"):
        out = {"weight": (nf,) + kernel + (data[-1] // ng,)}
    else:
        out = {"weight": (nf, data[1] // ng) + kernel}
    if not attrs.get("no_bias"):
        out["bias"] = (nf,)
    return out


def _deconv_param_shapes(attrs, in_shapes):
    data = in_shapes[0]
    nf = int(attrs["num_filter"])
    ng = int(attrs.get("num_group", 1))
    kernel = (attrs["kernel"],) if isinstance(attrs["kernel"], int) \
        else tuple(attrs["kernel"])
    out = {"weight": (data[1], nf // ng) + kernel}
    if not attrs.get("no_bias", True):
        out["bias"] = (nf,)
    return out


def _bn_param_shapes(attrs, in_shapes):
    c = in_shapes[0][int(attrs.get("axis", 1))]
    return {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
            "moving_var": (c,)}


def _ln_param_shapes(attrs, in_shapes):
    c = in_shapes[0][int(attrs.get("axis", -1))]
    return {"gamma": (c,), "beta": (c,)}


def _in_param_shapes(attrs, in_shapes):
    return {"gamma": (in_shapes[0][1],), "beta": (in_shapes[0][1],)}


def _embedding_param_shapes(attrs, in_shapes):
    return {"weight": (int(attrs["input_dim"]), int(attrs["output_dim"]))}


def _prelu_param_shapes(attrs, in_shapes):
    if attrs.get("act_type") == "prelu":
        return {"gamma": (in_shapes[0][1],)}
    return {}


def _softmax_output_label_shape(attrs, in_shapes):
    data = in_shapes[0]
    if attrs.get("multi_output"):
        return {"label": (data[0],) + tuple(data[2:])}
    if attrs.get("preserve_shape"):
        return {"label": tuple(data[:-1])}
    return {"label": (data[0],)}


def _regression_label_shape(attrs, in_shapes):
    return {"label": tuple(in_shapes[0])}


def _rnn_param_shapes(attrs, in_shapes):
    T, B, I = in_shapes[0]
    H = int(attrs["state_size"])
    L = int(attrs.get("num_layers", 1))
    D = 2 if attrs.get("bidirectional") else 1
    G = RNN_GATES[attrs.get("mode", "lstm")]
    total = 0
    in_size = I
    for _ in range(L):
        total += D * (G * H * in_size + G * H * H)
        in_size = H * D
    total += 2 * L * D * G * H
    out = {"parameters": (total,), "state": (L * D, B, H)}
    if attrs.get("mode") == "lstm":
        out["state_cell"] = (L * D, B, H)
    return out


def set_symbol_specs():
    """Attach the specs (once every op module has registered)."""
    from .registry import get_op
    specs = {
        "FullyConnected": (_with_bias, _fc_param_shapes),
        "Convolution": (_with_bias, _conv_param_shapes),
        "Deconvolution": (lambda attrs: ["data", "weight"] + (
            [] if attrs.get("no_bias", True) else ["bias"]),
            _deconv_param_shapes),
        "BatchNorm": (["data", "gamma", "beta", "aux:moving_mean",
                       "aux:moving_var"], _bn_param_shapes),
        "LayerNorm": (["data", "gamma", "beta"], _ln_param_shapes),
        "InstanceNorm": (["data", "gamma", "beta"], _in_param_shapes),
        "Embedding": (["data", "weight"], _embedding_param_shapes),
        "LeakyReLU": (lambda attrs: ["data", "gamma"]
                      if attrs.get("act_type") == "prelu" else ["data"],
                      _prelu_param_shapes),
        "SoftmaxOutput": (["data", "label:label"],
                          _softmax_output_label_shape),
        "softmax_cross_entropy": (["data", "label:label"],
                                  _softmax_output_label_shape),
        "CTCLoss": (["data", "label:label"], None),
        "LinearRegressionOutput": (["data", "label:label"],
                                   _regression_label_shape),
        "MAERegressionOutput": (["data", "label:label"],
                                _regression_label_shape),
        "LogisticRegressionOutput": (["data", "label:label"],
                                     _regression_label_shape),
        "RNN": (lambda attrs: ["data", "parameters", "zero:state"] + (
            ["zero:state_cell"] if attrs.get("mode", "lstm") == "lstm"
            else []), _rnn_param_shapes),
        "SVMOutput": (["data", "label:label"],
                      lambda attrs, in_shapes: {"label": (in_shapes[0][0],)}),
    }
    for name, (spec, shapes) in specs.items():
        op = get_op(name)
        op.arg_spec, op.param_shape_fn = spec, shapes

