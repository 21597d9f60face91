"""The quantized ops of int8 inference (counterpart of
``mxnet_tpu/ops/quantization_ops.py``): ``_contrib_quantize`` :23,
``_contrib_quantize_v2`` :39, ``_contrib_dequantize`` :55,
``_contrib_requantize`` :67, ``_contrib_quantized_fully_connected`` :83,
``_contrib_quantized_conv`` :119, ``_contrib_quantized_flatten`` :163 and
``_contrib_quantized_pooling`` :170.

Scales are per tensor, from each tensor's (min, max) range.  The FC and
the convolution multiply int8 by int8 into exact int32 sums, then rescale
in fp32 in the JAX ops' order (``acc * (d_scale * w_scale)``, then the
bias term), so that given the same inputs every output equals the JAX
package's bit for bit: the sums are exact and ``round`` is half-to-even in
both.  The fp32 arithmetic is the one XLA compiles those ops to, which is
not always the one they spell: a division by a constant becomes a product
by its fp32 reciprocal (:func:`_div_const`), the two 1/127 factors of
``d_scale * w_scale`` fold into one constant (:data:`_STEP2`), and a
product feeding a sum becomes one fused multiply-add (:func:`_fma`).

The JAX package runs the products as XLA int8 dots
(``preferred_element_type=int32``), not as Pallas kernels; here they are
one call of :func:`int8_gemm`, ``torch._int_mm`` (cuBLASLt's int8
tensor-core GEMM on the card), the convolution over an im2col of its int8
input.  There is no float fallback: a CUDA product that cannot run
raises.  A float input is converted to int8 as XLA converts (``cast``).
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..ndarray.ndarray import cast
from .nn_ops import _pair
from .registry import register

__all__ = ["int8_gemm", "im2col"]

_launch_lock = threading.Lock()


def _round_up(n, m):
    return -(-n // m) * m


def int8_gemm(a, w):
    """``a @ w.T`` of int8 (M, K) and (N, K) as exact int32 (M, N), in
    ``torch._int_mm``.  cuBLASLt takes M > 16 and K, N multiples of 8:
    the operands are padded with zero rows and columns to fit (the zeros
    add nothing to a sum) and the result is cut back.  ``w`` goes in as
    the column-major (K, N) view of its rows.  Launches on CUDA tensors are
    counted in ``int8_gemm.launches`` (not under CUDA-graph capture)."""
    M, K = a.shape
    N = w.shape[0]
    Mp, Kp, Np = max(M, 17), _round_up(K, 8), _round_up(N, 8)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        w = F.pad(w, (0, Kp - K, 0, Np - N))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    if a.device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
        with _launch_lock:
            int8_gemm.launches += 1
    if (Mp, Np) != (M, N):
        out = out[:M, :N]
    return out


int8_gemm.launches = 0


def im2col(x, kernel, stride, pad, dilate):
    """(N, C, *spatial) -> (N * prod(out), C * prod(kernel)): each output
    position's receptive field, channel-major as a (C, *kernel) weight
    flattens, in ``x``'s dtype (zero padding), and the output's spatial
    shape."""
    nd = x.dim() - 2
    x = F.pad(x, [p for p in reversed(pad) for _ in (0, 1)])
    for i in range(nd):
        x = x.unfold(2 + i, dilate[i] * (kernel[i] - 1) + 1, stride[i])
    if any(d != 1 for d in dilate):
        x = x[(Ellipsis,) + tuple(slice(None, None, d) for d in dilate)]
    out_shape = tuple(x.shape[2:2 + nd])
    # (N, C, *out, *kernel) -> (N, *out, C, *kernel)
    x = x.permute(0, *range(2, 2 + nd), 1, *range(2 + nd, 2 + 2 * nd))
    return x.reshape(-1, x.shape[1 + nd] * math.prod(kernel)), out_shape


def _scalar(t):
    return t.reshape(())


def _div_const(x, c):
    """``x / c`` for a constant ``c`` as XLA computes it: ``x`` times the
    fp32 reciprocal of ``c``."""
    return x * float(np.float32(1.0) / np.float32(c))


def _fma(a, b, c):
    """``a * b + c`` with one rounding, as XLA fuses it: the fp32 product
    is exact in fp64, and the fp64 sum rounds to the fp32 one unless it
    falls on an fp32 tie (odds near 2^-29 a value)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _amax(mn, mx):
    return torch.maximum(torch.abs(_scalar(mn)), torch.abs(_scalar(mx)))


def _amax_scale(mn, mx):
    """max(|min|, |max|) / 127: the fp32 value of one int8 step."""
    return _div_const(_amax(mn, mx), 127.0)


# (1/127)^2 in fp32, as XLA folds the two reciprocals of
# (amax_d / 127) * (amax_w / 127) into (amax_d * amax_w) * _STEP2
_STEP2 = float(np.float32(np.float32(1.0) / np.float32(127.0))
               * np.float32(np.float32(1.0) / np.float32(127.0)))


@register("_contrib_quantize", num_outputs=3)
def _quantize(attrs, data, min_range, max_range):
    """``data`` as uint8 codes over [min, max] (``out_type`` uint8), or
    as symmetric int8 codes in [-127, 127]; the range passes through."""
    mn, mx = _scalar(min_range), _scalar(max_range)
    if attrs.get("out_type", "uint8") == "uint8":
        scale = 255.0 / torch.clamp(mx - mn, min=1e-12)
        q = _codes(torch.clamp(torch.round((data - mn) * scale), 0, 255),
                   torch.uint8)
    else:
        scale = 127.0 / torch.clamp(_amax(mn, mx), min=1e-12)
        q = _codes(torch.clamp(torch.round(data * scale), -127, 127),
                   torch.int8)
    return q, mn.reshape(1), mx.reshape(1)


def _codes(t, dtype):
    """Whole values already in ``dtype``'s range as ``dtype``: what
    ``cast`` gives them (NaN to 0) in two passes instead of four."""
    return torch.nan_to_num(t, nan=0.0).to(dtype)


@register("_contrib_quantize_v2", num_outputs=3)
def _quantize_v2(attrs, data):
    """Quantize over ``data``'s own min and max, or over the calibrated
    ``min_calib_range``/``max_calib_range`` when both are set."""
    if attrs.get("min_calib_range") is not None \
            and attrs.get("max_calib_range") is not None:
        mn = torch.full((1,), float(attrs["min_calib_range"]),
                        dtype=torch.float32, device=data.device)
        mx = torch.full((1,), float(attrs["max_calib_range"]),
                        dtype=torch.float32, device=data.device)
    else:
        mn, mx = torch.amin(data).reshape(1), torch.amax(data).reshape(1)
    return _quantize({"out_type": attrs.get("out_type", "int8")}, data,
                     mn, mx)


@register("_contrib_dequantize")
def _dequantize(attrs, data, min_range, max_range):
    mn, mx = _scalar(min_range), _scalar(max_range)
    if data.dtype == torch.uint8:
        return _fma(data.to(torch.float32), _div_const(mx - mn, 255.0), mn)
    return data.to(torch.float32) * _amax_scale(mn, mx)


@register("_contrib_requantize", num_outputs=3)
def _requantize(attrs, data, min_range, max_range):
    """int32 sums -> int8 codes over the sums' own range (the int32 range
    stands for max(|min|, |max|) at 2^30)."""
    real = data.to(torch.float32) * _div_const(_amax(min_range, max_range),
                                                float(1 << 30))
    new_mn, new_mx = torch.amin(real), torch.amax(real)
    q = _codes(torch.clamp(torch.round(real * 127.0 / torch.clamp(
        _amax(new_mn, new_mx), min=1e-12)), -127, 127), torch.int8)
    return q, new_mn.reshape(1), new_mx.reshape(1)


def _split_inputs(inputs):
    """(data, weight, bias, min_data, max_data, min_w, max_w, min_b,
    max_b) from the 9-input layout, or from the 6-input one without a
    bias (bias and its range None)."""
    if len(inputs) == 6:
        data, weight, min_data, max_data, min_w, max_w = inputs
        return data, weight, None, min_data, max_data, min_w, max_w, \
            None, None
    return tuple(inputs)


def _rescale(acc, attrs, bias, min_d, max_d, min_w, max_w, min_b, max_b,
             bias_shape):
    """fp32 outputs of the int32 sums and their (min, max)."""
    scale = (_amax(min_d, max_d) * _amax(min_w, max_w)) * _STEP2
    if bias is not None and not attrs.get("no_bias", False):
        b = (bias.to(torch.float32) * _amax_scale(min_b, max_b)).reshape(
            bias_shape)
        out = _fma(acc.to(torch.float32), scale, b)
    else:
        out = acc.to(torch.float32) * scale
    return out, torch.amin(out).reshape(1), torch.amax(out).reshape(1)


@register("_contrib_quantized_fully_connected", num_outputs=3)
def _quantized_fc(attrs, *inputs):
    """int8 x int8 -> fp32 FullyConnected (quantized_fully_connected.cc),
    flattening (B, ...) data as the float op does."""
    data, weight, bias, min_d, max_d, min_w, max_w, min_b, max_b = \
        _split_inputs(inputs)
    if bool(attrs.get("flatten", True)) and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    lead = data.shape[:-1]
    acc = int8_gemm(cast(data, torch.int8).reshape(-1, data.shape[-1]),
                    cast(weight, torch.int8))
    acc = acc.reshape(tuple(lead) + (weight.shape[0],))
    return _rescale(acc, attrs, bias, min_d, max_d, min_w, max_w, min_b,
                    max_b, (-1,))


@register("_contrib_quantized_conv", num_outputs=3)
def _quantized_conv(attrs, *inputs):
    """int8 x int8 -> fp32 convolution (quantized_conv.cc) over NC...
    data: each group's im2col times its filters in :func:`int8_gemm`; a
    1 x 1 kernel of stride 1 and no padding reads its input as it is."""
    data, weight, bias, min_d, max_d, min_w, max_w, min_b, max_b = \
        _split_inputs(inputs)
    nd = data.dim() - 2
    kernel = tuple(weight.shape[2:])
    stride = _pair(attrs.get("stride", 1), nd)
    pad = _pair(attrs.get("pad", 0), nd)
    dilate = _pair(attrs.get("dilate", 1), nd)
    groups = int(attrs.get("num_group", 1))
    x = cast(data, torch.int8)
    w = cast(weight, torch.int8)
    N, C = x.shape[:2]
    O = w.shape[0]
    parts = []
    for g in range(groups):
        xg = x[:, g * C // groups:(g + 1) * C // groups]
        wg = w[g * O // groups:(g + 1) * O // groups]
        if all(k == 1 for k in kernel) and all(s == 1 for s in stride) \
                and not any(pad):
            cols = xg.movedim(1, -1).reshape(-1, xg.shape[1])
            out_shape = tuple(x.shape[2:])
        else:
            cols, out_shape = im2col(xg, kernel, stride, pad, dilate)
        parts.append(int8_gemm(cols, wg.reshape(wg.shape[0], -1)))
    acc = parts[0] if groups == 1 else torch.cat(parts, dim=1)
    # (N * out, O) -> (N, O, *out), channels last in memory
    acc = acc.reshape((N,) + out_shape + (O,)).movedim(-1, 1)
    return _rescale(acc, attrs, bias, min_d, max_d, min_w, max_w, min_b,
                    max_b, (1, -1) + (1,) * nd)


@register("_contrib_quantized_flatten", num_outputs=3)
def _quantized_flatten(attrs, data, min_data, max_data):
    """(B, ...) -> (B, -1), the range passed through."""
    return data.reshape(data.shape[0], -1), min_data, max_data


@register("_contrib_quantized_pooling", num_outputs=3)
def _quantized_pooling(attrs, data, min_data, max_data):
    """Pooling of the codes, the range passed through: a max pools them as
    they are (pooled in fp32, which holds every code, and converted back);
    an average rounds the mean back to a code."""
    from . import nn_ops
    pooled = nn_ops._pooling(dict(attrs), data.to(torch.float32))
    if attrs.get("pool_type", "max") != "max":
        pooled = torch.clamp(torch.round(pooled), -128, 127)
    return _codes(pooled, data.dtype), min_data, max_data
