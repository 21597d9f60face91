"""The dense contrib ops (counterpart of part of
``mxnet_tpu/ops/contrib_ops.py``): ``_contrib_count_sketch`` :658,
``_contrib_fft`` :675 and ``_contrib_ifft`` :688, the interleaved
self-attention products :706-732 and ``_contrib_div_sqrt_dim`` :735.  The
detection ops (ROI pooling and align, multibox, proposals, box IoU and
NMS, the deformable convolution) wait for the detection slice.
"""
from __future__ import annotations

import math

import torch

from .registry import register

__all__ = []


@register("_contrib_count_sketch")
def _count_sketch(attrs, data, h, s):
    """(N, in_dim) -> (N, out_dim): out[n, h[i]] += s[i] * data[n, i]."""
    out_dim = int(attrs["out_dim"])
    idx = h.reshape(-1).long()
    signed = data * s.reshape(1, -1)
    out = torch.zeros((data.shape[0], out_dim), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, idx, signed)


@register("_contrib_fft")
def _fft(attrs, data):
    """Unnormalized FFT over the last axis: (..., d) real -> (..., 2d),
    re and im interleaved (cuFFT's complex layout)."""
    out = torch.fft.fft(data.to(torch.float32))
    inter = torch.stack([out.real, out.imag], dim=-1)
    return inter.reshape(tuple(data.shape[:-1]) + (-1,)).to(data.dtype)


@register("_contrib_ifft")
def _ifft(attrs, data):
    """Unnormalized inverse FFT: (..., 2d) interleaved -> (..., d) real
    (d times numpy's ifft)."""
    x = data.to(torch.float32)
    x = x.reshape(tuple(x.shape[:-1]) + (-1, 2))
    comp = torch.complex(x[..., 0], x[..., 1])
    d = comp.shape[-1]
    return (torch.fft.ifft(comp).real * d).to(data.dtype)


def _heads(qkv, heads, which):
    """(T, B, 3 H D) interleaved -> part ``which`` as (B H, T, D)."""
    T, B, _ = qkv.shape
    part = qkv.reshape(T, B, heads, 3, -1)[:, :, :, which]
    D = part.shape[-1]
    return part.permute(1, 2, 0, 3).reshape(B * heads, T, D)


@register("_contrib_interleaved_matmul_selfatt_qk")
def _selfatt_qk(attrs, queries_keys_values):
    """(T, B, 3 H D) -> (B H, T, T): q k^T / sqrt(D)."""
    heads = int(attrs["heads"])
    q = _heads(queries_keys_values, heads, 0)
    k = _heads(queries_keys_values, heads, 1)
    return torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])


@register("_contrib_interleaved_matmul_selfatt_valatt")
def _selfatt_valatt(attrs, queries_keys_values, attention):
    """(B H, T, T) attention over the values -> (T, B, H D)."""
    heads = int(attrs["heads"])
    T, B, _ = queries_keys_values.shape
    v = _heads(queries_keys_values, heads, 2)
    out = torch.matmul(attention, v).reshape(B, heads, T, -1)
    return out.permute(2, 0, 1, 3).reshape(T, B, -1)


@register("_contrib_div_sqrt_dim")
def _div_sqrt_dim(attrs, data):
    return data / math.sqrt(float(data.shape[-1]))
