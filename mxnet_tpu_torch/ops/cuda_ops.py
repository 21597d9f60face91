"""Flash attention on the card (counterpart of
``mxnet_tpu/ops/pallas_ops.py``).

The JAX package runs a Pallas TPU kernel (``_flash_attention_pallas``);
here the same function runs in a CUDA C++ kernel written for Hopper,
``csrc/flash_attention.cu``, built by ``_kernels.py`` at first use.

:func:`_attention_reference` is the plain version: the CPU path, and the
yardstick the kernel is held to on the card.  A tensor on the CPU takes
it; a tensor on a CUDA device launches the kernel or raises.  There is no
fallback from one to the other.

Both devices go through one ``torch.autograd.Function``.  Its backward is
the gradient of the plain version, recomputed from the saved q, k and v in
their dtype (fp32 or bf16), as the JAX ``custom_vjp`` does
(``pallas_ops.py:201-210``): the JAX package has no backward kernel, so
neither has the port.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["flash_attention"]

_D_SUPPORTED = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_launch_lock = threading.Lock()


def _causal_offset(causal, Tq, Tk):
    """Key-position offset of the causal diagonal: query i attends keys
    j <= i + offset.  'top' aligns query 0 with key 0 (offset 0); 'bottom'
    is the KV-cache decode convention (the last query sees every key,
    offset Tk - Tq).  The two coincide when Tq == Tk."""
    return Tk - Tq if causal == "bottom" else 0


def _attention_reference(q, k, v, causal, scale):
    """Plain PyTorch attention: fp32 scores scaled after q.k^T, masked
    scores set to -1e30 (not -inf), softmax, then p.v in v's dtype."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        off = _causal_offset(causal, Tq, Tk)
        rows = torch.arange(Tq, device=q.device)[:, None]
        cols = torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill(~(cols <= rows + off), -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _check_causal(causal, Tq, Tk):
    # identity checks: 1/1.0 would sneak past an `in` test via 1 == True
    if not (causal is False or causal is True
            or causal in ("top", "bottom")):
        raise ValueError("causal must be False/True/'top'/'bottom', got %r"
                         % (causal,))
    if causal is True and Tq != Tk:
        raise ValueError(
            "causal=True is ambiguous for q/k lengths %d vs %d: pass "
            "causal='top' (align query 0 with key 0) or causal='bottom' "
            "(KV-cache decode: last query sees every key)" % (Tq, Tk))
    if causal == "bottom" and Tq > Tk:
        # queries before the first key would attend nothing (0/0 rows)
        raise ValueError(
            "causal='bottom' needs q length <= k length, got %d vs %d"
            % (Tq, Tk))


def flash_attention(q, k, v, causal=False, scale=None):
    """Fused attention: softmax(scale * q k^T) v.

    q: (B, H, T, D), k/v: (B, H, Tk, D).  ``causal`` may be False, True,
    'top' or 'bottom' (see :func:`_causal_offset`); bare True needs
    T == Tk.  ``scale`` defaults to 1/sqrt(D).  Output is (B, H, T, D) in
    q's dtype.

    CPU tensors run the plain version.  CUDA tensors run the hand-written
    kernel (fp32 or bf16, D in {16, 32, 64, 128}, D contiguous; other
    strides are read as given), or raise.  Differentiable in q, k and v:
    the backward is the gradient of the plain version.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q/k/v must be (B, H, T, D), got %s/%s/%s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    Tq, Tk, D = q.shape[2], k.shape[2], q.shape[3]
    _check_causal(causal, Tq, Tk)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type not in ("cpu", "cuda"):
        raise MXNetError("flash_attention runs on CUDA or CPU tensors, got "
                         "device %s" % q.device)
    return _FlashAttention.apply(q, k, v, causal, float(scale))


# kernel launches, counted where they happen: in all, and by input dtype
flash_attention.launches = 0
flash_attention.launches_by_dtype = dict.fromkeys(("float32", "bfloat16"), 0)


@register("_contrib_flash_attention")
def _flash_attention_op(attrs, q, k, v):
    """``nd._contrib_flash_attention(q, k, v, causal=..., scale=...)``:
    :func:`flash_attention`, so CUDA inputs launch the kernel and CPU
    inputs take the plain version (``mxnet_tpu/ops/pallas_ops.py:213-216``
    passes ``bool(causal)``)."""
    return flash_attention(q, k, v, causal=bool(attrs.get("causal", False)),
                           scale=attrs.get("scale"))


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel on the card, the plain version on the CPU.
    Backward: the vjp of the plain version at the saved inputs (the JAX
    ``f_bwd``).  The saved q/k/v may be strided views of one projection;
    their gradients have the views' shapes, and autograd scatters them into
    the projection's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        if q.device.type == "cpu":
            return _attention_reference(q, k, v, causal, scale)
        return _flash_attention_cuda(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        wrt = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = _attention_reference(*inputs, ctx.causal, ctx.scale)
            grads = iter(torch.autograd.grad(out, wrt, grad_out))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None, None)


def _flash_attention_cuda(q, k, v, causal, scale):
    """Check shapes, dtypes and layout, allocate the output and launch."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != (B, H, Tk, D):
        raise ValueError("k/v must be (B, H, Tk, D) = (%d, %d, Tk, %d), got "
                         "%s/%s" % (B, H, D, tuple(k.shape), tuple(v.shape)))
    if not (k.device == q.device == v.device):
        raise ValueError("q/k/v on different devices: %s/%s/%s"
                         % (q.device, k.device, v.device))
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError("flash_attention kernel takes float32 or bfloat16 "
                        "q/k/v of one dtype, got %s/%s/%s"
                        % (q.dtype, k.dtype, v.dtype))
    if D not in _D_SUPPORTED:
        raise ValueError("flash_attention kernel takes head dim D in %s, got "
                         "%d" % (_D_SUPPORTED, D))
    if min(B, H, Tq, Tk) < 1:
        raise ValueError("flash_attention needs non-empty q/k/v, got %s/%s"
                         % (tuple(q.shape), tuple(k.shape)))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError("flash_attention kernel needs %s's last (D) dim "
                             "contiguous, got strides %s" % (name, t.stride()))
    from .. import _kernels
    lib = _kernels.load()
    out = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.mxt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, Tq, Tk, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(bool(causal)), _causal_offset(causal, Tq, Tk),
            ctypes.c_float(scale), stream)
    if err != 0:
        raise MXNetError("flash_attention kernel launch failed: cudaError %d "
                         "at q %s k %s %s" % (err, tuple(q.shape),
                                              tuple(k.shape), q.dtype))
    with _launch_lock:
        flash_attention.launches += 1
        flash_attention.launches_by_dtype[str(q.dtype)[len("torch."):]] += 1
    return out
