"""Greedy non-maximum suppression's scan on the card.

The JAX package writes greedy NMS as a ``lax.fori_loop`` over the
score-sorted boxes in three ops of ``mxnet_tpu/ops/contrib_ops.py``:
``_contrib_MultiBoxDetection`` (:253), ``_contrib_box_nms`` (:298) and
``_contrib_Proposal`` (:515).  XLA compiles each loop into one device-side
while loop; the same scan as a Python loop of torch ops costs several
launches a step.  So the port runs the loop's recurrence in one
hand-written CUDA kernel, ``csrc/greedy_nms.cu``, built by
``_kernels.py`` at first use.  It is not the port of a Pallas kernel: the
reference has none here.

:func:`greedy_nms_reference` is the plain version, a loop that mirrors the
``fori_loop`` bodies: the CPU path, and the yardstick the kernel is held
to on the card.  A tensor on the CPU takes it; a tensor on a CUDA device
launches the kernel or raises.  There is no fallback from one to the
other.  The ops build the suppression mask in torch ops with their own IoU
formula, so both paths compare the same bits and the kernel does no float
arithmetic.
"""
from __future__ import annotations

import threading

import torch

from ..base import MXNetError

__all__ = ["greedy_nms", "greedy_nms_reference", "MAX_K"]

MAX_K = 65536   # csrc/greedy_nms.cu kMaxK: the removed set in shared memory
_launch_lock = threading.Lock()


def greedy_nms_reference(sup, init):
    """The plain version: ``keep = init``, then for i in order
    ``keep[:, i] &= not any(keep[:, j] & sup[:, j, i] for j < i)``."""
    keep = init.clone()
    for i in range(1, init.shape[1]):
        hit = (sup[:, :i, i] & keep[:, :i]).any(dim=1)
        keep[:, i] &= ~hit
    return keep


def greedy_nms(sup, init):
    """Greedy NMS over candidates already in score order.

    ``sup`` (B, K, K) bool: ``sup[b, j, i]`` says that candidate j, if
    kept, suppresses candidate i (only j < i is read).  ``init`` (B, K)
    bool: the candidates that may be kept at all.  Returns ``keep`` (B, K)
    bool with ``keep[b, i] = init[b, i] and not any(keep[b, j] and
    sup[b, j, i] for j < i)``.

    CPU tensors run :func:`greedy_nms_reference`, CUDA tensors the kernel
    (K up to :data:`MAX_K`), or it raises; ``meta`` tensors (symbolic shape
    inference) give an empty result of the right shape.
    """
    if sup.dim() != 3 or init.dim() != 2 or tuple(sup.shape) != (
            init.shape[0], init.shape[1], init.shape[1]):
        raise ValueError("greedy_nms takes sup (B, K, K) and init (B, K), "
                         "got %s and %s" % (tuple(sup.shape),
                                            tuple(init.shape)))
    if sup.dtype != torch.bool or init.dtype != torch.bool:
        raise TypeError("greedy_nms takes bool sup and init, got %s and %s"
                        % (sup.dtype, init.dtype))
    if sup.device != init.device:
        raise ValueError("sup and init on different devices: %s and %s"
                         % (sup.device, init.device))
    kind = sup.device.type
    if kind == "cpu":
        return greedy_nms_reference(sup, init)
    if kind == "meta":
        return torch.empty_like(init)
    if kind != "cuda":
        raise MXNetError("greedy_nms runs on CUDA or CPU tensors, got "
                         "device %s" % sup.device)
    return _greedy_nms_cuda(sup, init)


# kernel launches, counted where they happen
greedy_nms.launches = 0


def _greedy_nms_cuda(sup, init):
    B, K = init.shape
    if B < 1 or K < 1:
        return init.clone()
    if K > MAX_K:
        raise ValueError("greedy_nms kernel takes K <= %d candidates, got %d"
                         % (MAX_K, K))
    if not (sup.is_contiguous() and init.is_contiguous()):
        raise ValueError("greedy_nms kernel needs contiguous sup and init")
    from .. import _kernels
    lib = _kernels.load("greedy_nms")
    words = torch.empty((B, K, (K + 63) // 64), dtype=torch.int64,
                        device=sup.device)
    keep = torch.empty((B, K), dtype=torch.bool, device=sup.device)
    stream = torch.cuda.current_stream(sup.device).cuda_stream
    with torch.cuda.device(sup.device):
        err = lib.mxt_greedy_nms(sup.data_ptr(), init.data_ptr(),
                                 keep.data_ptr(), words.data_ptr(), B, K,
                                 stream)
    if err != 0:
        raise MXNetError("greedy_nms kernel launch failed: cudaError %d at "
                         "B %d K %d" % (err, B, K))
    if not torch.cuda.is_current_stream_capturing():
        with _launch_lock:
            greedy_nms.launches += 1
    return keep
