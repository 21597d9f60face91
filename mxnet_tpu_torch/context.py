"""Devices (counterpart of ``mxnet_tpu/context.py``).

A context is a ``torch.device``.  ``gpu(i)`` is ``cuda:i``; the default
device is ``cuda:0``, and asking for it without a CUDA device raises rather
than falling back to the CPU.  The CPU is used only when a caller names it
(``device="cpu"``, ``ctx=mx.cpu()``) or opens a ``with mx.cpu():`` scope.
``tpu()`` raises: this package runs on NVIDIA cards.  ``cpu_pinned()``
(devtype 3, as ``mxnet_tpu/context.py:25-26``) names page-locked host
memory, where the input pipeline stages batches for the copy to the card
(``io.device_feed.stage_batch``); arrays placed there are CPU tensors.

Scopes: ``with mx.gpu(0):`` and ``with mx.cpu():`` are torch's own device
scopes (``torch.device`` is a context manager: a ``DeviceContext`` mode on
this thread's torch-function stack, which also sends torch's factory calls
inside it to that device).  :func:`current_context` returns the innermost
such scope's device on this thread, as the reference's
``Context.__enter__`` sets ``Context._default_ctx`` (:22-60).
"""
from __future__ import annotations

import torch
from torch.overrides import _get_current_function_mode_stack
from torch.utils._device import DeviceContext

from .base import MXNetError

__all__ = ["cpu", "gpu", "tpu", "cpu_pinned", "PinnedCPU",
           "current_context", "resolve_device"]


def cpu(device_id=0):
    """The host CPU (``device_id`` is accepted for API parity and ignored)."""
    return torch.device("cpu")


class PinnedCPU:
    """The ``cpu_pinned`` context: host tensors in page-locked memory
    (``Tensor.pin_memory()``), from which a copy to the card runs
    asynchronously.  Its ``device`` is the CPU."""

    device_type, device_typeid = "cpu_pinned", 3
    device = torch.device("cpu")

    def __init__(self, device_id=0):
        self.device_id = device_id

    def __eq__(self, other):
        return isinstance(other, PinnedCPU) and \
            other.device_id == self.device_id

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return "cpu_pinned(%d)" % self.device_id


def cpu_pinned(device_id=0):
    """Page-locked host memory (:class:`PinnedCPU`)."""
    return PinnedCPU(device_id)


def gpu(device_id=0):
    """The ``device_id``-th CUDA card."""
    return torch.device("cuda", device_id)


def tpu(device_id=0):
    raise MXNetError(
        "mxnet_tpu_torch runs on NVIDIA GPUs; use gpu(%d) (cuda:%d), or the "
        "JAX package mxnet_tpu for a TPU" % (device_id, device_id))


def _scoped_device():
    """The device of the innermost ``with <torch.device>:`` scope open on
    this thread, or None."""
    for mode in reversed(_get_current_function_mode_stack()):
        if isinstance(mode, DeviceContext):
            return mode.device
    return None


def current_context():
    """The device of the innermost ``with mx.cpu():``/``with mx.gpu(i):``
    scope on this thread; with none open, ``cuda:0``.  Raises when that is
    a CUDA device and CUDA is absent."""
    return resolve_device(_scoped_device() or gpu(0))


def resolve_device(device=None):
    """``device`` as a ``torch.device``; None means :func:`current_context`."""
    if device is None:
        return current_context()
    if isinstance(device, PinnedCPU):
        return device.device
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("device %s requested but no CUDA device is "
                         "available; pass device='cpu' to run on the CPU "
                         "explicitly" % device)
    return device
