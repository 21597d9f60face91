"""Devices (counterpart of ``mxnet_tpu/context.py``).

A context is a ``torch.device``.  ``gpu(i)`` is ``cuda:i``; the default
device is ``cuda:0``, and asking for it without a CUDA device raises rather
than falling back to the CPU.  The CPU is used only when a caller names it
(``device="cpu"``).  ``tpu()`` raises: this package runs on NVIDIA cards.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "tpu", "current_context", "resolve_device"]


def cpu(device_id=0):
    """The host CPU (``device_id`` is accepted for API parity and ignored)."""
    return torch.device("cpu")


def gpu(device_id=0):
    """The ``device_id``-th CUDA card."""
    return torch.device("cuda", device_id)


def tpu(device_id=0):
    raise MXNetError(
        "mxnet_tpu_torch runs on NVIDIA GPUs; use gpu(%d) (cuda:%d), or the "
        "JAX package mxnet_tpu for a TPU" % (device_id, device_id))


def current_context():
    """The default device: ``cuda:0``.  Raises when CUDA is absent."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return gpu(0)


def resolve_device(device=None):
    """``device`` as a ``torch.device``; None means :func:`current_context`."""
    if device is None:
        return current_context()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("device %s requested but no CUDA device is "
                         "available" % device)
    return device
