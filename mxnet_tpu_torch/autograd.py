"""Recording and training scopes (counterpart of ``mxnet_tpu/autograd.py``
``record``/``pause``/``train_mode``/``predict_mode``, :45-105).

The JAX package keeps its own tape (``TapeNode``) and ``backward``; here
torch's autograd is the tape, so only the two thread-local flags remain:

- *recording*: inside :func:`record` ops build the graph that
  ``loss.backward()`` walks (torch's grad mode on), inside :func:`pause`
  they do not (grad mode off).  Each scope puts torch's grad mode back as
  it found it on exit;
- *training*: layers that act differently in training read
  :func:`is_training`; of the ported layers, ``BatchNorm`` does (batch
  statistics and their running fold in training, the running statistics
  otherwise).

Gradients then land in each parameter's ``.grad``, where ``gluon.Trainer``
reads them; the Trainer makes each backward overwrite them, as Gluon's
``grad_req='write'`` does.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training"]

_STATE = threading.local()


def is_recording():
    """Whether this thread is inside :func:`record` (and not paused)."""
    return getattr(_STATE, "recording", False)


def is_training():
    """Whether layers run in training mode on this thread."""
    return getattr(_STATE, "training", False)


def set_recording(is_record):
    """Turn recording, and torch's grad mode with it, on or off; returns
    the previous recording state."""
    prev = is_recording()
    _STATE.recording = is_record
    torch.set_grad_enabled(is_record)
    return prev


def set_training(train_mode_):
    """Turn training mode on or off; returns the previous state."""
    prev = is_training()
    _STATE.training = train_mode_
    return prev


class _RecordingStateScope:
    """Sets the two flags on entry (None leaves one as it is) and restores
    them on exit."""

    def __init__(self, is_record, train_mode_):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode_
        self._prev_is_record = None
        self._prev_grad_mode = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_grad_mode = torch.is_grad_enabled()
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)
        return self

    def __exit__(self, *args):
        if self._enter_is_record is not None:
            _STATE.recording = self._prev_is_record
            torch.set_grad_enabled(self._prev_grad_mode)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode=True):
    """Scope in which executed ops are recorded for ``backward()``."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Scope in which nothing is recorded."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    """Scope in training mode; recording is left as it is."""
    return _RecordingStateScope(None, True)


def predict_mode():
    """Scope in prediction mode; recording is left as it is."""
    return _RecordingStateScope(None, False)
