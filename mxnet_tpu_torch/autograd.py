"""Recording and training scopes, and gradients of NDArrays (counterpart
of ``mxnet_tpu/autograd.py``: ``record``/``pause``/``train_mode``/
``predict_mode``, :45-105; ``mark_variables`` :181, ``backward`` :323,
``grad`` :400).

The JAX package keeps its own tape (``TapeNode``); here torch's autograd
is the tape, and the module keeps two thread-local flags:

- *recording*: inside :func:`record` ops build the graph that
  ``loss.backward()`` walks (torch's grad mode on), inside :func:`pause`
  they do not (grad mode off).  Each scope puts torch's grad mode back as
  it found it on exit;
- *training*: layers that act differently in training read
  :func:`is_training`; of the ported layers, ``BatchNorm`` does (batch
  statistics and their running fold in training, the running statistics
  otherwise).

Gradients of Gluon parameters land in each parameter's ``.grad``, where
``gluon.Trainer`` reads them; the Trainer makes each backward overwrite
them, as Gluon's ``grad_req='write'`` does.

An NDArray that takes gradients (``attach_grad``, :func:`mark_variables`)
holds a leaf tensor with a hook that, after torch stores the leaf's
gradient, takes it off the leaf and hands it to the NDArray's ``grad``:
written with ``grad_req='write'``, added with ``'add'``.  An NDArray's
buffer is swapped on mutation, and each new buffer is a new leaf with the
same hook, so a backward reaches the array whichever of its buffers the
graph saved; gradients that reach it through several of them in one
:func:`backward` are summed first, then written once.  Torch's own
``.grad`` of those leaves never accumulates.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad"]

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


# ---------------------------------------------------------------------------
# gradients of NDArrays

# one NDArray backward at a time; while it runs, _received collects what
# the leaf hooks hand over (they may run on torch's device threads)
_BACKWARD_LOCK = threading.Lock()
_received = None


def _grad_hook(array_ref):
    def hook(leaf):
        g, leaf.grad = leaf.grad, None
        arr = array_ref()
        if arr is None or g is None:
            return
        received = _received
        if received is None:   # a backward run on the tensors directly
            arr._take_grad(g)
            return
        entry = received.get(id(arr))
        if entry is None:
            received[id(arr)] = [arr, g]
        else:
            entry[1] = entry[1] + g
    return hook


def leaf_for(array, value):
    """``value`` as a leaf tensor whose gradient goes to the NDArray
    ``array``."""
    leaf = value.detach().requires_grad_(True)
    leaf.register_post_accumulate_grad_hook(_grad_hook(weakref.ref(array)))
    return leaf


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each NDArray of ``variables`` take gradients into the NDArray
    beside it in ``gradients``, by ``grad_reqs`` (``"write"``, ``"add"``
    or ``"null"``; one for all or one each)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        var.grad = g
        var._grad_req = req
        if req != "null":
            var._data = leaf_for(var, var._data)


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    tensors, grads = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            raise MXNetError("cannot differentiate a head that was not "
                             "computed under autograd.record()")
        tensors.append(t)
        grads.append(torch.ones_like(t) if hg is None else hg._data)
    return tensors, grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (NDArrays; ``head_grads`` default to ones)
    into the ``grad`` of every NDArray that takes them, and into Gluon
    parameters' ``.grad``.  ``train_mode`` is accepted for API parity: no
    ported op's gradient depends on it."""
    global _received
    tensors, grads = _heads(heads, head_grads)
    with _BACKWARD_LOCK:
        _received = {}
        try:
            torch.autograd.backward(tensors, grads,
                                    retain_graph=retain_graph)
            received = _received
        finally:
            _received = None
    for arr, g in received.values():
        arr._take_grad(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to the NDArrays ``variables``,
    as new NDArrays; nothing is written to ``.grad``.  With
    ``create_graph`` they can be differentiated again."""
    from .ndarray.ndarray import NDArray

    if isinstance(variables, NDArray):
        variables = [variables]
    tensors, grads = _heads(heads, head_grads)
    got = torch.autograd.grad(tensors, [v._data for v in variables], grads,
                              retain_graph=retain_graph,
                              create_graph=create_graph, allow_unused=True)
    if any(g is None for g in got):
        raise MXNetError("one of the variables does not participate in the "
                         "computation of heads")
    return [NDArray(g) for g in got]
