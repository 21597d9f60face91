"""Parameters (counterpart of ``mxnet_tpu/gluon/parameter.py``).

A parameter is a ``torch.nn.Parameter``; only ``Parameter.cast``
(:343-353) is ported, as :func:`cast`.  The rest of that module (deferred
shapes, ``ParameterDict``) waits for its port.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..base import as_dtype

__all__ = ["cast", "watch_cast"]

# per parameter, the live objects whose hook() runs after a cast changes its
# dtype (keys and values held weakly)
_cast_watchers = WeakIdKeyDictionary()


def watch_cast(param, watcher):
    """Call ``watcher.hook()`` each time :func:`cast` changes ``param``'s
    dtype, for as long as ``watcher`` lives."""
    _cast_watchers.setdefault(param, weakref.WeakSet()).add(watcher)


def cast(param, dtype):
    """Change ``param``'s data, and its gradient where it has one, to
    ``dtype``, keeping the same ``nn.Parameter`` object: a Trainer built
    before the cast still holds it.  Torch gives a parameter whose dtype
    changes a new gradient accumulator, so the Trainer's gradient-write
    hooks are set again on that one (:func:`watch_cast`)."""
    dtype = as_dtype(dtype)
    if param.dtype == dtype:
        return param
    with torch.no_grad():
        param.data = param.data.to(dtype)
        if param.grad is not None:
            param.grad = param.grad.to(dtype)
    for watcher in list(_cast_watchers.get(param, ())):
        watcher.hook()
    return param
