"""Automatic naming (counterpart of ``mxnet_tpu/name.py``:
``NameManager``, ``Prefix`` and ``current``).

A top-level Gluon block with no ``prefix`` takes the next name for its
hint from this thread's manager (``resnetv10_``, ``resnetv11_``, ...), as
in the JAX package; the counters are the port's own, so the numbers count
the blocks this process built with the port.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]


class NameManager:
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        """``name`` if given, else the next auto-name for ``hint``
        (``hint0``, ``hint1``, ...)."""
        if name:
            return name
        seq = self._counter.get(hint, 0)
        self._counter[hint] = seq + 1
        return "%s%d" % (hint, seq)

    def __enter__(self):
        self._old_manager = current()
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager


class Prefix(NameManager):
    """A manager that puts ``prefix`` before every name it gives."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current():
    """This thread's innermost manager."""
    if not hasattr(NameManager._current, "value"):
        NameManager._current.value = NameManager()
    return NameManager._current.value
