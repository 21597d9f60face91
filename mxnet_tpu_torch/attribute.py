"""Attribute scoping (counterpart of ``mxnet_tpu/attribute.py``: AttrScope).

Used by the symbolic API to attach attributes (e.g. ``ctx_group`` for manual
model parallelism, ``__layout__``) to symbols created within a scope.  The
port records them in the graph and its JSON; nothing places ops by them
yet (model parallelism is not ported)."""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("Attributes need to be string")
        self._attr = kwargs

    def get(self, attr=None):
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        # nested scopes stack: our attrs override the enclosing scope's,
        # which we fold in so lookups see the whole chain
        outer = AttrScope._get_current()
        self._old_scope = outer
        merged = dict(outer._attr)
        merged.update(self._attr)
        self._attr = merged
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope

    @staticmethod
    def _get_current():
        if not hasattr(AttrScope._current, "value"):
            AttrScope._current.value = AttrScope()
        return AttrScope._current.value


AttrScope._current.value = AttrScope()


def current():
    if not hasattr(AttrScope._current, "value"):
        AttrScope._current.value = AttrScope()
    return AttrScope._current.value
