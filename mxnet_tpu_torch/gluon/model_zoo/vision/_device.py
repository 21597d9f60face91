"""The device scope the zoo's constructors build in."""
from __future__ import annotations

import contextlib

from ....context import resolve_device


@contextlib.contextmanager
def device_scope(device):
    """Build inside ``device``'s scope (``with mx.cpu():``/``mx.gpu(i)``),
    so that every layer's tensors are made there; ``None`` keeps the
    current context."""
    if device is None:
        yield
        return
    with resolve_device(device):
        yield
