"""Transient-retry envelope (counterpart of ``mxnet_tpu/util.py:49``).

The serving registry and the decode engine wrap each execution in
:func:`retry`, so that a transient failure costs latency instead of a
failed batch.  The retryable class is ``faults.TransientFault`` unless the
caller names others (``retryable=``); it is re-exported here as the JAX
package's ``util`` does.
"""
from __future__ import annotations

import functools
import random as _random
import time as _time

from .faults import TransientFault

__all__ = ["TransientFault", "retry"]

# instance RNG (not the global random module): jitter draws must not
# perturb seeded streams
_JITTER_RNG = _random.Random(0x5EED)


def retry(attempts=3, backoff=0.01, jitter=0.5, retryable=None,
          on_retry=None):
    """Decorator: re-run the wrapped callable on a retryable failure.

    ``attempts`` total tries; sleep ``backoff * 2**i`` with up to ``jitter``
    fractional randomization between tries.  ``retryable`` is an exception
    class or a tuple of them (default :class:`TransientFault`).  ``on_retry(exc, attempt)`` is
    called before each re-try.  The last failure re-raises
    unchanged once attempts are exhausted.
    """
    if attempts < 1:
        raise ValueError("retry needs attempts >= 1, got %r" % attempts)

    kinds = TransientFault if retryable is None else retryable

    def decorate(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            for attempt in range(attempts):
                try:
                    return fn(*args, **kwargs)
                except kinds as exc:
                    if attempt == attempts - 1:
                        raise
                    if on_retry is not None:
                        on_retry(exc, attempt)
                    delay = backoff * (2 ** attempt)
                    if jitter:
                        delay *= 1.0 + jitter * _JITTER_RNG.random()
                    if delay > 0:
                        _time.sleep(delay)
        return wrapped
    return decorate
