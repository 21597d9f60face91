"""Transient-retry envelope (counterpart of ``mxnet_tpu/util.py:49``).

The serving registry wraps each batch execution in :func:`retry`, so that a
transient failure costs latency instead of a failed batch.  The JAX
package's default retryable class is ``faults.TransientFault``; until the
fault-injection module is ported, :class:`TransientFault` lives here.
"""
from __future__ import annotations

import functools
import random as _random
import time as _time

from .base import MXNetError

__all__ = ["TransientFault", "retry"]

# instance RNG (not the global random module): jitter draws must not
# perturb seeded streams
_JITTER_RNG = _random.Random(0x5EED)


class TransientFault(MXNetError):
    """A retryable failure (flaky transfer, worker blip)."""


def retry(attempts=3, backoff=0.01, jitter=0.5, on_retry=None):
    """Decorator: re-run the wrapped callable on a :class:`TransientFault`.

    ``attempts`` total tries; sleep ``backoff * 2**i`` with up to ``jitter``
    fractional randomization between tries.  ``on_retry(exc, attempt)`` is
    called before each re-try.  The last failure re-raises
    unchanged once attempts are exhausted.
    """
    if attempts < 1:
        raise ValueError("retry needs attempts >= 1, got %r" % attempts)

    def decorate(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            for attempt in range(attempts):
                try:
                    return fn(*args, **kwargs)
                except TransientFault as exc:
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
