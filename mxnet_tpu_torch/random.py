"""The framework's seeded key (counterpart of ``mxnet_tpu/random.py``:
``seed``, ``next_key``, ``key_override`` and ``derived_numpy_rng``,
:19-89).

One thread-local key of two ``uint32`` words, as ``jax.random.PRNGKey``
makes it: ``seed(n)`` sets it to ``(n >> 32, n & 0xFFFFFFFF)`` of the
seed as a 32-bit integer, and :func:`next_key` splits it, keeping the first
child and handing out the second.  The split is JAX's threefry2x32 under
``jax_threefry_partitionable`` (the default of the JAX versions the
reference runs on): child ``i`` of key ``k`` is ``threefry2x32(k, (0,
i))``, the counters an iota of 64-bit indices split into high and low
words.  Both are written here in numpy ``uint32`` arithmetic, so the same
``seed(n)`` gives the JAX package's keys, and :func:`derived_numpy_rng`
the same numpy stream the initializers and ``io.NDArrayIter`` draw from.
The keys live on the host, so weights drawn on the card equal those drawn
on the CPU.

The random *ops* (``nd.random.*``, ``Dropout``'s mask) do not draw from
this key yet: they use torch's generator until the port of the random ops.
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["seed", "next_key", "key_override", "derived_numpy_rng",
           "prng_key", "split", "threefry2x32"]

_state = threading.local()
_DEFAULT_SEED = 0

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (Random123; ``jax.random``'s block
    function) of the counters ``x0``, ``x1`` (``uint32`` arrays) under
    ``key`` (two ``uint32`` words); returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed_state):
    """The key ``jax.random.PRNGKey(seed_state)`` makes, for a seed that fits
    32 bits, as two ``uint32`` words."""
    s = int(seed_state)
    if not -2 ** 31 <= s < 2 ** 31:
        raise OverflowError("seed %d does not fit a 32-bit integer" % s)
    return np.array([0, s & 0xFFFFFFFF], np.uint32)


def split(key, num=2):
    """``jax.random.split(key, num)`` under the partitionable threefry: a
    ``(num, 2)`` ``uint32`` array of child keys."""
    counters = np.arange(num, dtype=np.uint64)
    hi = (counters >> np.uint64(32)).astype(np.uint32)
    lo = (counters & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=1)


def _get():
    if not hasattr(_state, "key"):
        _state.key = prng_key(_DEFAULT_SEED)
    return _state.key


def seed(seed_state, ctx="all"):
    """Seed this thread's key (``mx.random.seed``); ``ctx`` is accepted for
    API parity: the key is one for every device."""
    _state.key = prng_key(seed_state)


def next_key():
    """A fresh key split off this thread's key (or off the innermost
    :class:`key_override`'s)."""
    if getattr(_state, "override", None) is not None:
        _state.override, sub = split(_state.override)
        return sub
    key, sub = split(_get())
    _state.key = key
    return sub


class key_override:
    """Scope in which :func:`next_key` splits from ``base`` (two ``uint32``
    words) instead of this thread's key."""

    def __init__(self, base):
        self._base = np.asarray(base, np.uint32)
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_state, "override", None)
        _state.override = self._base
        return self

    def __exit__(self, *a):
        _state.override = self._prev


def derived_numpy_rng():
    """A numpy ``RandomState`` seeded with both words of a fresh
    :func:`next_key`: the stream the initializers and the shuffling
    iterators draw from, so ``seed(n)`` makes them reproducible."""
    return np.random.RandomState(next_key())
