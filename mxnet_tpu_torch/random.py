"""The framework's seeded key (counterpart of ``mxnet_tpu/random.py``:
``seed``, ``next_key``, ``key_override`` and ``derived_numpy_rng``,
:19-89) and the random bits drawn from it.

One thread-local key of two ``uint32`` words, as ``jax.random.PRNGKey``
makes it: ``seed(n)`` sets it to ``(n >> 32, n & 0xFFFFFFFF)`` of the
seed as a 32-bit integer, and :func:`next_key` splits it, keeping the first
child and handing out the second.  The split is JAX's threefry2x32 under
``jax_threefry_partitionable`` (the default of the JAX versions the
reference runs on): child ``i`` of key ``k`` is ``threefry2x32(k, (0,
i))``, the counters an iota of 64-bit indices split into high and low
words.

Keys come in two forms.  On the host a key is a numpy ``uint32`` pair;
:func:`next_key` outside any override hands out such keys, so weights drawn
on the card equal those drawn on the CPU and :func:`derived_numpy_rng` is
the numpy stream the initializers and ``io.NDArrayIter`` draw from.  On the
card a key is an ``int32`` tensor of two elements holding the same bits:
a ``CachedOp`` copies each call's host key into such a buffer, the graph's
input, and :class:`key_override` of it makes every :func:`next_key` inside
the captured forward a :func:`split` in torch integer ops (made when a
draw first reads it), so each replay draws fresh bits without a host
round trip.  :func:`threefry2x32` and
:func:`split` take either form and give the same bits.

:func:`random_bits` is the partitionable ``_random_bits`` for 32-bit
draws: ``b0 ^ b1`` of the threefry of the flat index, in torch on the
device it is asked for.  Integer arithmetic runs on ``int32`` lanes holding
``uint32`` bits (addition wraps; right shifts are masked to be logical),
since torch's ``uint32`` lacks most CUDA ops; nothing syncs with the host,
so a draw runs inside a CUDA-graph capture.  The distributions over these
bits (``jax.random.uniform``, ``bernoulli``, ``normal``, ...) are in
``ops/random_ops.py``; ``mx.random.uniform`` and the other samplers resolve
to ``nd.random``'s, as in the JAX package (:62-65).
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch

__all__ = ["seed", "next_key", "key_override", "derived_numpy_rng",
           "prng_key", "split", "threefry2x32", "random_bits", "key_tensor",
           "device_of"]

_state = threading.local()
_DEFAULT_SEED = 0

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def _rotl(v, r):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def _i32(v):
    """A ``uint32`` word as the Python int of the same bits in ``int32``."""
    v = int(v) & _M32
    return v - (1 << 32) if v & 0x80000000 else v


def _threefry_numpy(key, x0, x1):
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _threefry_int(k0, k1, x0, x1):
    """The block function on one pair of counters, in Python ints (a host
    split is a few counters: numpy's per-call cost would be 10x this)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + k0) & _M32, (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _threefry_torch(key, x0, x1):
    """The block function on ``int32`` tensors: ``key`` an ``int32`` tensor
    of two words (on the counters' device) or two host words."""
    if isinstance(key, torch.Tensor):
        k0, k1 = key[0], key[1]
        ks = (k0, k1, k0 ^ k1 ^ _PARITY)
        inject = [(ks[(i + 2) % 3], i + 1) for i in range(5)]
    else:
        k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
        ks = (_i32(k0), _i32(k1), _i32(k0 ^ k1 ^ _PARITY))
        inject = [(_i32(ks[(i + 2) % 3] + i + 1), 0) for i in range(5)]
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            t = x1 >> (32 - r)
            t.bitwise_and_((1 << r) - 1)
            x1.bitwise_left_shift_(r).bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        k, c = inject[i]
        x1.add_(k)
        if c:
            x1.add_(c)
    return x0, x1


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (Random123; ``jax.random``'s block
    function) of the counters ``x0``, ``x1`` under ``key``; returns the two
    output words.  numpy ``uint32`` counters give numpy words; ``int32``
    tensors give ``int32`` tensors of the same bits, ``key`` then a device
    tensor or host words."""
    if isinstance(x0, torch.Tensor):
        return _threefry_torch(key, x0, x1)
    return _threefry_numpy(key, x0, x1)


class _DeviceKey:
    """A device key, or one split off another and made only when a draw
    reads it (:meth:`value`).  A captured forward takes a key for every
    active child block, as the JAX package's nested CachedOps do, and most
    children draw nothing: their splits are never launched."""

    __slots__ = ("_parent", "_index", "_value", "_children")

    def __init__(self, parent=None, index=0, value=None):
        self._parent, self._index = parent, index
        self._value, self._children = value, None

    def value(self):
        if self._value is None:
            self._value = self._parent._split()[self._index]
            self._parent = None
        return self._value

    def _split(self):
        if self._children is None:
            self._children = split(self.value())
        return self._children


def _resolve(key):
    return key.value() if isinstance(key, _DeviceKey) else key


def key_tensor(key, device):
    """``key`` (host words, or an ``int32`` key tensor) as an ``int32``
    tensor on ``device``; a copy only when it lies elsewhere."""
    key = _resolve(key)
    if isinstance(key, torch.Tensor):
        return key.to(device)
    words = np.asarray(key, np.uint32).view(np.int32).copy()
    return torch.from_numpy(words).to(device)


def prng_key(seed_state):
    """The key ``jax.random.PRNGKey(seed_state)`` makes, for a seed that fits
    32 bits, as two ``uint32`` words."""
    s = int(seed_state)
    if not -2 ** 31 <= s < 2 ** 31:
        raise OverflowError("seed %d does not fit a 32-bit integer" % s)
    return np.array([0, s & 0xFFFFFFFF], np.uint32)


def split(key, num=2):
    """``jax.random.split(key, num)`` under the partitionable threefry: a
    ``(num, 2)`` array of child keys, ``uint32`` for host words, an
    ``int32`` tensor on the key's device for a tensor key."""
    key = _resolve(key)
    if isinstance(key, torch.Tensor):
        lo = torch.arange(num, dtype=torch.int32, device=key.device)
        b0, b1 = _threefry_torch(key, torch.zeros_like(lo), lo)
        return torch.stack([b0, b1], dim=1)
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    return np.array([_threefry_int(k0, k1, i >> 32, i & _M32)
                     for i in range(num)], np.uint32).reshape(num, 2)


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
    :class:`key_override`'s, in that key's form)."""
    base = getattr(_state, "override", None)
    if base is not None:
        if isinstance(base, np.ndarray):
            children = split(base)
            _state.override = children[0]
            return children[1]
        if isinstance(base, torch.Tensor):
            base = _DeviceKey(value=base)
        _state.override = _DeviceKey(base, 0)
        return _DeviceKey(base, 1)
    key, sub = split(_get())
    _state.key = key
    return sub


class key_override:
    """Scope in which :func:`next_key` splits from ``base`` (two ``uint32``
    words, or an ``int32`` device tensor) instead of this thread's key."""

    def __init__(self, base):
        self._base = base if isinstance(base, (torch.Tensor, _DeviceKey)) \
            else np.asarray(base, np.uint32)
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
    key = _resolve(next_key())
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy().view(np.uint32)
    return np.random.RandomState(key)


# ---------------------------------------------------------------------------
# the draws (``jax.random``)

def device_of(key, device=None):
    """Where a draw goes: ``device``, else a device key's device, else the
    current context."""
    from .context import resolve_device
    if device is None and isinstance(key, (torch.Tensor, _DeviceKey)):
        return _resolve(key).device
    return resolve_device(device)


def random_bits(key, shape, device=None):
    """``jax.random.bits(key, shape, uint32)``: 32 random bits an element,
    as ``int32`` of the same bits (the partitionable ``_random_bits``: the
    threefry of the flat index, ``b0 ^ b1``)."""
    key = _resolve(key)
    device = device_of(key, device)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int32, device=device)
    if isinstance(key, torch.Tensor):
        key = key.to(device)
    b0, b1 = _threefry_torch(key, torch.zeros_like(lo), lo)
    return b0.bitwise_xor_(b1).reshape(shape)


def __getattr__(name):
    # ``mx.random.uniform`` and the other samplers live in ndarray/random.py
    if name.startswith("__"):
        raise AttributeError(name)
    from .ndarray import random as _ndrandom
    return getattr(_ndrandom, name)
