"""Contrib samplers (counterpart of
``mxnet_tpu/gluon/contrib/data/sampler.py``)."""
from __future__ import annotations

from ...data.sampler import Sampler


class IntervalSampler(Sampler):
    """Sample elements with a fixed stride, wrapping through all offsets.

    length=6, interval=3 yields 0,3,1,4,2,5 (rollover=True) or just
    0,3 (rollover=False) — the reference's truncated-BPTT batching helper."""

    def __init__(self, length, interval, rollover=True):
        if interval > length:
            raise ValueError("interval %d must not be larger than length %d"
                             % (interval, length))
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for offset in range(self._interval if self._rollover else 1):
            for i in range(offset, self._length, self._interval):
                yield i

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
