"""Contrib samplers (counterpart of ``mxnet_tpu/gluon/contrib/data``).
``text`` (WikiText) waits for ``contrib/text``, ROADMAP queue 1 #9."""
from .sampler import IntervalSampler

__all__ = ["IntervalSampler"]
