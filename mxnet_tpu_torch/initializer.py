"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``).

Only what the ported models use: :class:`Xavier` (uniform, ``avg``,
magnitude 3), :class:`Zero` and :class:`One`; BatchNorm's running
statistics are reset to 0 (mean) and 1 (variance), as the JAX package's
initializers reset them.  Draws come from a
``torch.Generator`` the caller seeds; they are made on the CPU and copied
to the parameter's device, so a seed gives the same weights on every
device.  The JAX package draws from its own RNG, so the same seed does not
give the same numbers there: to compare the two, carry the JAX weights
across with ``convert.load_mxnet_params`` instead.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Initializer", "Xavier", "Zero", "One", "initialize"]


class Initializer:
    """Fills a parameter or buffer by its name's suffix, as the JAX package
    does: ``weight`` -> :meth:`_init_weight`, ``bias``/``beta``/
    ``running_mean`` -> 0, ``gamma``/``running_var`` -> 1."""

    def __call__(self, name, param, generator):
        with torch.no_grad():
            if name.endswith("weight"):
                self._init_weight(name, param, generator)
            elif name.endswith(("bias", "beta", "running_mean")):
                param.zero_()
            elif name.endswith(("gamma", "running_var")):
                param.fill_(1.0)
            else:
                raise ValueError(
                    "Unknown initialization pattern for %s: parameter names "
                    "end in weight, bias, gamma, beta, running_mean or "
                    "running_var" % name)

    def _init_weight(self, name, param, generator):
        raise NotImplementedError("must override _init_weight")


class Zero(Initializer):
    def _init_weight(self, name, param, generator):
        param.zero_()


class One(Initializer):
    def _init_weight(self, name, param, generator):
        param.fill_(1.0)


class Xavier(Initializer):
    """Uniform on [-s, s], s = sqrt(3 / fan_avg): the JAX ``Xavier``'s
    defaults (``uniform``, ``avg``, magnitude 3), the only ones the ported
    models use.  A weight stored permuted (a channel-last convolution's,
    whose ``init_perm`` says how) is drawn in canonical order and fans,
    then permuted, as the JAX package draws it."""

    def _init_weight(self, name, param, generator):
        perm = getattr(param, "init_perm", None)
        shape = tuple(param.shape)
        if perm is not None:
            canonical = [0] * len(shape)
            for stored_axis, axis in enumerate(perm):
                canonical[axis] = shape[stored_axis]
            shape = tuple(canonical)
        if len(shape) < 2:
            raise ValueError("Xavier initializer cannot be applied to vector "
                             "%s" % name)
        hw_scale = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        scale = math.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
        draw = torch.rand(shape, generator=generator) * (2 * scale) - scale
        param.copy_(draw if perm is None else draw.permute(perm))


def initialize(module, init=None, *, generator):
    """Fill every parameter and buffer of ``module``
    (``Block.initialize``'s counterpart).  ``init`` defaults to
    :class:`Xavier`; ``generator`` is the caller's seeded CPU
    ``torch.Generator``."""
    init = Xavier() if init is None else init
    for name, param in module.named_parameters():
        init(name, param, generator)
    for name, buf in module.named_buffers():
        init(name, buf, generator)
    return module
