"""Elementwise, scalar and broadcast binary ops (a subset of
``mxnet_tpu/ops/elemwise.py``): the binary broadcast ops of ``_BINARY``
(:217-239) and their aliases (:240-252), the scalar ops of ``_SCALAR``
(:170-188), the unary ops that ``NDArray``'s methods call, ``Cast``,
``zeros_like``, ``ones_like``, ``BlockGrad`` and ``make_loss``.

Comparisons and logical ops return their first input's dtype, as there.
A scalar op keeps its array's dtype, as in MXNet: an int32 array plus 1 is
int32, and an integer array takes the integer part of a float scalar.
"""
from __future__ import annotations

import torch

from .registry import alias, register

__all__ = []


def _round(x):
    # n.5 away from zero (mshadow_op.h), not torch's ties-to-even
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


_UNARY = {
    "abs": torch.abs,
    "sign": torch.sign,
    "round": _round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "log": torch.log,
    "tanh": torch.tanh,
    "negative": torch.neg,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _make_unary(name, fn):
    @register(name)
    def _op(attrs, x, _fn=fn):
        return _fn(x)


for _name, _fn in _UNARY.items():
    _make_unary(_name, _fn)

alias("_copy", "identity")


@register("BlockGrad", no_grad="blocks-gradient")
def _block_grad(attrs, x):
    return x.detach()


alias("stop_gradient", "BlockGrad")


@register("make_loss")
def _make_loss(attrs, x):
    return x


@register("Cast")
def _cast(attrs, x):
    from ..ndarray.ndarray import torch_dtype
    return x.to(torch_dtype(attrs.get("dtype", "float32")))


alias("cast", "Cast")


@register("zeros_like")
def _zeros_like(attrs, x):
    return torch.zeros_like(x)


@register("ones_like")
def _ones_like(attrs, x):
    return torch.ones_like(x)


def _as(a, b):
    """The boolean ``b`` in ``a``'s dtype."""
    return b.to(a.dtype)


# ---------------------------------------------------------------------------
# scalar ops (src/operator/tensor/elemwise_binary_scalar_op_basic.cc)

_SCALAR = {
    "_plus_scalar": lambda a, b: a + b,
    "_minus_scalar": lambda a, b: a - b,
    "_mul_scalar": lambda a, b: a * b,
    "_div_scalar": lambda a, b: a / b,
    "_mod_scalar": torch.remainder,
    "_power_scalar": torch.pow,
    "_maximum_scalar": torch.maximum,
    "_minimum_scalar": torch.minimum,
    "_hypot_scalar": torch.hypot,
    "_equal_scalar": lambda a, b: a == b,
    "_not_equal_scalar": lambda a, b: a != b,
    "_greater_scalar": lambda a, b: a > b,
    "_greater_equal_scalar": lambda a, b: a >= b,
    "_lesser_scalar": lambda a, b: a < b,
    "_lesser_equal_scalar": lambda a, b: a <= b,
    "_logical_and_scalar": lambda a, b: (a != 0) & (b != 0),
    "_logical_or_scalar": lambda a, b: (a != 0) | (b != 0),
    "_logical_xor_scalar": lambda a, b: (a != 0) ^ (b != 0),
}
# functions that take no Python number
_TENSOR_ARGS = {torch.maximum, torch.minimum, torch.hypot}


def _make_scalar(name, fn):
    @register(name)
    def _op(attrs, x, _fn=fn):
        s = attrs.get("scalar", 1.0)
        if not x.is_floating_point():
            s = int(s)
        reverse = attrs.get("reverse", False)
        if reverse or _fn in _TENSOR_ARGS:
            # a number on the left has no derivative in torch
            s = torch.full((), s, dtype=x.dtype, device=x.device)
        out = _fn(s, x) if reverse else _fn(x, s)
        return out if out.dtype == x.dtype else out.to(x.dtype)


for _name, _fn in _SCALAR.items():
    _make_scalar(_name, _fn)


# ---------------------------------------------------------------------------
# binary elementwise and broadcast (elemwise_* are broadcast_* here, as in
# the JAX package)

_BINARY = {
    "broadcast_add": lambda a, b: a + b,
    "broadcast_sub": lambda a, b: a - b,
    "broadcast_mul": lambda a, b: a * b,
    "broadcast_div": lambda a, b: a / b,
    "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_hypot": torch.hypot,
    "broadcast_equal": lambda a, b: _as(a, a == b),
    "broadcast_not_equal": lambda a, b: _as(a, a != b),
    "broadcast_greater": lambda a, b: _as(a, a > b),
    "broadcast_greater_equal": lambda a, b: _as(a, a >= b),
    "broadcast_lesser": lambda a, b: _as(a, a < b),
    "broadcast_lesser_equal": lambda a, b: _as(a, a <= b),
    "broadcast_logical_and": lambda a, b: _as(a, (a != 0) & (b != 0)),
    "broadcast_logical_or": lambda a, b: _as(a, (a != 0) | (b != 0)),
    "broadcast_logical_xor": lambda a, b: _as(a, (a != 0) ^ (b != 0)),
    "arctan2": torch.atan2,
    "ldexp": lambda a, b: torch.ldexp(a, b.to(torch.int32)),
}


def _make_binary(name, fn):
    @register(name)
    def _op(attrs, a, b, _fn=fn):
        return _fn(a, b)


for _name, _fn in _BINARY.items():
    _make_binary(_name, _fn)

for _new, _old in (("elemwise_add", "broadcast_add"),
                   ("elemwise_sub", "broadcast_sub"),
                   ("elemwise_mul", "broadcast_mul"),
                   ("elemwise_div", "broadcast_div"),
                   ("_plus", "broadcast_add"), ("_sub", "broadcast_sub"),
                   ("_mul", "broadcast_mul"), ("_div", "broadcast_div"),
                   ("_maximum", "broadcast_maximum"),
                   ("_minimum", "broadcast_minimum"),
                   ("_power", "broadcast_power"),
                   ("maximum", "broadcast_maximum"),
                   ("minimum", "broadcast_minimum")):
    alias(_new, _old)
