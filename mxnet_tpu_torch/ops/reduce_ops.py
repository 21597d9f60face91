"""Reductions (counterpart of ``mxnet_tpu/ops/reduce_ops.py``): the
``_REDUCE`` table (:44-52) with ``sum_axis``/``max_axis``/``min_axis``,
``_square_sum`` (:62), ``norm`` (:69), ``argmax`` (:84), ``argmin``
(:98), ``argmax_channel`` (:112) and ``pick`` (:118).

MXNet 1.3's conventions, as there: reducing every axis gives shape (1,),
not a 0-d array; ``argmax`` returns float32 indices; ``mean`` of an
integer array is float32, as ``jnp.mean`` gives it.

One deliberate divergence: ``exclude=True`` with a negative ``axis``.
The port normalises the axis first, so ``sum(x, axis=-1, exclude=True)``
on shape (2, 3, 4) reduces axes 0 and 1 and gives shape (4,), as MXNet and
numpy do.  The JAX package compares the raw axis with ``range(ndim)``
(``mxnet_tpu/ops/reduce_ops.py:33-36``), so it reduces every axis there.
Non-negative axes agree.

Integer and bool inputs sum and multiply as the JAX package's do without
x64: into int32, or uint32 for an unsigned input, wrapping as XLA's
integer arithmetic wraps (``_integral``).
"""
from __future__ import annotations

import torch

from .registry import alias, register

__all__ = ["pick"]


def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """``axis`` (None, an int or a tuple) as a tuple of dims of ``x``."""
    if axis is None:
        return tuple(range(x.dim()))
    axis = (axis,) if isinstance(axis, int) else axis
    return tuple(a % x.dim() for a in axis)


def _over(fn):
    """A reduction that torch takes over one dim, over several: the dims
    moved last and merged."""
    def reduce(x, dims, keepdim):
        rest = [d for d in range(x.dim()) if d not in dims]
        merged = x.permute(*rest, *dims).reshape(
            [x.shape[d] for d in rest] + [-1])
        out = fn(merged, -1)
        if keepdim:
            out = out.reshape([1 if d in dims else x.shape[d]
                               for d in range(x.dim())])
        return out
    return reduce


def _nanprod(x, dim):
    return torch.where(torch.isnan(x), torch.ones_like(x), x).prod(dim)


def _integral(fn):
    """``fn`` with ``jnp.sum``'s and ``jnp.prod``'s result types for an
    integer or bool input: int32, uint32 for an unsigned one.  The work runs
    in int64 (torch's default for them, modular past its range) and the
    result keeps its low 32 bits, which modular arithmetic makes the same
    as XLA's wrapped int32 or uint32 in any order of the sum."""
    def reduce(x, d, k):
        if x.is_floating_point() or x.is_complex():
            return fn(x, d, k)
        out = fn(x.to(torch.int64), d, k)
        if x.dtype in (torch.uint8, torch.uint16, torch.uint32):
            return (out & 0xFFFFFFFF).to(torch.uint32)
        return out.to(torch.int32)
    return reduce


_REDUCE = {
    "sum": _integral(lambda x, d, k: torch.sum(x, dim=d, keepdim=k)),
    "mean": lambda x, d, k: torch.mean(
        x if x.is_floating_point() else x.to(torch.float32), dim=d,
        keepdim=k),
    "prod": _integral(_over(torch.prod)),
    "nansum": _integral(lambda x, d, k: torch.nansum(x, dim=d, keepdim=k)),
    "nanprod": _integral(_over(_nanprod)),
    "max": lambda x, d, k: torch.amax(x, dim=d, keepdim=k),
    "min": lambda x, d, k: torch.amin(x, dim=d, keepdim=k),
}


def _make_reduce(name, fn):
    @register(name)
    def _op(attrs, x, _fn=fn):
        axis = _norm_axis(attrs.get("axis"))
        keepdims = bool(attrs.get("keepdims", False))
        if attrs.get("exclude", False) and axis is not None:
            skip = _dims(x, axis)
            axis = tuple(i for i in range(x.dim()) if i not in skip)
        out = _fn(x, _dims(x, axis), keepdims)
        if axis is None and not keepdims:
            out = out.reshape(1)
        return out


for _name, _fn in _REDUCE.items():
    _make_reduce(_name, _fn)

alias("sum_axis", "sum")
alias("max_axis", "max")
alias("min_axis", "min")
# fused square and sum (square_sum.cc), dense
_make_reduce("_square_sum",
             lambda x, d, k: torch.sum(torch.square(x), dim=d, keepdim=k))


@register("norm")
def _norm(attrs, x):
    """The L1 norm (``ord=1``) or else the L2 norm over ``axis``."""
    axis = _norm_axis(attrs.get("axis"))
    keepdims = bool(attrs.get("keepdims", False))
    dims = _dims(x, axis)
    if attrs.get("ord", 2) == 1:
        out = torch.sum(torch.abs(x), dim=dims, keepdim=keepdims)
    else:
        out = torch.sqrt(torch.sum(torch.square(x), dim=dims,
                                   keepdim=keepdims))
    if axis is None and not keepdims:
        out = out.reshape(1)
    return out


def _arg(fn, attrs, x):
    axis = attrs.get("axis")
    if axis is None:
        out = fn(x.reshape(-1)).reshape(1)
    else:
        out = fn(x, dim=int(axis),
                 keepdim=bool(attrs.get("keepdims", False)))
    return out.to(torch.float32)


@register("argmax", no_grad=True)
def _argmax(attrs, x):
    return _arg(torch.argmax, attrs, x)


@register("argmin", no_grad=True)
def _argmin(attrs, x):
    return _arg(torch.argmin, attrs, x)


@register("argmax_channel", no_grad=True)
def _argmax_channel(attrs, x):
    return torch.argmax(x, dim=1).to(torch.float32)


def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """``x``'s entries at ``index`` (any dtype, truncated) along ``axis``;
    an index out of range is clipped (``mode='clip'``) or wrapped
    (``'wrap'``).  ``axis`` None picks from the flattened ``x``."""
    idx = index.long()
    if axis is None:
        return x.reshape(-1)[idx.reshape(-1)]
    axis = int(axis) % x.dim()
    n = x.shape[axis]
    idx = idx.clamp(0, n - 1) if mode == "clip" else torch.remainder(idx, n)
    out = torch.gather(x, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


@register("pick")
def _pick(attrs, x, index):
    return pick(x, index, attrs.get("axis", -1),
                bool(attrs.get("keepdims", False)),
                attrs.get("mode", "clip"))
