"""Reductions (a subset of ``mxnet_tpu/ops/reduce_ops.py``): the
``_REDUCE`` table (:44-52) with ``sum_axis``/``max_axis``/``min_axis``,
``argmax`` (:84) and ``pick`` (:118).

MXNet 1.3's conventions, as there: reducing every axis gives shape (1,),
not a 0-d array; ``argmax`` returns float32 indices.
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


_REDUCE = {
    "sum": lambda x, d, k: torch.sum(x, dim=d, keepdim=k),
    "mean": lambda x, d, k: torch.mean(x, dim=d, keepdim=k),
    "prod": _over(torch.prod),
    "nansum": lambda x, d, k: torch.nansum(x, dim=d, keepdim=k),
    "nanprod": _over(_nanprod),
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


@register("argmax", no_grad=True)
def _argmax(attrs, x):
    axis = attrs.get("axis")
    if axis is None:
        out = torch.argmax(x.reshape(-1)).reshape(1)
    else:
        out = torch.argmax(x, dim=int(axis),
                           keepdim=bool(attrs.get("keepdims", False)))
    return out.to(torch.float32)


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
