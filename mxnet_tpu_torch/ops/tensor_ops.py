"""Shape, joining, indexing and dot ops (a subset of
``mxnet_tpu/ops/tensor_ops.py``): ``Reshape`` with MXNet's codes
(:24-66), ``Flatten`` (:69), ``transpose`` (:77), ``expand_dims`` (:109),
``SliceChannel``/``split`` (:226-238), ``slice_like`` (:214), ``Concat`` (:256-262),
``stack`` (:265), ``Pad`` (:283), ``clip`` (:306), ``where`` (:311),
``reshape_like``, ``Embedding`` (:349), ``one_hot`` (:361), ``dot``
(:474), ``batch_dot`` (:490) and the creators ``_zeros``, ``_ones`` and
``_arange`` (:515-552).

A creator has no input to take a device from: it makes its output on
``attrs["_device"]``, which the executor sets to the graph's device (and
shape inference to ``meta``), else on the current context.

Indices arrive in any dtype (MXNet's are often float) and are widened to
int64 only inside ``Embedding`` and ``one_hot``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..context import resolve_device
from .registry import alias, register

__all__ = ["embedding", "reshape_shape"]


def reshape_shape(in_shape, shape, reverse=False):
    """The target shape of MXNet's ``Reshape``: 0 copies a dimension, -1
    infers one, -2 copies the rest, -3 merges two, -4 splits one into the
    next two entries (one of which may be -1); ``reverse`` matches the
    codes from the right."""
    in_shape, shape = list(in_shape), list(shape)
    if reverse:
        in_shape, shape = in_shape[::-1], shape[::-1]
    out = []
    src = i = 0
    while i < len(shape):
        s = shape[i]
        if s == 0:
            out.append(in_shape[src])
            src += 1
        elif s == -1:
            out.append(-1)
            src += 1
        elif s == -2:
            out.extend(in_shape[src:])
            src = len(in_shape)
        elif s == -3:
            out.append(in_shape[src] * in_shape[src + 1])
            src += 2
        elif s == -4:
            d1, d2 = shape[i + 1], shape[i + 2]
            if d1 == -1:
                d1 = in_shape[src] // d2
            if d2 == -1:
                d2 = in_shape[src] // d1
            out.extend([d1, d2])
            src += 1
            i += 2
        else:
            out.append(s)
            src += 1
        i += 1
    return tuple(out[::-1] if reverse else out)


@register("Reshape")
def _reshape(attrs, x):
    shape = attrs.get("shape")
    if shape is None:
        return x
    return x.reshape(reshape_shape(x.shape, shape,
                                   attrs.get("reverse", False)))


alias("reshape", "Reshape")


@register("Flatten")
def _flatten(attrs, x):
    return x.reshape(x.shape[0], -1)


alias("flatten", "Flatten")


@register("transpose")
def _transpose(attrs, x):
    axes = attrs.get("axes")
    if not axes:
        axes = tuple(range(x.dim() - 1, -1, -1))
    return x.permute(*axes)


@register("expand_dims")
def _expand_dims(attrs, x):
    return x.unsqueeze(int(attrs["axis"]))


@register("slice_like")
def _slice_like(attrs, x, y):
    """``x`` cut to ``y``'s length on ``axes`` (default: every axis both
    have), from the start."""
    axes = attrs.get("axes", ())
    if not axes:
        axes = tuple(range(min(x.dim(), y.dim())))
    idx = [slice(None)] * x.dim()
    for a in axes:
        a = int(a) % x.dim()
        idx[a] = slice(0, y.shape[a])
    return x[tuple(idx)]


@register("SliceChannel",
          num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)))
def _slice_channel(attrs, x):
    num = int(attrs.get("num_outputs", 1))
    axis = int(attrs.get("axis", 1))
    if x.shape[axis] % num:
        raise ValueError("SliceChannel: axis %d of length %d does not split "
                         "into %d equal parts" % (axis, x.shape[axis], num))
    outs = torch.split(x, x.shape[axis] // num, dim=axis)
    if attrs.get("squeeze_axis", False):
        outs = [o.squeeze(axis) for o in outs]
    return tuple(outs)


alias("split", "SliceChannel")


@register("Concat")
def _concat(attrs, *arrays):
    return torch.cat(arrays, dim=int(attrs.get("dim", 1)))


alias("concat", "Concat")


@register("stack")
def _stack(attrs, *arrays):
    return torch.stack(arrays, dim=int(attrs.get("axis", 0)))


_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}


@register("Pad")
def _pad(attrs, x):
    """``jnp.pad`` of ``x`` by ``pad_width`` (before and after, axis by
    axis, MXNet's flat tuple) in ``mode`` constant (``constant_value``),
    edge or reflect.  Edge and reflect pad from the first axis that takes
    padding on (torch pads at most the last three axes that way)."""
    pad_width = attrs["pad_width"]
    mode = attrs.get("mode", "constant")
    if mode not in _PAD_MODES:
        raise ValueError("unknown pad mode %s" % mode)
    pairs = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
             for i in range(len(pad_width) // 2)]
    lead = 0
    if mode != "constant":
        while lead < len(pairs) and pairs[lead] == (0, 0):
            lead += 1
    flat = [n for pair in reversed(pairs[lead:]) for n in pair]
    if mode == "constant":
        return F.pad(x, flat,
                     value=float(attrs.get("constant_value", 0.0)))
    return F.pad(x, flat, mode=_PAD_MODES[mode])


alias("pad", "Pad")


@register("clip")
def _clip(attrs, x):
    """``jnp.clip(x, a_min, a_max)``: either bound may be absent."""
    lo, hi = attrs.get("a_min"), attrs.get("a_max")
    return torch.clamp(x, None if lo is None else float(lo),
                       None if hi is None else float(hi))


@register("where")
def _where(attrs, cond, a, b):
    return torch.where(cond != 0, a, b)


@register("reshape_like")
def _reshape_like(attrs, x, y):
    return x.reshape(y.shape)


def embedding(data, weight):
    """Rows of ``weight`` at ``data`` (indices of any dtype, truncated);
    the op ``Embedding`` and the layer ``gluon.nn.Embedding``."""
    if data.dtype not in (torch.int32, torch.int64):
        data = data.long()
    return F.embedding(data, weight)


@register("Embedding")
def _embedding(attrs, data, weight):
    return embedding(data, weight)


@register("one_hot", no_grad=True)
def _one_hot(attrs, indices):
    from ..ndarray.ndarray import torch_dtype
    depth = int(attrs["depth"])
    on_value = attrs.get("on_value", 1.0)
    off_value = attrs.get("off_value", 0.0)
    idx = indices.long()
    # an index outside [0, depth) gives a row of off_value, as in the JAX op
    hot = idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)
    out = hot.to(torch.float32) * (on_value - off_value) + off_value
    return out.to(torch_dtype(attrs.get("dtype", "float32")))


@register("dot")
def _dot(attrs, a, b):
    """Contract the last axis of ``a`` with the first of ``b``."""
    if attrs.get("transpose_a", False):
        a = a.permute(*range(a.dim() - 1, -1, -1))
    if attrs.get("transpose_b", False):
        b = b.permute(*range(b.dim() - 1, -1, -1))
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b).reshape(1)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot")
def _batch_dot(attrs, a, b):
    if attrs.get("transpose_a", False):
        a = a.transpose(-1, -2)
    if attrs.get("transpose_b", False):
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


# ---------------------------------------------------------------------------
# creators

def _created(attrs, make):
    from ..ndarray.ndarray import torch_dtype
    return make(dtype=torch_dtype(attrs.get("dtype", "float32")),
                device=resolve_device(attrs.get("_device")))


@register("_zeros")
def _zeros_op(attrs):
    return _created(attrs, lambda **kw: torch.zeros(tuple(attrs["shape"]),
                                                    **kw))


@register("_ones")
def _ones_op(attrs):
    return _created(attrs, lambda **kw: torch.ones(tuple(attrs["shape"]),
                                                   **kw))


@register("_arange")
def _arange_op(attrs):
    """``start`` to ``stop`` by ``step`` (0 to ``start`` without
    ``stop``), each value ``repeat`` times."""
    start, stop = attrs.get("start", 0), attrs.get("stop")
    if stop is None:
        start, stop = 0, start
    v = _created(attrs, lambda **kw: torch.arange(
        start, stop, attrs.get("step", 1.0), **kw))
    repeat = int(attrs.get("repeat", 1))
    return v.repeat_interleave(repeat) if repeat > 1 else v
