"""Shape, slicing, joining, indexing, ordering, dot and creator ops
(counterpart of ``mxnet_tpu/ops/tensor_ops.py``): ``Reshape`` with
MXNet's codes (:24-66), ``Flatten`` (:69), ``transpose`` (:77),
``SwapAxis``/``swapaxes`` (:85), ``_rnn_state_like`` (:94),
``expand_dims`` (:109), ``squeeze``
(:114), ``shape_array``/``size_array`` (:129-141), ``broadcast_to``,
``broadcast_like`` and ``broadcast_axis``/``broadcast_axes`` (:144-170),
``slice``/``crop`` (:194), ``slice_axis`` (:204), ``slice_like`` (:214),
``SliceChannel``/``split`` (:226-238), ``reverse``/``flip`` (:241),
``Concat`` (:256-262), ``stack`` (:265), ``repeat`` (:271), ``tile``
(:278), ``Pad`` (:283), ``clip`` (:306), ``where`` (:311), ``diag``
(:316), ``take`` (:329), ``batch_take`` (:342), ``reshape_like``,
``Embedding`` (:349), ``one_hot`` (:361), ``gather_nd`` (:373),
``scatter_nd`` (:380), ``_scatter_set_nd`` (:389), ``sort`` (:400),
``argsort`` (:416), ``topk`` (:433), ``dot`` (:474), ``batch_dot``
(:490), ``khatri_rao`` (:502), the creators ``_zeros``, ``_ones``,
``_full``, ``_arange`` and ``_eye`` (:515-560), ``space_to_depth``,
``depth_to_space`` (:563-580), ``ravel_multi_index`` and
``unravel_index`` (:583-604, also under a leading underscore).

A creator has no input to take a device from: it makes its output on
``attrs["_device"]``, which the executor sets to the graph's device (and
shape inference to ``meta``), else on the current context.

Indices arrive in any dtype (MXNet's are often float).  Out-of-range
indices behave as the JAX package's gathers and scatters do: a negative
index counts from the end, a gather clamps what is still outside
(``batch_take``, ``gather_nd``), ``take(mode='raise')`` fills it with NaN
(the integer minimum for an integer array), and a scatter drops it.
Orderings are stable, as ``jnp.argsort`` and ``lax.top_k`` are: ties keep
the lower index first (reversed by a descending ``sort``/``argsort``,
which flip an ascending one, as there).
"""
from __future__ import annotations

import numbers

import torch
import torch.nn.functional as F

from ..context import resolve_device
from .registry import alias, register

__all__ = ["embedding", "reshape_shape"]


def _index(t):
    """Indices of any dtype as int64, truncated as XLA converts."""
    from ..ndarray.ndarray import cast
    return cast(t, torch.int32).long()


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


@register("SwapAxis")
def _swap_axis(attrs, x):
    return torch.swapaxes(x, int(attrs.get("dim1", 0)),
                          int(attrs.get("dim2", 0)))


alias("swapaxes", "SwapAxis")


@register("_rnn_state_like")
def _rnn_state_like(attrs, ref):
    """Zeros for an RNN begin state in ``ref``'s dtype and on its device:
    each 0 of ``shape`` becomes ``ref.shape[ref_axis]`` (``:94-105``; the
    legacy ``mx.rnn`` cells' default states read their batch size off the
    input this way)."""
    b = ref.shape[int(attrs.get("ref_axis", 0))]
    shape = tuple(b if int(s) == 0 else int(s) for s in attrs["shape"])
    return torch.zeros(shape, dtype=ref.dtype, device=ref.device)


@register("squeeze")
def _squeeze(attrs, x):
    axis = attrs.get("axis")
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, (list, tuple)):
        return torch.squeeze(x, dim=tuple(int(a) for a in axis))
    return torch.squeeze(x, dim=int(axis))


@register("shape_array", no_grad=True)
def _shape_array(attrs, x):
    # int32: the JAX package's int64 narrows without x64
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


@register("size_array", no_grad=True)
def _size_array(attrs, x):
    return torch.tensor([x.numel()], dtype=torch.int32, device=x.device)


@register("broadcast_to")
def _broadcast_to(attrs, x):
    """``x`` broadcast to ``shape``; a 0 keeps the input's dimension."""
    shape = tuple(x.shape[i] if s == 0 else s
                  for i, s in enumerate(attrs["shape"]))
    return x.expand(shape)


@register("broadcast_like")
def _broadcast_like(attrs, x, y):
    return x.expand(y.shape)


@register("broadcast_axis")
def _broadcast_axis(attrs, x):
    axis, size = attrs.get("axis", ()), attrs.get("size", ())
    axis = (axis,) if isinstance(axis, int) else axis
    size = (size,) if isinstance(size, int) else size
    shape = list(x.shape)
    for a, n in zip(axis, size):
        shape[a] = n
    return x.expand(tuple(shape))


alias("broadcast_axes", "broadcast_axis")


def _slice_axis_of(x, axis, sl):
    """``x`` sliced by the Python slice ``sl`` on ``axis``; a negative step
    gathers (torch slices take none)."""
    if sl.step is None or sl.step > 0:
        idx = [slice(None)] * x.dim()
        idx[axis] = sl
        return x[tuple(idx)]
    rows = torch.arange(*sl.indices(x.shape[axis]), device=x.device)
    return torch.index_select(x, axis, rows)


@register("slice")
def _slice(attrs, x):
    """``x[begin:end:step]`` axis by axis (None entries, and missing
    trailing axes, take the whole axis)."""
    begin, end = list(attrs.get("begin", ())), list(attrs.get("end", ()))
    step = attrs.get("step") or ()
    step = list(step)
    for axis in range(x.dim()):
        b = begin[axis] if axis < len(begin) else None
        e = end[axis] if axis < len(end) else None
        st = step[axis] if axis < len(step) else None
        if (b, e, st) != (None, None, None):
            x = _slice_axis_of(x, axis, slice(b, e, st))
    return x


alias("crop", "slice")


@register("slice_axis")
def _slice_axis(attrs, x):
    axis = int(attrs["axis"]) % x.dim()
    return _slice_axis_of(x, axis, slice(attrs.get("begin", 0),
                                         attrs.get("end")))


@register("reverse")
def _reverse(attrs, x):
    axis = attrs.get("axis", 0)
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(x, dims=axis)


alias("flip", "reverse")


@register("repeat")
def _repeat(attrs, x):
    """``jnp.repeat``: each entry ``repeats`` times along ``axis`` (the
    flattened array without one)."""
    repeats = int(attrs["repeats"])
    axis = attrs.get("axis")
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats)
    return torch.repeat_interleave(x, repeats, dim=int(axis))


@register("tile")
def _tile(attrs, x):
    return torch.tile(x, tuple(attrs["reps"]))


@register("diag")
def _diag(attrs, x):
    """The matrix of a vector on diagonal ``k``, or the ``k``-th diagonal
    of axes 0 and 1 (last in the output)."""
    k = int(attrs.get("k", 0))
    if x.dim() == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=0, dim2=1)


def _wrap_negative(idx, n):
    return torch.where(idx < 0, idx + n, idx)


@register("take")
def _take(attrs, x, indices):
    """Rows of ``x`` along ``axis`` at ``indices``: clipped
    (``mode='clip'``), wrapped (``'wrap'``), or else filled with NaN where
    out of range."""
    axis = int(attrs.get("axis", 0)) % x.dim()
    mode = attrs.get("mode", "clip")
    n = x.shape[axis]
    idx = _index(indices)
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx = _wrap_negative(idx, n)
        valid = (idx >= 0) & (idx < n)
        idx = torch.where(valid, idx, torch.zeros_like(idx))
    out = torch.index_select(x, axis, idx.reshape(-1))
    out = out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])
    if mode in ("clip", "wrap"):
        return out
    fill = float("nan") if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    mask = valid.reshape((1,) * axis + idx.shape
                         + (1,) * (x.dim() - axis - 1))
    return torch.where(mask, out, torch.full_like(out, fill))


def _clamped_gather(out, valid):
    """A gather at clamped indices whose out-of-range points pass no
    gradient back: XLA's gather clamps, its transpose scatter drops."""
    return torch.where(valid, out, out.detach())


@register("batch_take")
def _batch_take(attrs, x, indices):
    """``x[i, indices[i]]`` for each row ``i``."""
    n = x.shape[1]
    idx = _wrap_negative(_index(indices), n)
    valid = (idx >= 0) & (idx < n)
    return _clamped_gather(
        x[torch.arange(x.shape[0], device=x.device), idx.clamp(0, n - 1)],
        valid)


def _nd_index(indices, shape):
    """The rows of ``indices`` (M, ...) as a tuple of index tensors into
    the first M dims of ``shape``, negatives counted from the end, and
    whether each point lies inside."""
    idx = _index(indices)
    rows, valid = [], torch.ones(idx.shape[1:], dtype=torch.bool,
                                 device=idx.device)
    for i in range(idx.shape[0]):
        r = _wrap_negative(idx[i], shape[i])
        valid &= (r >= 0) & (r < shape[i])
        rows.append(r)
    return rows, valid


@register("gather_nd")
def _gather_nd(attrs, data, indices):
    rows, valid = _nd_index(indices, data.shape)
    out = data[tuple(r.clamp(0, data.shape[i] - 1)
                     for i, r in enumerate(rows))]
    return _clamped_gather(out, valid.reshape(
        tuple(valid.shape) + (1,) * (out.dim() - valid.dim())))


def _scatter(base, indices, values):
    """``base`` with ``values`` written at ``indices``; points outside go
    to one extra slot at the end of each indexed dim, which is cut off."""
    m = indices.shape[0]
    shape = base.shape
    rows, valid = _nd_index(indices, shape)
    for d in range(m):
        extra = list(base.shape)
        extra[d] = 1
        base = torch.cat([base, base.new_zeros(extra)], dim=d)
    rows = tuple(torch.where(valid, r, torch.full_like(r, shape[i]))
                 for i, r in enumerate(rows))
    out = base.index_put(rows, values)
    return out[tuple(slice(0, n) for n in shape[:m])]


@register("scatter_nd")
def _scatter_nd(attrs, data, indices):
    shape = tuple(attrs["shape"])
    return _scatter(torch.zeros(shape, dtype=data.dtype, device=data.device),
                    indices, data)


@register("_scatter_set_nd")
def _scatter_set_nd(attrs, lhs, indices, rhs):
    return _scatter(lhs, indices, rhs)


def _ordering_axis(attrs, x):
    axis = attrs.get("axis", -1)
    if axis is None:
        return x.reshape(-1), 0
    return x, int(axis) % x.dim()


@register("sort")
def _sort(attrs, x):
    x, axis = _ordering_axis(attrs, x)
    out = torch.sort(x, dim=axis, stable=True).values
    if not bool(attrs.get("is_ascend", True)):
        out = torch.flip(out, dims=(axis,))
    return out


@register("argsort", no_grad=True)
def _argsort(attrs, x):
    from ..ndarray.ndarray import cast, torch_dtype
    x, axis = _ordering_axis(attrs, x)
    out = torch.sort(x, dim=axis, stable=True).indices
    if not bool(attrs.get("is_ascend", True)):
        out = torch.flip(out, dims=(axis,))
    return cast(out, torch_dtype(attrs.get("dtype", "float32")))


@register("topk",
          num_outputs=lambda attrs: 2 if attrs.get("ret_typ") == "both"
          else 1,
          no_grad=lambda attrs: attrs.get("ret_typ", "indices")
          not in ("value", "both"))
def _topk(attrs, x):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``, from a
    stable sort: ties give the lower index first, as ``lax.top_k``.
    ``ret_typ`` is indices, value, both or mask."""
    from ..ndarray.ndarray import cast, torch_dtype
    x, axis = _ordering_axis(attrs, x)
    k = int(attrs.get("k", 1))
    ret_typ = attrs.get("ret_typ", "indices")
    srt = torch.sort(x, dim=axis, stable=True,
                     descending=not bool(attrs.get("is_ascend", False)))
    vals = srt.values.narrow(axis, 0, k)
    idxs = srt.indices.narrow(axis, 0, k)
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter(axis, idxs,
                                           torch.ones_like(vals))
    idx_out = cast(idxs, torch_dtype(attrs.get("dtype", "float32")))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx_out
    return idx_out


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
    """``jnp.clip(x, a_min, a_max)``: either bound may be absent.  As
    there, an integer array keeps its dtype under integer bounds and
    becomes float32 under a float one (a weak-typed Python float)."""
    bounds = [b if b is None or isinstance(b, numbers.Integral)
              else float(b) for b in (attrs.get("a_min"), attrs.get("a_max"))]
    if not x.is_floating_point() and any(isinstance(b, float)
                                         for b in bounds):
        x = x.to(torch.float32)
    return torch.clamp(x, *bounds)


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


@register("khatri_rao")
def _khatri_rao(attrs, *mats):
    """Column-wise Kronecker product of (I, K), (J, K) ... -> (I*J*..., K)."""
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            (-1,) + tuple(out.shape[1:]))
    return out


@register("_full")
def _full_op(attrs):
    from ..ndarray.ndarray import cast, torch_dtype
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    value = attrs.get("value", 0.0)
    if dtype.is_floating_point:
        return _created(attrs, lambda **kw: torch.full(
            tuple(attrs["shape"]), float(value), **kw))
    # an integer type takes the value as XLA converts it
    full = torch.full(tuple(attrs["shape"]), float(value),
                      dtype=torch.float64,
                      device=resolve_device(attrs.get("_device")))
    return cast(full, dtype)


@register("_eye")
def _eye_op(attrs):
    """``N`` x ``M`` (``M`` 0: ``N``) with ones on diagonal ``k``."""
    n = int(attrs["N"])
    m = int(attrs.get("M", 0)) or n
    k = int(attrs.get("k", 0))
    device = resolve_device(attrs.get("_device"))
    on = torch.arange(m, device=device)[None, :] \
        - torch.arange(n, device=device)[:, None] == k
    return _created(attrs, lambda **kw: on.to(**kw))


@register("space_to_depth")
def _space_to_depth(attrs, x):
    bs = int(attrs["block_size"])
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * bs * bs, h // bs, w // bs)


@register("depth_to_space")
def _depth_to_space(attrs, x):
    bs = int(attrs["block_size"])
    n, c, h, w = x.shape
    x = x.reshape(n, bs, bs, c // (bs * bs), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (bs * bs), h * bs, w * bs)


@register("ravel_multi_index")
def _ravel_multi_index(attrs, indices):
    """Flat indices (float32) of the rows of ``indices`` into ``shape``,
    in int32 (the JAX package's int64, without x64)."""
    from ..ndarray.ndarray import cast
    idx = cast(indices, torch.int32)
    out = torch.zeros(idx.shape[1:], dtype=torch.int32, device=idx.device)
    for i, s in enumerate(attrs["shape"]):
        out = out * int(s) + idx[i]
    return out.to(torch.float32)


@register("unravel_index")
def _unravel_index(attrs, indices):
    from ..ndarray.ndarray import cast
    rem = cast(indices, torch.int32)
    outs = []
    for s in reversed(tuple(attrs["shape"])):
        outs.append(torch.remainder(rem, int(s)))
        rem = torch.div(rem, int(s), rounding_mode="floor")
    return torch.stack(outs[::-1], dim=0).to(torch.float32)


alias("_ravel_multi_index", "ravel_multi_index")
alias("_unravel_index", "unravel_index")
