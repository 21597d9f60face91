"""NDArray: a mutable array handle over a ``torch.Tensor`` (counterpart of
``mxnet_tpu/ndarray/ndarray.py``).

Mutation swaps the buffer: ``out=``, ``__setitem__`` and the in-place
operators compute a new tensor under ``torch.no_grad()`` and make it the
array's buffer, so a tensor that a recorded graph saved is never written
in place (torch would refuse the backward), and a gradient is taken at the
values the graph saw (the reference's tape snapshots them).  Basic-index
views keep a ``(base, index, version)`` link, as the reference does
(:80-101, :221-227): a view re-slices its base when the base's version
moved, and a write to a view writes a new base buffer.

An array's context is its tensor's device.  Creators without ``ctx`` use
:func:`~..context.current_context` (``cuda:0``, or the innermost
``with mx.cpu():``/``with mx.gpu(i):`` scope), and raise without CUDA.  An
op's outputs stay on its inputs' device; nothing moves a CUDA array to the
CPU but ``asnumpy`` and an explicit ``copyto``/``as_in_context``.

dtypes follow the JAX package, which runs without x64: a float64 source
becomes float32 and an int64 one int32.  ``dtype`` is a numpy dtype, or the
string ``"bfloat16"`` for a bf16 array (numpy has no bf16 type, and the
port never imports ``ml_dtypes``); ``asnumpy()`` of a bf16 array widens it
to float32, exactly (the JAX package hands out ``ml_dtypes``' bfloat16).

Every operator goes through :func:`invoke`, the counterpart of
``Imperative::Invoke``: look the op up, inject ``_training`` and, for an
op that draws, a fresh ``random.next_key()`` as ``_rng_key``
(``mxnet_tpu/ndarray/ndarray.py:559-561``), run it (recorded by torch's
autograd inside ``autograd.record()``, under ``torch.no_grad()`` outside
it), wrap the outputs and honour ``out=``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from .. import random as _random
from ..base import MXNetError, integer_types, numeric_types, \
    tensor_from_numpy
from ..context import resolve_device
from ..ops.registry import get_op

__all__ = ["NDArray", "invoke", "array", "zeros", "ones", "full", "empty",
           "arange", "concat", "stack", "waitall"]

_TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16, "uint8": torch.uint8,
                 "int8": torch.int8, "int32": torch.int32,
                 "bool": torch.bool}
# the JAX package runs without x64
_NARROW = {"float64": "float32", "int64": "int32"}
_NUMPY_DTYPES = {t: (n if n == "bfloat16" else np.dtype(n))
                 for n, t in _TORCH_DTYPES.items()}


def torch_dtype(dtype):
    """The torch dtype an NDArray of ``dtype`` holds (a name, a numpy or a
    torch dtype; None is float32), with 64-bit types narrowed to 32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        name = str(dtype)[len("torch."):]
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    name = _NARROW.get(name, name)
    if name not in _TORCH_DTYPES:
        raise TypeError("dtype %r is not one of %s"
                        % (dtype, sorted(_TORCH_DTYPES)))
    return _TORCH_DTYPES[name]


def _grad_scope():
    """Torch's grad mode as recording wants it, for tensor code outside
    :func:`invoke`."""
    return torch.enable_grad() if autograd.is_recording() \
        else torch.no_grad()


def _is_basic_index(key):
    advanced = (NDArray, list, np.ndarray, torch.Tensor)
    if isinstance(key, tuple):
        return not any(isinstance(k, advanced) for k in key)
    return not isinstance(key, advanced)


def _index_tensor(k):
    t = k._data if isinstance(k, NDArray) else k
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t.long()   # MXNet indexes with float arrays too
    return t


class NDArray:
    """Mutable multi-dimensional array handle on a device."""

    __slots__ = ("_data_buf", "_version", "_base", "_base_index",
                 "_base_version", "grad", "_grad_req", "__weakref__")

    # numpy defers to the reflected operators
    __array_priority__ = 100.0

    # a property, so that basic-index views see later mutation of their
    # base: a read re-slices the base when the base's version moved
    @property
    def _data(self):
        b = self._base
        if b is not None:
            # the base's property first: a stale chain refreshes root-down
            base_data = b._data
            if b._version != self._base_version:
                with torch.no_grad():
                    self._data = base_data[self._base_index]
                self._base_version = b._version
        return self._data_buf

    @_data.setter
    def _data(self, value):
        self._data_buf = value
        self._version += 1

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray holds a torch.Tensor, got %s"
                            % type(data).__name__)
        self._version = 0
        self._base = None
        self._base_index = None
        self._base_version = 0
        self._data = data
        self.grad = None
        self._grad_req = "null"

    # ------------------------------------------------------------------
    # properties
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _NUMPY_DTYPES[self._data.dtype]

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return self._data.device

    ctx = context

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(map(str, self.shape)),
            self.context)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asnumpy().reshape(-1)[0])
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    # ------------------------------------------------------------------
    # sync and transfer
    def wait_to_read(self):
        """Block until the work that writes this array is done (the card's
        current stream is synchronized)."""
        device = self.context
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()

    def asnumpy(self):
        """A numpy copy; bf16 widened to float32 exactly."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.cpu().numpy()
        return a.copy() if t.device.type == "cpu" else a

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0]

    def item(self):
        return self.asscalar()

    def astype(self, dtype, copy=True):
        """A copy in ``dtype`` (not recorded, as in the reference)."""
        with torch.no_grad():
            return NDArray(self._data.to(torch_dtype(dtype), copy=True))

    def copyto(self, other):
        """Copy into the NDArray ``other`` (its device and dtype), or onto
        the device ``other``."""
        with torch.no_grad():
            if isinstance(other, NDArray):
                if other is not self:
                    other._set_data(self._data.to(
                        other.context, other._data.dtype, copy=True))
                return other
            if isinstance(other, (torch.device, str)):
                return NDArray(self._data.to(resolve_device(other),
                                             copy=True))
        raise TypeError("copyto does not support type %s" % type(other))

    def copy(self):
        with torch.no_grad():
            return NDArray(self._data.clone())

    def as_in_context(self, context):
        if self.context == torch.device(context):
            return self
        return self.copyto(context)

    as_in_ctx = as_in_context

    # ------------------------------------------------------------------
    # mutation
    def _set_data(self, value):
        """Make ``value`` the buffer; an array that takes gradients gets it
        as a new leaf (unless ``value`` carries recorded history), and a
        view writes it through into its base."""
        if self._grad_req != "null" and value.grad_fn is None:
            value = autograd.leaf_for(self, value)
        self._data = value
        b = self._base
        if b is not None:
            with torch.no_grad():
                new = b._data.detach().clone()
                new[self._base_index] = value.detach().to(new.dtype)
            b._set_data(new)
            self._base_version = b._version

    # ------------------------------------------------------------------
    # autograd
    def attach_grad(self, grad_req="write", stype=None):
        """Take gradients: ``x.grad`` is a zero array that each backward
        overwrites (``"write"``) or adds to (``"add"``)."""
        if stype not in (None, "default"):
            raise MXNetError("sparse gradients are not ported yet")
        with torch.no_grad():
            grad = NDArray(torch.zeros_like(
                self._data, memory_format=torch.contiguous_format))
        autograd.mark_variables([self], [grad], grad_req)

    def _take_grad(self, grad):
        """Store the gradient a backward computed for this array."""
        if self._grad_req == "null" or self.grad is None:
            return
        if self._grad_req == "add":
            self.grad._data = self.grad._data + grad
        else:
            self.grad._data = grad

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # ------------------------------------------------------------------
    # indexing
    def __getitem__(self, key):
        if isinstance(key, tuple):
            key_c = tuple(_index_tensor(k) for k in key)
        else:
            key_c = _index_tensor(key)
        with _grad_scope():
            out = NDArray(self._data[key_c])
        if _is_basic_index(key):   # a view that writes back
            out._base = self
            out._base_index = key_c
            out._base_version = self._version
        return out

    def __setitem__(self, key, value):
        if isinstance(key, tuple):
            idx = tuple(_index_tensor(k) for k in key)
        else:
            idx = _index_tensor(key)
        with torch.no_grad():
            cur = self._data.detach()
            if isinstance(value, NDArray):
                value = value._data.detach()
            elif isinstance(value, (np.ndarray, list, tuple)):
                value = tensor_from_numpy(np.asarray(value))
            if isinstance(value, torch.Tensor):
                value = value.to(cur.device, cur.dtype)
            if isinstance(idx, slice) and idx == slice(None):
                if isinstance(value, torch.Tensor):
                    new = value.expand(cur.shape).clone()
                else:
                    new = torch.full_like(cur, value)
            else:
                new = cur.clone()
                new[idx] = value
        self._set_data(new)

    # ------------------------------------------------------------------
    # arithmetic, through the registry so that autograd sees it
    def _binop(self, other, op_arr, op_scalar, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke(op_arr, [a, b], {})
        if isinstance(other, numeric_types):
            if isinstance(other, np.generic):
                other = other.item()
            return invoke(op_scalar, [self],
                          {"scalar": other, "reverse": reverse})
        if isinstance(other, np.ndarray):
            return self._binop(array(other, ctx=self.context,
                                     dtype=other.dtype),
                               op_arr, op_scalar, reverse)
        return NotImplemented

    def __add__(self, o):  return self._binop(o, "broadcast_add", "_plus_scalar")
    def __radd__(self, o): return self._binop(o, "broadcast_add", "_plus_scalar", True)
    def __sub__(self, o):  return self._binop(o, "broadcast_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binop(o, "broadcast_sub", "_minus_scalar", True)
    def __mul__(self, o):  return self._binop(o, "broadcast_mul", "_mul_scalar")
    def __rmul__(self, o): return self._binop(o, "broadcast_mul", "_mul_scalar", True)
    def __truediv__(self, o):  return self._binop(o, "broadcast_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binop(o, "broadcast_div", "_div_scalar", True)
    def __mod__(self, o):  return self._binop(o, "broadcast_mod", "_mod_scalar")
    def __rmod__(self, o): return self._binop(o, "broadcast_mod", "_mod_scalar", True)
    def __pow__(self, o):  return self._binop(o, "broadcast_power", "_power_scalar")
    def __rpow__(self, o): return self._binop(o, "broadcast_power", "_power_scalar", True)
    def __neg__(self):     return invoke("negative", [self], {})
    def __abs__(self):     return invoke("abs", [self], {})

    def __matmul__(self, o):
        if not isinstance(o, NDArray):
            o = array(np.asarray(o), ctx=self.context)
        return invoke("dot", [self, o], {})

    def __rmatmul__(self, o):
        if not isinstance(o, NDArray):
            o = array(np.asarray(o), ctx=self.context)
        return invoke("dot", [o, self], {})

    def __eq__(self, o):
        if o is None:
            return False
        return self._binop(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o): return self._binop(o, "broadcast_greater", "_greater_scalar")
    def __ge__(self, o): return self._binop(o, "broadcast_greater_equal", "_greater_equal_scalar")
    def __lt__(self, o): return self._binop(o, "broadcast_lesser", "_lesser_scalar")
    def __le__(self, o): return self._binop(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    __hash__ = object.__hash__

    def _inplace(self, other, op_arr, op_scalar):
        res = self._binop(other, op_arr, op_scalar)
        self._set_data(res._data.to(self._data.dtype))
        return self

    def __iadd__(self, o): return self._inplace(o, "broadcast_add", "_plus_scalar")
    def __isub__(self, o): return self._inplace(o, "broadcast_sub", "_minus_scalar")
    def __imul__(self, o): return self._inplace(o, "broadcast_mul", "_mul_scalar")
    def __itruediv__(self, o): return self._inplace(o, "broadcast_div", "_div_scalar")

    # ------------------------------------------------------------------
    # methods onto registered ops
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        return invoke("Reshape", [self], {"shape": shape,
                                          "reverse": kwargs.get("reverse",
                                                                False)})

    def transpose(self, axes=None):
        return invoke("transpose", [self], {"axes": axes})

    @property
    def T(self):
        return self.transpose()

    def flatten(self):
        return invoke("Flatten", [self], {})

    def expand_dims(self, axis):
        return invoke("expand_dims", [self], {"axis": axis})

    def pick(self, index, axis=-1, keepdims=False):
        return invoke("pick", [self, index], {"axis": axis,
                                              "keepdims": keepdims})

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return invoke("one_hot", [self], {"depth": depth,
                                          "on_value": on_value,
                                          "off_value": off_value,
                                          "dtype": dtype})

    def abs(self): return invoke("abs", [self], {})
    def sign(self): return invoke("sign", [self], {})
    def exp(self): return invoke("exp", [self], {})
    def log(self): return invoke("log", [self], {})
    def sqrt(self): return invoke("sqrt", [self], {})
    def square(self): return invoke("square", [self], {})
    def relu(self): return invoke("relu", [self], {})
    def sigmoid(self): return invoke("sigmoid", [self], {})
    def tanh(self): return invoke("tanh", [self], {})
    def softmax(self, axis=-1): return invoke("softmax", [self], {"axis": axis})
    def log_softmax(self, axis=-1): return invoke("log_softmax", [self], {"axis": axis})
    def round(self): return invoke("round", [self], {})
    def floor(self): return invoke("floor", [self], {})
    def ceil(self): return invoke("ceil", [self], {})

    def _reduce(self, name, axis=None, keepdims=False):
        return invoke(name, [self], {"axis": axis, "keepdims": keepdims})

    def sum(self, axis=None, keepdims=False): return self._reduce("sum", axis, keepdims)
    def mean(self, axis=None, keepdims=False): return self._reduce("mean", axis, keepdims)
    def max(self, axis=None, keepdims=False): return self._reduce("max", axis, keepdims)
    def min(self, axis=None, keepdims=False): return self._reduce("min", axis, keepdims)
    def prod(self, axis=None, keepdims=False): return self._reduce("prod", axis, keepdims)
    def nansum(self, axis=None, keepdims=False): return self._reduce("nansum", axis, keepdims)

    def argmax(self, axis=None, keepdims=False):
        return invoke("argmax", [self], {"axis": axis, "keepdims": keepdims})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return invoke("dot", [self, other], {"transpose_a": transpose_a,
                                             "transpose_b": transpose_b})


# ---------------------------------------------------------------------------
# dispatch

def invoke(op_name, inputs, attrs, out=None):
    """Run the registered op ``op_name`` on ``inputs`` (NDArrays, or other
    values handed to the op as they are) with ``attrs``.  Returns an
    NDArray, a list of them for an op with several outputs, or ``out``:
    an NDArray or a list of them whose buffers take the outputs.  When
    ``out`` is one array and the op has several outputs, the rest write
    back to the inputs the op mutates (an update op's states, as MXNet's
    ``adam_update(w, g, m, v, out=w)`` updates ``m`` and ``v``)."""
    op = get_op(op_name)
    if op.mode_dependent and op.mode_for(attrs):
        attrs = dict(attrs)
        attrs["_training"] = autograd.is_training()
    if op.needs_rng and op.rng_for(attrs):
        attrs = dict(attrs)
        attrs["_rng_key"] = _random.next_key()
    vals = [i._data if isinstance(i, NDArray) else i for i in inputs]
    if autograd.is_recording():
        result = op.apply(attrs, *vals)
    else:
        # torch.no_grad() as a context costs the host ~1.5 us more a call
        grad_mode = torch.is_grad_enabled()
        torch._C._set_grad_enabled(False)
        try:
            result = op.apply(attrs, *vals)
        finally:
            torch._C._set_grad_enabled(grad_mode)
    multi = isinstance(result, (tuple, list))
    results = list(result) if multi else [result]
    if out is None:
        outputs = [NDArray(r) for r in results]
        return outputs if multi else outputs[0]
    outs = out if isinstance(out, (list, tuple)) else [out]
    if not isinstance(out, (list, tuple)):
        outs += [inputs[i] for i in op.mutate_inputs]
    for o, r in zip(outs, results):
        dst = o._data
        if r.device != dst.device:
            raise MXNetError("%s: out= array on %s, result on %s"
                             % (op_name, dst.device, r.device))
        o._set_data(r if r.dtype == dst.dtype else r.to(dst.dtype))
    return out


def waitall():
    """Block until all work queued on the card is done."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# creators

def array(source_array, ctx=None, dtype=None):
    """A new array holding a copy of ``source_array`` (an NDArray, a torch
    tensor, or anything numpy reads), on ``ctx`` (default
    :func:`~..context.current_context`).  Without ``dtype`` it keeps the
    source's, a float64 source becoming float32 and an int64 one int32."""
    device = resolve_device(ctx)
    if isinstance(source_array, NDArray):
        src = source_array._data.detach()
    elif isinstance(source_array, torch.Tensor):
        src = source_array.detach()
    else:
        src = tensor_from_numpy(np.asarray(source_array))
    dtype = torch_dtype(src.dtype if dtype is None else dtype)
    with torch.no_grad():
        return NDArray(src.to(device, dtype, copy=True))


def _shape(shape):
    return (shape,) if isinstance(shape, integer_types) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=resolve_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=resolve_device(ctx)))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def full(shape, val, ctx=None, dtype=None, out=None):
    r = NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                           device=resolve_device(ctx)))
    if out is not None:
        out._set_data(r._data)
        return out
    return r


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    v = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                     device=resolve_device(ctx))
    if repeat > 1:
        v = v.repeat_interleave(repeat)
    return NDArray(v)


def concat(*data, dim=1, out=None):
    return invoke("Concat", list(data), {"dim": dim}, out=out)


def stack(*data, axis=0, out=None):
    return invoke("stack", list(data), {"axis": axis}, out=out)
