"""Parameters (counterpart of ``mxnet_tpu/gluon/parameter.py``:
``DeferredInitializationError``, ``Parameter`` and ``ParameterDict``).

A Gluon :class:`Parameter` holds a parameter's name, ``grad_req``, shape
(0 for a dimension not known yet), dtype, initializer and multipliers.
Its array is the tensor registered on the block that owns it, under the
attribute the block assigned it to: a ``torch.nn.Parameter``, or a buffer
for BatchNorm's running statistics (the reference's aux states: ``grad_req
'null'``, named ``running``/``moving``).  So ``block.weight`` is the torch
tensor, as torch code expects, and ``state_dict``, ``Block.cast``, the
Trainer's hooks and ``functional_call`` all see the one tensor; the Gluon
parameter is ``block.collect_params()[name]`` (or
``block._reg_params[attr]``).

A shape with an unknown dimension makes the tensor a torch
``UninitializedParameter`` (``UninitializedBuffer``).  ``initialize``
then defers: the block's first call runs its ``_shape_hook`` and
:meth:`Parameter._finish_deferred_init`, which draws the values and
materializes the same tensor object in place.  Draws are made on the host
(``initializer``), in float64 cast to float32 and then to the parameter's
dtype, and copied to the parameter's device.

:func:`cast` and :func:`watch_cast` change a tensor's dtype in place for
``Block.cast`` (:343-353).
"""
from __future__ import annotations

import warnings
import weakref
from collections import OrderedDict

import numpy as np
import torch
from torch.nn.parameter import UninitializedBuffer, UninitializedParameter
from torch.utils.weak import WeakIdKeyDictionary

from .. import initializer as init_mod
from ..base import MXNetError, as_dtype, tensor_from_numpy
from ..context import resolve_device
from ..ndarray.ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "ParameterDict",
           "cast", "watch_cast"]

_LAZY = (UninitializedParameter, UninitializedBuffer)


class DeferredInitializationError(MXNetError):
    """A parameter's shape waits for the block's first call."""


def _is_aux(name, grad_req):
    """Whether a parameter is an auxiliary state (BatchNorm's running
    statistics), by the reference's rule: ``grad_req 'null'`` and a name
    with ``running`` or ``moving`` in it.  The port keeps those as
    buffers."""
    return grad_req == "null" and ("running" in name or "moving" in name)


def _dtype_of(dtype):
    """The torch dtype of a Gluon dtype (a numpy dtype, a name such as
    ``"bfloat16"``, or a torch dtype), float64 kept."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name in ("float32", "float64", "float16", "bfloat16"):
        return as_dtype(name)
    return getattr(torch, name)


def _as_tensor(data):
    """``data`` (an NDArray, a tensor or a numpy array) as a tensor."""
    if isinstance(data, torch.Tensor):
        return data.detach()
    inner = getattr(data, "_data", None)
    if isinstance(inner, torch.Tensor):
        return inner.detach()
    return tensor_from_numpy(np.asarray(data))


class Parameter:
    """A Gluon parameter; see the module docstring for where its array
    lives."""

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default", init_perm=None):
        if stype != "default" or grad_stype != "default":
            raise MXNetError("sparse parameters are not ported yet")
        self._owner = None          # (weakref to the block, attribute)
        self._deferred_init = ()
        self._initialized = False
        self._differentiable = differentiable
        self._allow_deferred_init = allow_deferred_init
        self._grad_req = None
        self._shape = tuple(shape) if shape is not None else None
        self.name = name
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.grad_req = grad_req
        self.init = init
        # stored = canonical.permute(init_perm): initializers draw in the
        # canonical (O, I, *kernel) order
        self.init_perm = tuple(init_perm) if init_perm is not None else None

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                     self.dtype)

    # ------------------------------------------------------------------
    # the tensor on the owning block
    def _attach(self, block, attr, device):
        """Make this parameter's tensor and register it on ``block`` as
        ``attr``: a buffer for an aux state, else an ``nn.Parameter``;
        uninitialized while the shape has a 0."""
        self._owner = (weakref.ref(block), attr)
        dtype = _dtype_of(self.dtype)
        known = self._shape is not None and all(s > 0 for s in self._shape)
        if _is_aux(self.name, self._grad_req):
            t = torch.empty(self._shape, device=device, dtype=dtype) \
                if known else UninitializedBuffer(device=device, dtype=dtype)
            block.register_buffer(attr, t)
        else:
            requires_grad = self._grad_req != "null"
            t = torch.nn.Parameter(
                torch.empty(self._shape, device=device, dtype=dtype),
                requires_grad) if known else UninitializedParameter(
                    requires_grad, device=device, dtype=dtype)
            block.register_parameter(attr, t)

    def _block_and_attr(self):
        if self._owner is None:
            raise RuntimeError("Parameter '%s' belongs to no block"
                               % self.name)
        block = self._owner[0]()
        if block is None:
            raise RuntimeError("the block of Parameter '%s' is gone"
                               % self.name)
        return block, self._owner[1]

    def _tensor(self):
        """The tensor registered on the owning block (possibly still
        uninitialized)."""
        block, attr = self._block_and_attr()
        t = block._parameters.get(attr)
        return block._buffers[attr] if t is None else t

    def _is_lazy(self):
        return isinstance(self._tensor(), _LAZY)

    def _check_and_get(self):
        t = self._tensor()
        if not isinstance(t, _LAZY):
            return t
        if self._deferred_init:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass." % self.name)
        raise RuntimeError(
            "Parameter '%s' has not been initialized. You should initialize "
            "parameters and create Trainer with Block.collect_params() "
            "instead of Block.params." % self.name)

    # ------------------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be 'write', 'add' or 'null', got "
                             "%r" % (req,))
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        if self._owner is not None:
            t = self._tensor()
            if isinstance(t, torch.nn.Parameter):
                t.requires_grad_(req != "null")
                if req == "null":
                    t.grad = None

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is not None and not (
                len(self._shape) == len(new_shape) and
                all(j in (0, i) for i, j in zip(new_shape, self._shape))):
            raise AssertionError(
                "Expected shape %s is incompatible with given shape %s."
                % (str(new_shape), str(self._shape)))
        self._shape = new_shape

    # ------------------------------------------------------------------
    def initialize(self, init=None, ctx=None,
                   default_init=init_mod.Uniform(), force_reinit=False):
        """Draw this parameter's values now, or at the block's first call
        when its shape waits for it.  ``ctx`` (a device or a list of one)
        defaults to the device the block was built on."""
        if self._initialized and not force_reinit:
            warnings.warn("Parameter '%s' is already initialized, ignoring. "
                          "Set force_reinit=True to re-initialize."
                          % self.name, stacklevel=2)
            return
        self._initialized = False
        if init is None:
            init = default_init if self.init is None else self.init
        device = self._device(ctx)
        if self.shape is None or any(s == 0 for s in self.shape):
            if self._allow_deferred_init:
                self._deferred_init = (init, device, default_init, None)
                return
            raise ValueError("Cannot initialize Parameter '%s' because it has "
                             "invalid shape: %s." % (self.name,
                                                     str(self.shape)))
        self._deferred_init = (init, device, default_init, None)
        self._finish_deferred_init()

    def _device(self, ctx):
        if isinstance(ctx, (list, tuple)):
            if len(set(map(str, ctx))) > 1:
                raise MXNetError("the port keeps a parameter on one device, "
                                 "got %s" % (ctx,))
            ctx = ctx[0]
        return self._tensor().device if ctx is None else resolve_device(ctx)

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init_, device, default_init, data = self._deferred_init
        self._deferred_init = ()
        if self.shape is None or not all(s > 0 for s in self.shape):
            raise AssertionError("Cannot initialize Parameter '%s' because it "
                                 "has invalid shape: %s."
                                 % (self.name, str(self.shape)))
        if data is None:
            draw_shape = self.shape
            if self.init_perm is not None:
                draw_shape = tuple(self.shape[self.init_perm.index(j)]
                                   for j in range(len(self.shape)))
            arr = NDArray(torch.zeros(draw_shape, dtype=_dtype_of(self.dtype)))
            initializer = init_mod.create(
                init_ if init_ is not None else (self.init or default_init))
            initializer(init_mod.InitDesc(self.name), arr)
            data = arr._data
            if self.init_perm is not None:
                data = data.permute(self.init_perm)
        self._init_impl(data, device)

    def _init_impl(self, data, device):
        """Make ``data`` (a tensor) this parameter's values on ``device``,
        in this parameter's dtype, in the tensor object the block holds."""
        t = self._tensor()
        value = data.to(device=device, dtype=_dtype_of(self.dtype))
        with torch.no_grad():
            if isinstance(t, _LAZY):
                t.materialize(tuple(value.shape), device=device,
                              dtype=value.dtype)
            if t.device == value.device and t.dtype == value.dtype \
                    and t.shape == value.shape:
                t.copy_(value)
            else:
                t.data = value.contiguous().clone()
        self._shape = tuple(t.shape)
        self._initialized = True

    def _load_init(self, data, ctx=None, prefer_canonical=False):
        """Set this parameter from checkpoint ``data``; ``prefer_canonical``
        says the data is in the canonical (NCHW) layout, to be permuted into
        a channel-last parameter's stored layout even where its shape fits
        both ways."""
        data = _as_tensor(data)
        if self.shape:
            def _fits(shape):
                return (len(shape) == len(self.shape) and
                        all(s in (0, d) for s, d in zip(self.shape, shape)))
            perm = self.init_perm
            permuted_fits = perm is not None and _fits(
                tuple(data.shape[j] for j in perm))
            if permuted_fits and (prefer_canonical or not _fits(data.shape)):
                data = data.permute(perm)
            elif not _fits(tuple(data.shape)):
                raise AssertionError(
                    "Failed loading Parameter '%s' from saved params: shape "
                    "incompatibility (%s vs %s)" % (self.name, self.shape,
                                                    tuple(data.shape)))
        self._deferred_init = ()
        self._init_impl(data, self._device(ctx))

    def set_data(self, data):
        """Set the values; on a deferred parameter they are kept for its
        first call."""
        data = _as_tensor(data)
        self.shape = tuple(data.shape)
        if self._is_lazy():
            if not self._deferred_init:
                raise AssertionError("Parameter '%s' has not been initialized"
                                     % self.name)
            self._deferred_init = self._deferred_init[:3] + (data,)
            return
        self._init_impl(data, self._tensor().device)

    def data(self, ctx=None):
        """An NDArray over the parameter's tensor (read it; write with
        :meth:`set_data`)."""
        return NDArray(self._check_and_get())

    def grad(self, ctx=None):
        """An NDArray over the last gradient written (zeros before the first
        backward)."""
        t = self._check_and_get()
        if self.grad_req == "null":
            raise RuntimeError("Cannot get gradient array for Parameter '%s' "
                               "because grad_req='null'" % self.name)
        if t.grad is None:
            return NDArray(torch.zeros_like(t.detach()))
        return NDArray(t.grad)

    def zero_grad(self):
        t = self._tensor()
        if not isinstance(t, _LAZY) and t.grad is not None:
            t.grad.zero_()

    def _reduce(self):
        """The values, for saving (one device: the tensor itself)."""
        return self._check_and_get().detach()

    def cast(self, dtype):
        """Change the dtype, keeping the tensor object (a deferred parameter
        materializes in the new dtype)."""
        self.dtype = dtype
        if self._owner is None or self._is_lazy():
            return
        block, attr = self._block_and_attr()
        t = self._tensor()
        torch_dtype = _dtype_of(dtype)
        if attr in block._buffers:
            block._buffers[attr] = t.to(torch_dtype)
        else:
            cast(t, torch_dtype)


class ParameterDict:
    """Parameters by their full names, with a prefix for new ones
    (``get``), and the operations Gluon runs over a block's parameters."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __getitem__(self, key):
        return self._params[key]

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        return "%s(\n%s\n)" % (name, "\n".join(" " + repr(v)
                                                for v in self.values()))

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, key):
        return key in self._params

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    @staticmethod
    def _merge_shapes(requested, stored):
        """Unify two partly known shapes (0 = unknown); None where a known
        dimension disagrees."""
        if requested is None or len(requested) != len(stored):
            return None
        merged = []
        for want, have in zip(requested, stored):
            if 0 in (want, have):
                merged.append(want or have)
            elif want == have:
                merged.append(want)
            else:
                return None
        return tuple(merged)

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``: the existing one (its attributes
        checked against ``kwargs``, partly known shapes unified), or a new
        one made from ``kwargs``."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = self._params[name] = Parameter(name, **kwargs)
            return param
        for attr, want in kwargs.items():
            have = getattr(param, attr, None)
            if have is None:
                setattr(param, attr, want)
                continue
            if attr == "shape":
                merged = self._merge_shapes(want, have)
                if merged is not None:
                    param._shape = merged
                    continue
            if want is not None and want != have:
                raise AssertionError(
                    "Parameter '%s' already exists with %s=%s; cannot "
                    "re-request it with %s=%s." % (name, attr, have, attr,
                                                   want))
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params:
                if self._params[k] is not v:
                    raise AssertionError(
                        "Cannot update self with other because they have "
                        "different Parameters with the same name '%s'" % k)
            else:
                self._params[k] = v

    def initialize(self, init=init_mod.Uniform(), ctx=None, verbose=False,
                   force_reinit=False):
        if verbose:
            init.set_verbosity(verbose=verbose)
        for _, v in self.items():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        from ..ndarray import utils
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix '%s' is to be stripped before saving, but "
                    "Parameter's name '%s' does not start with '%s'."
                    % (strip_prefix, param.name, strip_prefix))
            arg_dict[param.name[len(strip_prefix):]] = param._reduce()
        utils.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from ..ndarray import utils
        if restore_prefix:
            for name in self.keys():
                if not name.startswith(restore_prefix):
                    raise AssertionError(
                        "restore_prefix is '%s' but Parameter name '%s' does "
                        "not start with it" % (restore_prefix, name))
        lprefix = len(restore_prefix)
        loaded = utils.load_numpy(filename)
        arg_dict = {restore_prefix + k.split(":", 1)[-1]: v
                    for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise AssertionError("Parameter '%s' is missing in file "
                                         "'%s'" % (name[lprefix:], filename))
        for name in arg_dict:
            if name not in self._params:
                if not ignore_extra:
                    raise AssertionError(
                        "Parameter '%s' loaded from file '%s' is not present "
                        "in this ParameterDict" % (name[lprefix:], filename))
                continue
            self[name]._load_init(arg_dict[name], ctx)


# ---------------------------------------------------------------------------
# dtype changes of a registered tensor

# per parameter, the live objects whose hook() runs after a cast changes its
# dtype (keys and values held weakly)
_cast_watchers = WeakIdKeyDictionary()


def watch_cast(param, watcher):
    """Call ``watcher.hook()`` each time :func:`cast` changes ``param``'s
    dtype, for as long as ``watcher`` lives."""
    _cast_watchers.setdefault(param, weakref.WeakSet()).add(watcher)


def cast(param, dtype):
    """Change the ``nn.Parameter`` ``param``'s data, and its gradient where
    it has one, to ``dtype``, keeping the same object: a Trainer built
    before the cast still holds it.  Torch gives a parameter whose dtype
    changes a new gradient accumulator, so the Trainer's gradient-write
    hooks are set again on that one (:func:`watch_cast`)."""
    dtype = as_dtype(dtype)
    if param.dtype == dtype:
        return param
    with torch.no_grad():
        param.data = param.data.to(dtype)
        if param.grad is not None:
            param.grad = param.grad.to(dtype)
    for watcher in list(_cast_watchers.get(param, ())):
        watcher.hook()
    return param
