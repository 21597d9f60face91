"""Blocks (counterpart of ``mxnet_tpu/gluon/block.py``).

:class:`Block` is the ``torch.nn.Module`` every layer, loss and model of
the port derives from, with Gluon's parameter model on top:

- names: a block's ``prefix``/``name`` and its ``params``
  (``ParameterDict``) come from ``_BlockScope`` (:60-90) as in the JAX
  package: a top-level block is numbered by ``name.current()``, a child
  made inside its parent's ``name_scope()`` by the parent's counter, and
  ``prefix=""`` blocks are transparent;
- parameters: assigning a ``gluon.parameter.Parameter`` to an attribute
  registers its tensor on the module under that name (see
  ``parameter.py``); ``collect_params(select)``,
  ``_collect_params_with_prefix`` (structural names, ``features.0.weight``),
  ``initialize(init, ctx)``, ``save_parameters``/``load_parameters`` and
  ``save_params``/``load_params`` (:191-250);
- deferred shapes: a call with parameters still waiting for their shape
  runs the layer's ``_shape_hook`` and finishes their initialization first
  (``_finish_deferred``, :418-424);
- ``Block.cast`` (:259-263) and Gluon's boundary for NDArrays (:265,
  :378-384): a block called with NDArray arguments runs on their tensors
  and returns NDArrays; called with tensors it returns tensors.

Hybridization (:255, :320-400, :537-560): ``hybridize()`` recurses into
the children; a :class:`HybridBlock` made active runs its whole forward
through one ``cached_op.CachedOp`` (:func:`build_cached_op`, the one place
that decides which parameters are aux): captured into a CUDA graph per
input signature on the card, run eagerly on the CPU.  Inside a cached
forward the children run eagerly, so the outermost active block owns the
graph.  ``export`` and ``SymbolBlock`` are not ported yet: they need the
layers to trace into ``sym.*``.

The functional API (:562-630): :func:`functional_call`,
:func:`param_values`, :func:`split_param_names` and
:func:`_with_param_override` run a block as a pure function of its
parameter values, keyed by the parameters' Gluon names.
"""
from __future__ import annotations

import re
import threading

from torch import nn

from .. import autograd
from .. import random as _random
from ..base import as_dtype
from ..ndarray.ndarray import NDArray
from . import parameter
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "build_cached_op", "functional_call",
           "param_values", "split_param_names"]


class _BlockScope:
    """Name scoping of nested blocks."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """A new block's (prefix, ParameterDict) in the enclosing scope:
        top-level blocks are numbered by ``name.current()``, nested ones by
        the parent scope's counter."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            from ..name import current as current_names
            if prefix is None:
                prefix = current_names().get(None, hint) + "_"
            params = ParameterDict(prefix) if params is None \
                else ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            counter = current._block._child_counter
            count = counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        from ..name import Prefix
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        self._name_scope = Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


def _materialize_for_load(block, state_dict, prefix, *args):
    """A ``load_state_dict`` pre-hook: a deferred parameter takes its shape
    from the array loaded into it."""
    for attr, p in block._reg_params.items():
        key = prefix + attr
        if key in state_dict:
            value = state_dict[key]
            if p._is_lazy():
                p.shape = tuple(value.shape)
                t = p._tensor()
                t.materialize(tuple(value.shape), device=t.device,
                              dtype=parameter._dtype_of(p.dtype))
            p._deferred_init = ()
            p._initialized = True


class Block(nn.Module):
    """An ``nn.Module`` with Gluon's names, parameters, deferred shapes,
    ``cast`` and NDArray boundary."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        # per-hint numbering of the children made in name_scope(); the
        # scope object is made per use, so that the block holds no
        # reference to itself and is freed as soon as it is dropped
        self._child_counter = {}
        self._reg_params = {}
        # Gluon parameters whose tensors may still be uninitialized
        self._lazy_params = []
        self._register_load_state_dict_pre_hook(_materialize_for_load,
                                                with_module=True)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return _BlockScope(self)

    @property
    def params(self):
        return self._params

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            if name in self._reg_params:
                raise AssertionError("Overriding Parameter attribute %s is "
                                     "not allowed." % name)
            self._reg_params[name] = value
            value._attach(self, name, self._device)
            if value._is_lazy():
                self._lazy_params.append(value)
            return
        super().__setattr__(name, value)

    # the device the block's tensors are made on (set by the layers that
    # hold parameters, from their ``device`` argument)
    _device = None

    def collect_params(self, select=None):
        """This block's and its children's parameters, by full name; with
        ``select``, those whose name the regular expression matches."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for child in self._modules.values():
            if isinstance(child, Block):
                ret.update(child.collect_params(select=select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter (``init`` defaults to ``Uniform``) on
        ``ctx``, by default the device the block was built on; parameters
        whose shape waits for the first call draw then."""
        from ..initializer import Uniform
        self.collect_params().initialize(init or Uniform(), ctx, verbose,
                                         force_reinit)

    def save_parameters(self, filename):
        """Write the parameters under their structural names
        (``features.0.weight``) in the ``.params`` format."""
        from ..ndarray import utils
        params = self._collect_params_with_prefix()
        utils.save(filename, {key: val._reduce()
                              for key, val in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Load what :meth:`save_parameters` wrote (or, for a file of full
        Gluon names, what ``collect_params().save`` wrote), onto ``ctx`` or
        the device the block was built on."""
        from ..ndarray import utils
        loaded = utils.load_numpy(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not any("." in i for i in loaded.keys()):
            del loaded
            self.collect_params().load(filename, ctx, allow_missing,
                                       ignore_extra, self.prefix)
            return
        if not allow_missing:
            for name in params.keys():
                if name not in loaded:
                    raise AssertionError("Parameter '%s' is missing in file "
                                         "'%s'" % (name, filename))
        for name in loaded:
            if not ignore_extra and name not in params:
                raise ValueError("Parameter '%s' loaded from file '%s' is not "
                                 "present in this block" % (name, filename))
            if name in params:
                params[name]._load_init(loaded[name], ctx)

    save_params = save_parameters

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.load_parameters(filename, ctx, allow_missing, ignore_extra)

    def _finish_deferred(self, *args):
        """Infer the unknown dimensions from the inputs and finish the
        deferred initializations (the reference's ``_finish_deferred``)."""
        self._lazy_params = [p for p in self._lazy_params if p._is_lazy()]
        if not self._lazy_params:
            return
        tensors = [a._data if isinstance(a, NDArray) else a for a in args]
        if hasattr(self, "_shape_hook"):
            self._shape_hook(*tensors)
        for p in self._reg_params.values():
            if p._is_lazy():
                if not p._deferred_init:
                    p._check_and_get()   # raises: never initialized
                p._finish_deferred_init()
        self._lazy_params = []

    def __call__(self, *args, **kwargs):
        if self._lazy_params:
            self._finish_deferred(*args)
        if not any(isinstance(a, NDArray) for a in args):
            return super().__call__(*args, **kwargs)
        out = super().__call__(*(a._data if isinstance(a, NDArray) else a
                                 for a in args), **kwargs)
        if isinstance(out, (tuple, list)):
            return type(out)(NDArray(o) for o in out)
        return NDArray(out)

    def hybridize(self, active=True, **kwargs):
        """Hybridize the children (a plain block has no cache of its
        own)."""
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast the children (by their own rule), then this block's own
        parameters and floating-point buffers (BatchNorm's running
        statistics, which Gluon keeps as parameters), to ``dtype``: a name
        such as ``"bfloat16"``, a numpy or a torch dtype.  A deferred
        parameter materializes in ``dtype``."""
        dtype = as_dtype(dtype)
        for child in self.children():
            if isinstance(child, Block):
                child.cast(dtype)
            else:
                Block.cast(child, dtype)
        gluon = getattr(self, "_reg_params", {})
        for p in gluon.values():
            p.cast(dtype)
        for name, param in self._parameters.items():
            if param is not None and name not in gluon:
                parameter.cast(param, dtype)
        for name, buf in self._buffers.items():
            if buf is not None and name not in gluon \
                    and buf.is_floating_point():
                self._buffers[name] = buf.to(dtype)
        return self


# ---------------------------------------------------------------------------
# hybridization

_TRACE = threading.local()


class _CachedForward:
    """Marks this thread as inside a CachedOp's forward: active blocks
    called there run eagerly, in the graph their outermost block owns."""

    def __enter__(self):
        _TRACE.depth = getattr(_TRACE, "depth", 0) + 1

    def __exit__(self, *exc):
        _TRACE.depth -= 1


def _in_cached_forward():
    return getattr(_TRACE, "depth", 0) > 0


class HybridBlock(Block):
    """A block whose forward can run as one ``CachedOp``
    (``mxnet_tpu/gluon/block.py:320``): after ``hybridize()`` a call goes
    through the op, captured per input signature on the card."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None
        self._cached_param_vals = None

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, HybridBlock):
            self._clear_cached_op()

    def hybridize(self, active=True, **kwargs):
        """Make this block's calls (``active``) go through one CachedOp,
        dropping the one it had.  Recurses into the children.  MXNet's
        ``static_alloc`` and ``static_shape`` are accepted in ``kwargs``
        and ignored: a captured graph's memory and shapes are static
        already."""
        self._active = active
        self._clear_cached_op()
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._clear_cached_op()
        return super().cast(dtype)

    def _clear_cached_op(self):
        self._cached_op = None
        self._cached_param_vals = None

    def _build_cache(self):
        self._cached_op, params = build_cached_op(self)
        self._cached_param_vals = {n: p._check_and_get()
                                   for n, p in params.items()}

    def hybrid_call(self, *args, **kwargs):
        """The eager forward, whether or not the block is active."""
        return Block.__call__(self, *args, **kwargs)

    def __call__(self, *args, **kwargs):
        if not self._active or kwargs or _in_cached_forward():
            return Block.__call__(self, *args, **kwargs)
        if self._cached_op is None:
            params = self.collect_params().values()
            if any(p._is_lazy() for p in params):
                # shapes wait for this call: run it eagerly, then build
                out = Block.__call__(self, *args)
                self._build_cache()
                return out
            self._build_cache()
        return self._cached_op(self._cached_param_vals, *args)


def build_cached_op(block):
    """A CachedOp over ``block``'s whole forward, and its ``{name:
    Parameter}``: the one construction point (``hybridize`` and the
    serving registry), and the one place that decides which parameters are
    aux: ``grad_req='null'`` ones named as running or moving statistics,
    which a training call writes in place."""
    from ..cached_op import CachedOp
    params = {p.name: p for p in block.collect_params().values()}
    aux_names = [name for name, p in params.items() if p.grad_req == "null"
                 and ("running" in name or "moving" in name)]
    call = block.hybrid_call if isinstance(block, HybridBlock) \
        else block.__call__

    def forward_fn(param_vals, *inputs):
        with _CachedForward():
            return _with_param_override(block, params, param_vals,
                                        lambda: call(*inputs))

    cop = CachedOp(forward_fn, {n: p._check_and_get()
                                for n, p in params.items()}, aux_names)
    return cop, params


# ---------------------------------------------------------------------------
# the functional API

def _with_param_override(block, params, param_vals, thunk):
    """Run ``thunk`` with each parameter of ``params`` (Gluon name ->
    Parameter) replaced on its block by ``param_vals[name]`` (a tensor),
    then put the block's own tensors back."""
    saved = []
    try:
        for name, p in params.items():
            owner, attr = p._block_and_attr()
            table = owner._buffers if attr in owner._buffers \
                else owner._parameters
            saved.append((table, attr, table[attr]))
            table[attr] = param_vals[name]
        return thunk()
    finally:
        for table, attr, t in saved:
            table[attr] = t


def functional_call(block, param_vals, *input_vals, training=False,
                    rng_key=None):
    """Run ``block``'s forward as a pure function of ``param_vals`` (Gluon
    name -> tensor, every parameter of ``block``) and ``input_vals``
    (tensors).  Returns ``(outputs tuple, aux dict)``: the aux entries are
    the ``grad_req='null'`` parameters after the call, BatchNorm's running
    statistics folded in training.

    Pure: neither the block's tensors nor the caller's are written (the
    aux inputs are cloned first, since BatchNorm folds its statistics in
    place).  ``training=True`` is train mode, as the reference's
    ``_RecordingStateScope(False, training)``; gradients are torch's, so
    recording is left to the caller's grad mode, under which
    ``torch.autograd`` differentiates the outputs with respect to the
    values given.  ``rng_key`` (two ``uint32`` words; default the key of
    seed 0) scopes ``random.next_key``."""
    params = {p.name: p for p in block.collect_params().values()}
    missing = sorted(set(params) - set(param_vals))
    if missing:
        raise KeyError("functional_call needs every parameter of the block; "
                       "missing %s" % missing)
    vals = {}
    aux_names = []
    for name, p in params.items():
        v = param_vals[name]
        v = v._data if isinstance(v, NDArray) else v
        if p.grad_req == "null":
            aux_names.append(name)
            v = v.clone()
        vals[name] = v
    inputs = [i._data if isinstance(i, NDArray) else i for i in input_vals]
    key = _random.prng_key(0) if rng_key is None else rng_key
    with autograd._RecordingStateScope(None, training), \
            _random.key_override(key):
        out = _with_param_override(block, params, vals,
                                   lambda: block(*inputs))
    outs = out if isinstance(out, (list, tuple)) else [out]
    return tuple(outs), {n: vals[n] for n in aux_names}


def split_param_names(block):
    """``(trainable, frozen)`` parameter names, each sorted: ``frozen`` is
    every ``grad_req == 'null'`` parameter (BatchNorm's running statistics
    and frozen weights)."""
    params = block.collect_params()
    frozen = sorted(n for n, p in params.items() if p.grad_req == "null")
    frozen_set = set(frozen)
    return sorted(n for n in params if n not in frozen_set), frozen


def param_values(block, dtype=None):
    """``{Gluon name: tensor}`` of an initialized block: detached views of
    its tensors (copy before writing them in place), floating ones cast to
    ``dtype`` when given."""
    vals = {}
    for name, p in block.collect_params().items():
        v = p._check_and_get().detach()
        if dtype is not None and v.is_floating_point():
            v = v.to(as_dtype(dtype))
        vals[name] = v
    return vals

