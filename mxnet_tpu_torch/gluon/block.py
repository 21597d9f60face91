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
graph; an active child still scopes the keys of its random ops as the JAX
package's nested CachedOp does (one ``random.next_key()`` a call, split
inside).

Symbols (:31-57, :378-460): a :class:`HybridBlock` called with a
``Symbol`` builds a graph instead of computing: ``_build_symbol`` runs the
layer's ``hybrid_forward(F, x, *args, **params)`` with ``F`` the port's
``symbol`` module and each parameter's ``var()``, inside a
:class:`_TraceNames` scope of the block's prefix, so the nodes get the JAX
package's names (a block with no parameters of its own traces its
``forward``).  The eager and captured paths keep their torch
``forward``.  ``HybridBlock.export`` writes ``-symbol.json`` and
``.params`` from one traced input, ``data`` (:430-444), and
:class:`SymbolBlock` runs such a graph (:462-533) op by op, hybridized
from the start: its own CachedOp captures a CUDA graph per input
signature on the card, and inside an enclosing cached forward the ops run
in that capture.

The functional API (:562-630): :func:`functional_call`,
:func:`param_values`, :func:`split_param_names` and
:func:`_with_param_override` run a block as a pure function of its
parameter values, keyed by the parameters' Gluon names.
"""
from __future__ import annotations

import re
import threading

import torch
from torch import nn

from .. import autograd
from .. import random as _random
from ..base import MXNetError, as_dtype
from ..context import resolve_device
from ..name import NameManager, Prefix
from ..ndarray.ndarray import NDArray
from ..symbol.symbol import Symbol
from . import parameter
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "build_cached_op",
           "functional_call", "param_values", "split_param_names"]


class _TraceNames(Prefix):
    """A prefix name manager that keeps node names unique across one
    symbolic trace (``mxnet_tpu/gluon/block.py:31-57``).  Sibling blocks
    may share a prefix (``prefix=""`` children), and layers name their
    nodes with fixed hints such as ``fwd``: a later duplicate gets
    ``_1``, ``_2``, ..."""

    def __init__(self, prefix, seen):
        super().__init__(prefix)
        self._seen = seen

    @classmethod
    def nested(cls, prefix):
        """A manager for ``prefix`` sharing the enclosing trace's names."""
        current = getattr(NameManager._current, "value", None)
        seen = current._seen if isinstance(current, cls) else set()
        return cls(prefix, seen)

    def get(self, name, hint):
        base = super().get(name, hint)
        unique = base
        suffix = 0
        while unique in self._seen:
            suffix += 1
            unique = "%s_%d" % (base, suffix)
        self._seen.add(unique)
        return unique


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

    def summary(self, *inputs):
        """Print each parameter whose shape is known, and their total
        count, as the JAX block's table (:276-288); ``inputs`` are not
        used there either."""
        lines = []
        n_params = 0
        for name, p in self.collect_params().items():
            if p.shape and all(s > 0 for s in p.shape):
                cnt = 1
                for s in p.shape:
                    cnt *= s
                n_params += cnt
                lines.append("%-60s %s" % (name, str(p.shape)))
        lines.append("Total params: %d" % n_params)
        print("\n".join(lines))

    def register_child(self, block, name=None):
        """Register ``block`` as a child under ``name`` (default: the count
        of children so far), as the JAX block does (:229-232)."""
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)

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
        if args and isinstance(args[0], Symbol):
            return self._build_symbol(*args)
        if self._active and _in_cached_forward():
            # the JAX package calls an active child through a CachedOp of
            # its own, nested in the trace: one key a call, its random ops
            # splitting from that key
            with _random.key_override(_random.next_key()):
                return Block.__call__(self, *args, **kwargs)
        if not self._active or kwargs:
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

    def forward(self, *inputs, **kwargs):
        """The eager forward of a block written only as ``hybrid_forward``
        (as the JAX layers are): that function with ``F`` the registered
        ops over tensors (``ndarray.register.tensor_ops``) and its own
        parameters' tensors."""
        if type(self).hybrid_forward is HybridBlock.hybrid_forward:
            raise NotImplementedError("%s defines neither forward nor "
                                      "hybrid_forward" % type(self).__name__)
        from ..ndarray.register import tensor_ops
        kwargs.update((k, getattr(self, k)) for k in self._reg_params)
        return self.hybrid_forward(tensor_ops, *inputs, **kwargs)

    def hybrid_forward(self, F, *inputs, **params):
        """The layer as a function of ``F`` (the port's ``symbol`` module,
        or :data:`~..ndarray.register.tensor_ops` eagerly) and its
        parameters, as the JAX layer writes it.  The default serves a
        block with no parameters of its own whose ``forward`` only calls
        its children and Symbol's operators (``+``): that ``forward`` over
        the Symbols.  A layer that calls torch in ``forward`` writes its
        own."""
        if params:
            raise NotImplementedError(
                "%s has parameters of its own and no hybrid_forward"
                % type(self).__name__)
        return self.forward(*inputs)

    def _build_symbol(self, *inputs):
        """The graph of ``hybrid_forward`` over the Symbols ``inputs``,
        with the parameters entering as their ``var()``s and the nodes
        named in this block's prefix, unique across the trace."""
        from .. import symbol as sym_mod
        params = {k: v.var() for k, v in self._reg_params.items()}
        with _TraceNames.nested(self._prefix):
            return self.hybrid_forward(sym_mod, *inputs, **params)

    def export(self, path, epoch=0, remove_amp_cast=True):
        """Write ``path-symbol.json``, the graph traced from one input
        named ``data``, and ``path-%04d.params``, every parameter under
        ``arg:`` or, for the aux states, ``aux:`` and its full name.  A
        model of several inputs is traced by calling it with one
        ``sym.var`` each (``export`` traces one, as the JAX package's
        does)."""
        from .. import symbol as sym_mod
        from ..ndarray import utils
        out = self._build_symbol(sym_mod.var("data"))
        if isinstance(out, (list, tuple)):
            out = sym_mod.Group(list(out))
        out.save("%s-symbol.json" % path)
        arg_dict = {}
        for name, param in self.collect_params().items():
            kind = "aux:" if parameter._is_aux(name, param.grad_req) \
                else "arg:"
            arg_dict[kind + name] = param._reduce()
        utils.save("%s-%04d.params" % (path, epoch), arg_dict)


class SymbolBlock(HybridBlock):
    """A saved graph as a block (``mxnet_tpu/gluon/block.py:462-533``).

    Its parameters are the graph's arguments but ``inputs``, named as in
    the graph (the prefix is ``""``), and its auxiliary states, with
    ``grad_req='null'``; their tensors are made on ``device`` (default
    ``cuda:0``) when loaded.  ``forward`` runs the graph's ops in order
    (``executor.graph_function``, one per training mode).  The block
    starts hybridized, so a call goes through its CachedOp: one CUDA graph
    a signature on the card, dropped when a parameter changes storage, and
    no capture a call.  Inside an enclosing cached forward (the serving
    registry's) the ops run in that capture instead.  No gradient flows
    to the parameters (the JAX block binds with ``grad_req='null'``)."""

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of ``symbol_file`` over the inputs
        ``input_names``, its parameters loaded from ``param_file`` (keys
        with or without ``arg:``/``aux:``) onto ``ctx`` (default
        ``cuda:0``)."""
        from .. import symbol as sym_mod
        from ..ndarray import utils
        sym = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        inputs = [sym_mod.var(i) for i in input_names]
        ret = SymbolBlock(sym, inputs, device=ctx)
        if param_file is not None:
            loaded = {k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                      else k: v
                      for k, v in utils.load_numpy(param_file).items()}
            for name, param in ret.collect_params().items():
                if name in loaded:
                    param._load_init(loaded[name], ctx)
        return ret

    def __init__(self, outputs, inputs, params=None, device=None):
        super().__init__(prefix=None, params=params)
        # the graph's argument names are the parameters' names
        self._prefix = ""
        self._name = ""
        self._params = ParameterDict("", params)
        self._device = resolve_device(device)
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)):
            from .. import symbol as sym_mod
            outputs = sym_mod.Group(list(outputs))
        self._output_sym = outputs
        self._input_names = [i.name for i in inputs]
        self._arg_names = outputs.list_arguments()
        self._aux_names = outputs.list_auxiliary_states()
        for name in self._arg_names:
            if name not in self._input_names:
                self._own(self.params.get(name, allow_deferred_init=True))
        for name in self._aux_names:
            self._own(self.params.get(name, grad_req="null",
                                      allow_deferred_init=True))
        self._graph_fns = {}
        self._active = True

    def _own(self, param):
        """Register ``param``'s tensor on this block (under its name)
        unless another block holds it already."""
        if param._owner is None:
            param._attach(self, param.name, self._device)

    def _param_tensors(self):
        out = {}
        for name, p in self.params.items():
            try:
                out[name] = p._check_and_get()
            except (DeferredInitializationError, RuntimeError):
                raise MXNetError("SymbolBlock parameter %s is not "
                                 "initialized" % name)
        return out

    def forward(self, *args):
        from ..executor import graph_function
        training = autograd.is_training()
        fn = self._graph_fns.get(training)
        if fn is None:
            fn = self._graph_fns[training] = graph_function(
                self._output_sym, self._arg_names, self._aux_names, training)
        values = {n: t.detach() for n, t in self._param_tensors().items()}
        values.update(zip(self._input_names, args))
        outs = fn([values[n] for n in self._arg_names],
                  [values[n] for n in self._aux_names])
        return outs[0] if len(outs) == 1 else outs


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
    values given.  ``rng_key`` (default the key of seed 0) scopes
    ``random.next_key``, so the block's random ops split their keys from
    it as the JAX package's do: two ``uint32`` host words, or an ``int32``
    device tensor of the same bits (``random.key_tensor``), which a
    captured graph can take as its input."""
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

