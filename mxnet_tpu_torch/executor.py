"""Executor: a bound Symbol graph (counterpart of ``mxnet_tpu/executor.py``).

The DAG runs as one function of its argument and auxiliary arrays through
a ``cached_op.CachedOp``: on the card each mode is one CUDA graph, and
``forward(is_train=True)`` records one tape node whose backward replays
the captured backward (the reference's GraphExecutor forward and backward
over cached engine ops).  Every bound array, argument or auxiliary, is
one of the op's parameters: the graph reads it (and writes the aux) in
place, as the reference's executor runs in its bound memory, so a call
copies nothing in.  New data is written into the bound arrays
(``forward(**kwargs)``, ``copy_params_from``); an array rebound to other
storage makes the op capture again.  On the CPU the DAG runs eagerly on
every call.

In training, each ``BatchNorm`` node folds its batch statistics into its
moving-statistics aux arrays in place (``moving = moving * momentum +
batch * (1 - momentum)``, the variance from the op's ``invstd`` as the JAX
executor folds it), which a captured forward does inside the graph.
``group2ctx`` placement is not ported and raises.
"""
from __future__ import annotations

import torch

from . import autograd
from .base import MXNetError
from .cached_op import CachedOp
from .context import resolve_device
from .ndarray.ndarray import NDArray
from .ops.nn_ops import BN_EPS_DEFAULT
from .ops.registry import get_op

__all__ = ["Executor", "graph_function"]

# ops whose training outputs (out, mean, invstd) fold into the aux inputs
# [3] = moving_mean and [4] = moving_var
_BN_AUX_OPS = frozenset(("BatchNorm",))


def _tensor(v, like):
    """``v`` (an NDArray, tensor or array-like) as a tensor on ``like``'s
    device and dtype."""
    if isinstance(v, NDArray):
        v = v._data.detach()
    elif not isinstance(v, torch.Tensor):
        from .base import tensor_from_numpy
        import numpy as np
        v = tensor_from_numpy(np.asarray(v))
    return v.to(like.device, like.dtype)


def graph_function(symbol, arg_names, aux_names, is_train, device=None):
    """``symbol``'s DAG as ``fn(arg_vals, aux_vals) -> [outputs]``, the
    values tensors in ``arg_names``/``aux_names`` order, each op run by
    its registered function in topological order (a kernel wrapper on
    CUDA tensors launches its kernel).  An op with no inputs (``_zeros``,
    ``_arange``) makes its output on the first value's device, or on
    ``device`` in a graph of no arguments.  In
    training, each BatchNorm node folds its batch statistics into its
    moving-statistics aux tensors in place."""
    nodes = symbol._topo_nodes()
    arg_order = {n: i for i, n in enumerate(arg_names)}
    aux_order = {n: i for i, n in enumerate(aux_names)}
    plan = []
    for n in nodes:
        if n.op is None:
            continue
        op = get_op(n.op)
        attrs = {k: v for k, v in n.attrs.items()
                 if not k.startswith("__") and k != "ctx_group"}
        if op.mode_for(attrs):
            attrs["_training"] = is_train
        fold = None
        if is_train and n.op in _BN_AUX_OPS and len(n.inputs) >= 5 \
                and not attrs.get("use_global_stats", False):
            mm, mv = n.inputs[3][0].name, n.inputs[4][0].name
            if mm in aux_order and mv in aux_order:
                fold = (aux_order[mm], aux_order[mv],
                        float(attrs.get("momentum", 0.9)),
                        float(attrs.get("eps", BN_EPS_DEFAULT)))
        plan.append((n, op, attrs, fold))

    def fn(arg_vals, aux_vals):
        env = {}
        for n in nodes:
            if n.op is None:
                env[(id(n), 0)] = aux_vals[aux_order[n.name]] \
                    if n.attrs.get("__is_aux__") \
                    else arg_vals[arg_order[n.name]]
        for n, op, attrs, fold in plan:
            in_vals = [env[(id(inp), idx)] for (inp, idx) in n.inputs]
            if not in_vals:
                first = list(arg_vals[:1]) + list(aux_vals[:1])
                attrs = dict(attrs, _device=first[0].device if first
                             else device)
            out = op.apply(attrs, *in_vals)
            outs = out if isinstance(out, (tuple, list)) else [out]
            for i, o in enumerate(outs):
                env[(id(n), i)] = o
            if fold is not None:
                mm, mv, m, eps = fold
                with torch.no_grad():
                    mean = outs[1].detach()
                    var = outs[2].detach().square().reciprocal() - eps
                    for i, batch in ((mm, mean), (mv, var)):
                        a = aux_vals[i]
                        a.copy_(a * m + batch * (1 - m))
        return [env[(id(n), idx)] for (n, idx) in symbol._entries]

    return fn


def write_into(dst, src):
    """Copy ``src`` into the NDArray ``dst`` in place where the shapes and
    dtypes agree (so a graph that reads ``dst``'s storage sees it), else
    rebind ``dst``'s buffer."""
    src = _tensor(src, dst._data)
    with torch.no_grad():
        if src.shape == dst._data.shape:
            buf = dst._data
            buf.copy_(src)
            dst._data = buf   # a new version for views of dst
        else:
            dst._set_data(src.clone())


class Executor:
    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None):
        if group2ctx:
            raise MXNetError("group2ctx (manual model parallelism) is not "
                             "ported yet")
        self._symbol = symbol
        self._ctx = resolve_device(ctx)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            args = dict(zip(self.arg_names, args))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self.aux_names, aux_states))
        self.arg_dict = {n: v if isinstance(v, NDArray) else
                         NDArray(_tensor(v, torch.empty(
                             0, device=self._ctx)))
                         for n, v in dict(args).items()}
        self.aux_dict = dict(aux_states or {})
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(self.arg_names, args_grad))
        self.grad_dict = dict(args_grad) if args_grad else {}
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        else:
            self.grad_req = dict(grad_req)
        missing = [n for n in self.arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError("bind: no array for arguments %s" % missing)
        self.outputs = []
        self._fns = {}
        self._cops = {}
        self._pending = None

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self.aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    # ------------------------------------------------------------------
    def _build_fn(self, is_train):
        """The DAG as ``fn(arg_vals, aux_vals) -> outputs``
        (:func:`graph_function`), made once per mode."""
        fn = self._fns.get(is_train)
        if fn is None:
            fn = self._fns[is_train] = graph_function(
                self._symbol, self.arg_names, self.aux_names, is_train,
                self._ctx)
        return fn

    def _cached_op(self, is_train):
        cop = self._cops.get(is_train)
        if cop is None:
            fn = self._build_fn(is_train)
            arg_names, aux_names = self.arg_names, self.aux_names

            def forward_fn(vals):
                return fn([vals["arg:" + n] for n in arg_names],
                          [vals["aux:" + n] for n in aux_names])

            cop = CachedOp(forward_fn, self._bound_tensors(),
                           aux_names=["aux:" + n for n in aux_names])
            self._cops[is_train] = cop
        return cop

    def _bound_tensors(self):
        """``{"arg:name" | "aux:name": tensor}``: aliases of the bound
        arrays' storage, the CachedOp's parameters."""
        vals = {"arg:" + n: self.arg_dict[n]._data.detach()
                for n in self.arg_names}
        vals.update(("aux:" + n, self.aux_dict[n]._data.detach())
                    for n in self.aux_names)
        return vals

    def forward(self, is_train=False, **kwargs):
        """Run the graph; with ``is_train`` in training mode, recording
        for :meth:`backward` the arguments whose ``grad_req`` is not
        ``'null'``.  Keyword arrays are written into the arguments
        first."""
        for k, v in kwargs.items():
            if k in self.arg_dict:
                write_into(self.arg_dict[k], v)
        wrt = [n for n in self.arg_names
               if self.grad_req.get(n, "null") != "null"] if is_train else []
        vals = self._bound_tensors()
        # the arguments taking a gradient: leaves that alias their storage
        leaves = [vals["arg:" + n].requires_grad_() for n in wrt]
        with autograd._RecordingStateScope(bool(wrt), is_train):
            outs = self._cached_op(is_train)(vals)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        self._pending = (outs, leaves, wrt) if wrt else None
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last training forward's outputs (head
        gradients ``out_grads``, ones by default) into ``grad_dict``,
        written or added as each argument's ``grad_req`` says."""
        if self._pending is None:
            raise MXNetError("must call forward(is_train=True) before "
                             "backward")
        outs, leaves, wrt = self._pending
        self._pending = None
        if out_grads is None:
            cts = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, (NDArray, torch.Tensor)):
                out_grads = [out_grads]
            cts = [_tensor(g, o) for g, o in zip(out_grads, outs)]
        pairs = [(o, g) for o, g in zip(outs, cts) if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                    [g for _, g in pairs], allow_unused=True)
        for name, leaf, g in zip(wrt, leaves, grads):
            if g is None:
                g = torch.zeros_like(leaf)
            req = self.grad_req.get(name, "write")
            cur = self.grad_dict.get(name)
            if cur is None:
                self.grad_dict[name] = NDArray(g)
            elif req == "add":
                cur._set_data(cur._data + g)
            else:
                cur._set_data(g)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, array in arg_params.items():
            if name in self.arg_dict:
                write_into(self.arg_dict[name], array)
            elif not allow_extra_params:
                raise ValueError("Find name \"%s\" that is not in the "
                                 "arguments" % name)
        for name, array in (aux_params or {}).items():
            if name in self.aux_dict:
                write_into(self.aux_dict[name], array)
            elif not allow_extra_params:
                raise ValueError("Find name \"%s\" that is not in the "
                                 "auxiliary states" % name)

    def debug_str(self):
        return "Executor(symbol=%s, args=%s)" % (self._symbol.name,
                                                 self.arg_names)
