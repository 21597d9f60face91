"""Symbol: the lazy graph-building API (counterpart of
``mxnet_tpu/symbol/symbol.py``).

A Symbol is a Python DAG of nodes (op name, attrs, input entries) over the
port's op registry, as in the JAX package.  ``bind``/``simple_bind`` make
an ``executor.Executor``, which runs the DAG through a ``CachedOp`` (one
CUDA graph per signature on the card).  Shape inference runs each op on
``meta`` tensors (the JAX package's ``jax.eval_shape``; an op whose
function launches a kernel takes its ``plain`` version there), with the
parameter shapes deduced from the data's first (``param_shape_fn``).  The
JSON keeps the reference's node-list schema, and the same construction
writes the same string in both packages; ``load_json`` upgrades legacy
graphs (the JAX package's table, kept here as its own copy).
"""
from __future__ import annotations

import ast
import json

import numpy as _np

import torch

from .. import ops as _ops  # noqa: F401  (registers the built-in ops)
from ..attribute import AttrScope
from ..base import MXNetError
from ..name import current as _current_names
from ..ops.registry import get_op

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones", "arange"]


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs")

    def __init__(self, op, name, attrs, inputs):
        self.op = op            # op name string, or None for variables
        self.name = name
        self.attrs = attrs      # dict
        self.inputs = inputs    # list of (Node, int)
        if op is None:
            self.num_outputs = 1
        else:
            self.num_outputs = get_op(op).n_outputs(attrs)


class Symbol:
    """An output list of graph nodes."""

    def __init__(self, entries):
        self._entries = list(entries)  # list of (_Node, int)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def name(self):
        node, idx = self._entries[0]
        return node.name

    def __repr__(self):
        return "<Symbol %s>" % self.name

    def __len__(self):
        return len(self._entries)

    def __iter__(self):
        return (Symbol([e]) for e in self._entries)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            idx = names.index(index)
            return Symbol([self._entries[idx]])
        return Symbol([self._entries[index]])

    def _topo_nodes(self):
        order = []
        visited = set()

        def visit(node):
            if id(node) in visited:
                return
            visited.add(id(node))
            for (n, _) in node.inputs:
                visit(n)
            order.append(node)
        for (n, _) in self._entries:
            visit(n)
        return order

    def list_arguments(self):
        return [n.name for n in self._topo_nodes()
                if n.op is None and not n.attrs.get("__is_aux__")]

    def list_auxiliary_states(self):
        return [n.name for n in self._topo_nodes()
                if n.op is None and n.attrs.get("__is_aux__")]

    def list_outputs(self):
        outs = []
        for node, idx in self._entries:
            if node.op is None:
                outs.append(node.name)
            elif node.num_outputs == 1:
                outs.append(node.name + "_output")
            else:
                outs.append("%s_output%d" % (node.name, idx))
        return outs

    def list_inputs(self):
        return [n.name for n in self._topo_nodes() if n.op is None]

    def get_internals(self):
        entries = []
        for n in self._topo_nodes():
            for i in range(n.num_outputs):
                entries.append((n, i))
        return Symbol(entries)

    def get_children(self):
        node, _ = self._entries[0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    def attr(self, key):
        node, _ = self._entries[0]
        v = node.attrs.get(key)
        return str(v) if v is not None else None

    def attr_dict(self):
        ret = {}
        for n in self._topo_nodes():
            attrs = {k: str(v) for k, v in n.attrs.items() if not k.startswith("__internal")}
            if attrs:
                ret[n.name] = attrs
        return ret

    def _set_attr(self, **kwargs):
        node, _ = self._entries[0]
        node.attrs.update(kwargs)

    # ------------------------------------------------------------------
    # composition & operators
    # ------------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """Compose: replace variable placeholders with provided symbols."""
        s = self.__copy__()
        s._compose(*args, **kwargs)
        return s

    def __copy__(self):
        return Symbol(list(self._entries))

    def _compose(self, *args, **kwargs):
        mapping = {}
        if args:
            variables = [n for n in self._topo_nodes() if n.op is None]
            if len(args) > len(variables):
                raise MXNetError("too many positional arguments to compose")
            for var_node, arg in zip(variables, args):
                mapping[var_node.name] = arg
        mapping.update({k: v for k, v in kwargs.items() if isinstance(v, Symbol)})
        if not mapping:
            return
        for n in self._topo_nodes():
            new_inputs = []
            for (inp, idx) in n.inputs:
                if inp.op is None and inp.name in mapping:
                    new_inputs.append(mapping[inp.name]._entries[0])
                else:
                    new_inputs.append((inp, idx))
            n.inputs = new_inputs

    def _binop(self, other, op_arr, op_scalar, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _create(op_arr, [a, b], {})
        if isinstance(other, (int, float)):
            return _create(op_scalar, [self], {"scalar": float(other),
                                               "reverse": reverse})
        raise TypeError("unsupported operand type %s" % type(other))

    def __add__(self, o):  return self._binop(o, "elemwise_add", "_plus_scalar")
    def __radd__(self, o): return self._binop(o, "elemwise_add", "_plus_scalar", True)
    def __sub__(self, o):  return self._binop(o, "elemwise_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binop(o, "elemwise_sub", "_minus_scalar", True)
    def __mul__(self, o):  return self._binop(o, "elemwise_mul", "_mul_scalar")
    def __rmul__(self, o): return self._binop(o, "elemwise_mul", "_mul_scalar", True)
    def __truediv__(self, o):  return self._binop(o, "elemwise_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binop(o, "elemwise_div", "_div_scalar", True)
    def __pow__(self, o):  return self._binop(o, "_power", "_power_scalar")
    def __neg__(self):     return _create("negative", [self], {})

    def __eq__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return self._binop(o, "broadcast_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")
        return NotImplemented

    def __gt__(self, o): return self._binop(o, "broadcast_greater", "_greater_scalar")
    def __ge__(self, o): return self._binop(o, "broadcast_greater_equal", "_greater_equal_scalar")
    def __lt__(self, o): return self._binop(o, "broadcast_lesser", "_lesser_scalar")
    def __le__(self, o): return self._binop(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    __hash__ = object.__hash__

    # method aliases
    def reshape(self, shape):
        return _create("Reshape", [self], {"shape": tuple(shape)})

    def transpose(self, axes=None):
        return _create("transpose", [self], {"axes": axes})

    def sum(self, axis=None, keepdims=False):
        return _create("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return _create("mean", [self], {"axis": axis, "keepdims": keepdims})

    def astype(self, dtype):
        return _create("Cast", [self], {"dtype": str(dtype)})

    # ------------------------------------------------------------------
    # shape/type inference (on meta tensors)
    # ------------------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        try:
            return self._infer_shape_impl(False, *args, **kwargs)
        except Exception:
            return (None, None, None)

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        shapes = {}
        if args:
            for n, s in zip(arg_names, args):
                if s is not None:
                    shapes[n] = s
        shapes.update({k: v for k, v in kwargs.items() if v is not None})
        specs = {n: _meta(tuple(shapes[n])) for n in shapes}
        return _infer_shapes(self, specs, partial)

    def infer_type(self, *args, **kwargs):
        arg_names = self.list_arguments()
        dtypes = [_np.float32] * len(arg_names)
        out_types = [_np.float32] * len(self._entries)
        aux_types = [_np.float32] * len(self.list_auxiliary_states())
        return dtypes, out_types, aux_types

    # ------------------------------------------------------------------
    # serialization (reference-compatible JSON schema)
    # ------------------------------------------------------------------
    def tojson(self):
        nodes_list = self._topo_nodes()
        node_index = {id(n): i for i, n in enumerate(nodes_list)}
        nodes_json = []
        arg_nodes = []
        for i, n in enumerate(nodes_list):
            if n.op is None:
                arg_nodes.append(i)
            nodes_json.append({
                "op": n.op if n.op is not None else "null",
                "name": n.name,
                "attrs": {k: json.dumps(v) if not isinstance(v, str) else v
                          for k, v in n.attrs.items()},
                "inputs": [[node_index[id(inp)], idx, 0] for (inp, idx) in n.inputs],
            })
        heads = [[node_index[id(n)], idx, 0] for (n, idx) in self._entries]
        return json.dumps({"nodes": nodes_json, "arg_nodes": arg_nodes,
                           "node_row_ptr": list(range(len(nodes_list) + 1)),
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10300]}}, indent=2)

    def save(self, fname):
        """Write :meth:`tojson` to ``fname`` atomically (a temporary file,
        then ``os.replace``)."""
        import os
        tmp = "%s.tmp-%d" % (fname, os.getpid())
        with open(tmp, "w") as f:
            f.write(self.tojson())
        os.replace(tmp, fname)

    # ------------------------------------------------------------------
    # evaluation / binding
    # ------------------------------------------------------------------
    def eval(self, ctx=None, **kwargs):
        ex = self.bind(ctx, kwargs)
        return ex.forward()

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from ..executor import Executor
        return Executor(self, ctx, args or {}, args_grad, grad_req,
                        aux_states or {}, group2ctx=group2ctx)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """Bind over zero arrays made from the shapes inferred from
        ``kwargs`` (name -> shape), on ``ctx`` (default the current
        context)."""
        from ..executor import Executor
        from ..ndarray import zeros as nd_zeros
        arg_shapes, _, aux_shapes = self._infer_shape_impl(False, **kwargs)
        if ctx is None:
            from ..context import current_context
            ctx = current_context()
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes for simple_bind; supply all "
                             "input shapes")
        args = {n: nd_zeros(s, ctx=ctx)
                for n, s in zip(self.list_arguments(), arg_shapes)}
        aux = {n: nd_zeros(s, ctx=ctx)
               for n, s in zip(self.list_auxiliary_states(), aux_shapes)}
        args_grad = None
        if grad_req != "null":
            args_grad = {n: nd_zeros(a.shape, ctx=ctx)
                         for n, a in args.items()}
        return Executor(self, ctx, args, args_grad, grad_req, aux,
                        group2ctx=group2ctx)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _infer_shapes(sym, specs, partial):
    """Propagate shapes through the DAG by running each op on ``meta``
    tensors."""
    shape_env = {}
    nodes = sym._topo_nodes()
    for n in nodes:
        if n.op is None:
            spec = specs.get(n.name)
            if spec is None:
                # a Variable's declared __shape__ seeds inference when the
                # caller gave none
                shp = n.attrs.get("__shape__")
                if shp and all(int(d) > 0 for d in shp):
                    spec = _meta(tuple(int(d) for d in shp))
            shape_env[(id(n), 0)] = spec
    for n in nodes:
        if n.op is None:
            continue
        in_specs = [shape_env.get((id(inp), idx)) for (inp, idx) in n.inputs]
        op = get_op(n.op)
        # deduce parameter-input shapes from the data shape (NNVM
        # InferShape): fills auto-created weight/bias/label variables
        if any(s is None for s in in_specs) and op.param_shape_fn is not None \
                and in_specs and in_specs[0] is not None:
            names = [s.split(":", 1)[-1]
                     for s in (op.input_names(n.attrs) or [])]
            known = [tuple(s.shape) if s is not None else None
                     for s in in_specs]
            try:
                deduced = op.param_shape_fn(n.attrs, known)
            except Exception:
                deduced = {}
            for slot, shape in deduced.items():
                if slot in names:
                    pos = names.index(slot)
                    if pos < len(n.inputs) and in_specs[pos] is None:
                        try:
                            spec = _meta(tuple(int(s) for s in shape))
                        except (TypeError, ValueError):
                            continue
                        in_specs[pos] = spec
                        inp_node, inp_idx = n.inputs[pos]
                        shape_env[(id(inp_node), inp_idx)] = spec
        if any(s is None for s in in_specs):
            for i in range(n.num_outputs):
                shape_env[(id(n), i)] = None
            continue
        attrs = {k: v for k, v in n.attrs.items()
                 if not k.startswith("__") and k != "ctx_group"}
        if op.mode_for(attrs):
            attrs["_training"] = False
        if not n.inputs:
            attrs["_device"] = "meta"
        fcompute = op.plain or op.fcompute
        try:
            with torch.no_grad():
                out = fcompute(attrs, *in_specs)
        except Exception:
            if partial:
                for i in range(n.num_outputs):
                    shape_env[(id(n), i)] = None
                continue
            raise
        outs = out if isinstance(out, (tuple, list)) else [out]
        for i, o in enumerate(outs):
            shape_env[(id(n), i)] = o

    def shape_of(name):
        node = next(n for n in nodes if n.op is None and n.name == name)
        s = shape_env.get((id(node), 0))
        return tuple(s.shape) if s is not None else None

    arg_shapes = [shape_of(name) for name in sym.list_arguments()]
    aux_shapes = [shape_of(name) for name in sym.list_auxiliary_states()]
    out_shapes = []
    for (n, idx) in sym._entries:
        s = shape_env.get((id(n), idx))
        out_shapes.append(tuple(s.shape) if s is not None else None)
    return arg_shapes, out_shapes, aux_shapes


def _visible_entries(s):
    """Entries of ``s`` used when composing it into another op.

    When the symbol is the whole output tuple of one node whose op declares
    ``visible_outputs`` (the nnvm FNumVisibleOutputs analog — BatchNorm's
    mean/var are hidden from composition), only the visible prefix is used.
    """
    entries = s._entries
    if len(entries) <= 1:
        return entries
    node0 = entries[0][0]
    if node0.op is not None and \
            all(n is node0 for n, _ in entries) and \
            [i for _, i in entries] == list(range(node0.num_outputs)):
        vis = get_op(node0.op).visible_outputs
        if callable(vis):
            vis = vis(node0.attrs)
        if vis is not None:
            return entries[:vis]
    return entries


def _create(op_name, input_syms, attrs, name=None, kw_inputs=None):
    """Create a Symbol applying op to inputs (generated sym.* functions).

    Auto-creates Variables for missing parameter/aux/label inputs per the
    op's arg_spec — the reference's NNVM FListInputNames binding behavior
    (e.g. ``sym.FullyConnected(data, num_hidden=k)`` grows fc_weight/fc_bias)."""
    hint = op_name.lower().strip("_")
    name = _current_names().get(name, hint)
    attr_scope = AttrScope._get_current().get()
    merged = dict(attrs)
    for k, v in attr_scope.items():
        merged.setdefault(k, v)
    entries = []
    for s in input_syms:
        if not isinstance(s, Symbol):
            raise TypeError("inputs must be Symbols, got %s" % type(s))
        entries.extend(_visible_entries(s))

    op = get_op(op_name)
    spec = op.input_names(merged)
    if spec is None and kw_inputs:
        for s in kw_inputs.values():
            entries.append(s._entries[0])
    if spec is not None:
        kw_inputs = kw_inputs or {}
        full = []
        pos = 0
        for slot in spec:
            aux = slot.startswith("aux:")
            zero = slot.startswith("zero:")
            short = slot.split(":", 1)[-1]
            if short in kw_inputs:
                full.append(kw_inputs[short]._entries[0])
            elif pos < len(entries):
                full.append(entries[pos])
                pos += 1
            else:
                var_name = "%s_%s" % (name, short)
                var_attrs = {}
                if "ctx_group" in merged:  # params follow their op's group
                    var_attrs["ctx_group"] = merged["ctx_group"]
                if aux:
                    var_attrs["__is_aux__"] = True
                if zero:
                    var_attrs["__init__"] = json.dumps(["zero", {}])
                vnode = _Node(None, var_name, var_attrs, [])
                full.append((vnode, 0))
        entries = full + entries[pos:]
    node = _Node(op_name, name, merged, entries)
    return Symbol([(node, i) for i in range(node.num_outputs)])


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    attrs = dict(attr) if attr else {}
    attrs.update(AttrScope._get_current().get())
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if dtype is not None:
        attrs["__dtype__"] = _np.dtype(dtype).name
    if init is not None:
        attrs["__init__"] = init.dumps() if hasattr(init, "dumps") else str(init)
    attrs.update(kwargs)
    node = _Node(None, name, attrs, [])
    return Symbol([(node, 0)])


var = Variable


def Group(symbols):
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


_HIDDEN_KEYS = ("ctx_group", "lr_mult", "wd_mult", "force_mirroring",
                "mirror_stage")
_CURRENT_JSON_VERSION = 10300  # matches the version save() stamps


def _upgrade_json(conf):
    """Upgrade graph JSON saved by older reference versions
    (src/nnvm/legacy_json_util.cc LoadLegacyJSONPass):

      * <1.0.0 saved hidden attr keys bare ("lr_mult") — rewrite to the
        "__lr_mult__" form (UpgradeJSON_FixParsing, kHiddenKeys at
        src/c_api/c_api_symbolic.cc:41);
      * <0.9.0 did not store aux-state inputs (BatchNorm moving stats) —
        append default-named variable nodes (UpgradeJSON_000800_000900);
      * <0.9.5 stored argmin/argmax axis=-1 for "all axes" — drop the attr
        (UpgradeJSON_000904_000905 optional-axis change).
    """
    version = conf.get("attrs", {}).get("mxnet_version", ["int", 800])[1]
    if version >= _CURRENT_JSON_VERSION:
        return conf
    nodes = conf["nodes"]
    for nc in nodes:
        attrs = nc.get("attrs", nc.get("param"))
        if not attrs:
            continue
        for key in list(attrs):
            if key in _HIDDEN_KEYS:
                attrs["__%s__" % key] = attrs.pop(key)
                continue
            for hk in _HIDDEN_KEYS:
                # "<argname>_<hidden>" attaches to the matching input
                # variable (FixParsing's suffix rule)
                if key.endswith("_" + hk):
                    argname = key[:-(len(hk) + 1)]
                    val = attrs.pop(key)
                    placed = False
                    for (i, _idx, *_r) in nc.get("inputs", []):
                        inp = nodes[i]
                        if inp["op"] == "null" and \
                                inp["name"].endswith(argname):
                            inp.setdefault("attrs", {})["__%s__" % hk] = val
                            placed = True
                            break
                    if not placed:
                        attrs["__%s__" % hk] = val
                    break
        if version < 905 and nc["op"] in ("argmin", "argmax") \
                and str(attrs.get("axis")) == "-1":
            del attrs["axis"]
    if version < 900:
        # append missing aux-variable inputs using each op's input list
        for i, nc in enumerate(nodes):
            if nc["op"] == "null":
                continue
            try:
                spec = get_op(nc["op"]).input_names(
                    nc.get("attrs", nc.get("param", {})) or {})
            except MXNetError:
                spec = None
            if not spec:
                continue
            missing = spec[len(nc.get("inputs", [])):]
            for slot in missing:
                name = slot.split(":")[-1]
                var_name = "%s_%s" % (nc["name"], name) if nc["name"] else name
                var_attrs = {"__is_aux__": True} if slot.startswith("aux:") \
                    else {}
                nodes.append({"op": "null", "name": var_name,
                              "attrs": var_attrs, "inputs": []})
                nc.setdefault("inputs", []).append([len(nodes) - 1, 0, 0])
        # arg_nodes/node_row_ptr become stale; load_json ignores them
    return conf


def load_json(json_str):
    conf = _upgrade_json(json.loads(json_str))
    nodes_conf = conf["nodes"]
    nodes = []

    def parse_attr(v):
        """Recover python-typed attrs.  Reference-MXNet JSON stores every attr
        as a string ('False', '(3, 3)', '1'); parse those too so specs like
        no_bias behave (legacy_json_util.cc upgrade-path analog)."""
        if not isinstance(v, str):
            return v
        try:
            out = json.loads(v)
        except (json.JSONDecodeError, TypeError):
            try:
                out = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                return v
        if isinstance(out, list):
            out = tuple(out)
        return out

    # two passes: the legacy upgrader may append aux-variable nodes after
    # their consumer, so forward references are legal in the node list
    for nc in nodes_conf:
        attrs = {k: parse_attr(v)
                 for k, v in nc.get("attrs", nc.get("param", {})).items()}
        op = nc["op"] if nc["op"] != "null" else None
        node = _Node.__new__(_Node)
        node.op = op
        node.name = nc["name"]
        node.attrs = attrs
        node.inputs = []
        node.num_outputs = get_op(op).n_outputs(attrs) if op else 1
        nodes.append(node)
    for node, nc in zip(nodes, nodes_conf):
        node.inputs = [(nodes[i], idx)
                       for (i, idx, *_rest) in nc.get("inputs", [])]
    heads = conf.get("heads")
    if heads:
        entries = [(nodes[i], idx) for (i, idx, *_r) in heads]
    else:
        entries = [(nodes[-1], 0)]
    return Symbol(entries)


# creators: graph nodes with no inputs, made on the bound graph's device
def zeros(shape, dtype=None, **kwargs):
    return _create("_zeros", [], {"shape": tuple(shape)
                                  if not isinstance(shape, int)
                                  else (shape,),
                                  "dtype": str(dtype or "float32")})


def ones(shape, dtype=None, **kwargs):
    return _create("_ones", [], {"shape": tuple(shape)
                                 if not isinstance(shape, int)
                                 else (shape,),
                                 "dtype": str(dtype or "float32")})


def arange(start, stop=None, step=1.0, repeat=1, dtype=None, **kwargs):
    return _create("_arange", [], {"start": start, "stop": stop,
                                   "step": step, "repeat": repeat,
                                   "dtype": str(dtype or "float32")})
