"""Operator registry (counterpart of ``mxnet_tpu/ops/registry.py:35-268``).

An op is a plain function ``fcompute(attrs, *tensors) -> tensor | tuple``
on torch tensors, registered under its MXNet name.  Gradients are torch
autograd's over the same function, or the op's own
``torch.autograd.Function`` where the reference's gradient is not
autodiff's (``SoftmaxOutput``).  :meth:`Op.apply` calls ``fcompute``
directly: eager torch is the port's dispatch, so there is no per-attrs jit
cache.  The registry is the source of the generated ``nd.*`` namespace
(``ndarray/register.py``).

Ops that draw randomness (``needs_rng``) raise until the RNG is ported;
sparse implementations (``fcompute_ex``) are not ported.
"""
from __future__ import annotations

import threading

from ..base import MXNetError

__all__ = ["Op", "register", "register_op", "alias", "get_op", "list_ops"]

_OP_REGISTRY = {}
# built-ins register at import, but a caller may register from any thread
_REGISTRY_LOCK = threading.Lock()


class Op:
    """A registered operator.

    - ``num_outputs``: an int, or a callable ``attrs -> int``;
    - ``mode_dependent``: ``attrs['_training']`` is injected from
      ``autograd.is_training()`` (a bool, or a callable ``attrs -> bool``);
    - ``needs_rng``: the op draws randomness (bool or callable); such an op
      raises until the RNG is ported;
    - ``visible_outputs``: outputs beyond this count are hidden when a
      symbol is composed (BatchNorm's mean and invstd);
    - ``dynamic_attrs``: attributes that change from call to call (an
      optimizer's ``lr``); a string value is parsed as a float;
    - ``no_grad``: the op's outputs carry no gradient (True, a reason, or a
      callable ``attrs -> bool``);
    - ``mutate_inputs``: input positions that outputs 1, 2, ... write back
      to when ``out=`` names only the first output (MXNet's
      ``FMutateInputs``: an update op's states).
    """

    def __init__(self, name, fcompute, num_outputs=1, needs_rng=False,
                 mode_dependent=False, doc=None, visible_outputs=None,
                 dynamic_attrs=(), no_grad=False, mutate_inputs=()):
        self.name = name
        self.fcompute = fcompute
        self.num_outputs = num_outputs
        self.needs_rng = needs_rng
        self.mode_dependent = mode_dependent
        self.visible_outputs = visible_outputs
        self.dynamic_attrs = tuple(dynamic_attrs)
        self.no_grad = no_grad
        self.mutate_inputs = tuple(mutate_inputs)
        self.__doc__ = doc or (fcompute.__doc__ if fcompute else None)

    def rng_for(self, attrs):
        """Whether this call (given its attrs) draws randomness."""
        f = self.needs_rng
        return bool(f(attrs)) if callable(f) else bool(f)

    def mode_for(self, attrs):
        """Whether this call (given its attrs) receives ``_training``."""
        f = self.mode_dependent
        return bool(f(attrs)) if callable(f) else bool(f)

    def n_outputs(self, attrs):
        no = self.num_outputs
        return no(attrs) if callable(no) else no

    def apply(self, attrs, *tensors):
        """Run ``fcompute`` on ``tensors``."""
        if self.needs_rng and self.rng_for(attrs):
            raise MXNetError("op %s draws randomness, and the RNG is not "
                             "ported yet" % self.name)
        for k in self.dynamic_attrs:
            if isinstance(attrs.get(k), (str, bytes)):
                attrs = dict(attrs)
                attrs[k] = float(attrs[k])
        return self.fcompute(attrs, *tensors)

    def __repr__(self):
        return "Op(%s)" % self.name


def register_op(op):
    with _REGISTRY_LOCK:
        if op.name in _OP_REGISTRY:
            raise MXNetError("op %s already registered" % op.name)
        _OP_REGISTRY[op.name] = op
    return op


def register(name, **kwargs):
    """Decorator: register ``fcompute`` under ``name``."""
    def deco(fcompute):
        register_op(Op(name, fcompute, **kwargs))
        return fcompute
    return deco


def alias(new_name, existing_name):
    """Register another name for an op (MXNet exposes many ops under
    several names)."""
    with _REGISTRY_LOCK:
        _OP_REGISTRY[new_name] = _OP_REGISTRY[existing_name]


def get_op(name):
    op = _OP_REGISTRY.get(name)
    if op is None:
        raise MXNetError("operator %s is not registered" % name)
    return op


def list_ops():
    return sorted(_OP_REGISTRY.keys())
