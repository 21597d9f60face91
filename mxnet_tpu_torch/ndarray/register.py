"""Generate the ``nd.*`` op namespace from the registry (counterpart of
``mxnet_tpu/ndarray/register.py:22-81``).

One function per registered op name: NDArray arguments, positional or by
keyword, become the op's inputs; trailing non-array positionals map to the
attribute names of ``_POS_ATTRS``; other keywords are attributes.

:data:`tensor_ops` is the same namespace over torch tensors: the ``F`` a
Gluon layer's ``hybrid_forward`` runs with when it is called eagerly (a
loss, ``HybridLambda``, a zoo block written only as ``hybrid_forward``).
Its functions thread ``_training`` and ``_rng_key`` as :func:`invoke`
does, and leave torch's grad mode as the caller set it, so a loss is
differentiated wherever the model is.
"""
from __future__ import annotations

import torch

from .. import autograd
from .. import random as _random
from ..ops.registry import get_op, list_ops
from .ndarray import NDArray, invoke

__all__ = ["make_op_func", "install_ops", "tensor_ops"]

# trailing non-array positional arguments of MXNet op signatures, by op
_POS_ATTRS = {
    "one_hot": ["depth", "on_value", "off_value"],
    "clip": ["a_min", "a_max"],
    "expand_dims": ["axis"],
    "reshape": ["shape"],
    "Reshape": ["shape"],
    "Cast": ["dtype"],
    "cast": ["dtype"],
}


def _op_args(op_name, args, kwargs, is_array):
    """``(inputs, attrs)`` of a call: arrays (``is_array``), positional or
    by keyword, and lists of them are inputs; trailing non-array
    positionals take the names of ``_POS_ATTRS``; other keywords are
    attributes."""
    pos_attrs = _POS_ATTRS.get(op_name, [])
    inputs = []
    trailing = []
    for a in args:
        if a is None:
            continue
        if is_array(a):
            if trailing:
                raise TypeError("array argument after scalar argument in %s"
                                % op_name)
            inputs.append(a)
        elif isinstance(a, (list, tuple)) and a and is_array(a[0]):
            inputs.extend(a)
        else:
            trailing.append(a)
    if len(trailing) > len(pos_attrs):
        raise TypeError("too many positional arguments to %s" % op_name)
    for attr_name, v in zip(pos_attrs, trailing):
        kwargs.setdefault(attr_name, v)
    attrs = {}
    for k, v in kwargs.items():
        if is_array(v):   # arrays by keyword are inputs
            inputs.append(v)
        elif v is not None:
            attrs[k] = v
    return inputs, attrs


def _is_ndarray(a):
    return isinstance(a, NDArray)


def _is_tensor(a):
    return isinstance(a, torch.Tensor)


def make_op_func(op_name):
    def op_func(*args, out=None, name=None, **kwargs):
        inputs, attrs = _op_args(op_name, args, kwargs, _is_ndarray)
        return invoke(op_name, inputs, attrs, out=out)

    op_func.__name__ = op_name
    op_func.__doc__ = get_op(op_name).__doc__
    return op_func


def _tensor_op_func(op_name):
    op = get_op(op_name)

    def op_func(*args, name=None, **kwargs):
        inputs, attrs = _op_args(op_name, args, kwargs, _is_tensor)
        if op.mode_dependent and op.mode_for(attrs):
            attrs["_training"] = autograd.is_training()
        if op.needs_rng and op.rng_for(attrs):
            attrs["_rng_key"] = _random.next_key()
        return op.apply(attrs, *inputs)

    op_func.__name__ = op_name
    op_func.__doc__ = op.__doc__
    return op_func


class _TensorOps:
    """The registered ops as functions of torch tensors (see the module
    docstring), made on first use."""

    def __getattr__(self, name):
        if name.startswith("__") or name not in list_ops():
            raise AttributeError("no registered op %r" % name)
        fn = _tensor_op_func(name)
        setattr(self, name, fn)
        return fn


tensor_ops = _TensorOps()


def install_ops(module):
    """Install one function per registered op into ``module``."""
    for name in list_ops():
        setattr(module, name, make_op_func(name))
