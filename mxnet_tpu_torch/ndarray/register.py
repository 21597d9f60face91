"""Generate the ``nd.*`` op namespace from the registry (counterpart of
``mxnet_tpu/ndarray/register.py:22-81``).

One function per registered op name: NDArray arguments, positional or by
keyword, become the op's inputs; trailing non-array positionals map to the
attribute names of ``_POS_ATTRS``; other keywords are attributes.
"""
from __future__ import annotations

from ..ops.registry import get_op, list_ops
from .ndarray import NDArray, invoke

__all__ = ["make_op_func", "install_ops"]

# trailing non-array positional arguments of MXNet op signatures, by op
_POS_ATTRS = {
    "one_hot": ["depth", "on_value", "off_value"],
    "expand_dims": ["axis"],
    "reshape": ["shape"],
    "Reshape": ["shape"],
    "Cast": ["dtype"],
    "cast": ["dtype"],
}


def make_op_func(op_name):
    pos_attrs = _POS_ATTRS.get(op_name, [])

    def op_func(*args, out=None, name=None, **kwargs):
        inputs = []
        trailing = []
        for a in args:
            if a is None:
                continue
            if isinstance(a, NDArray):
                if trailing:
                    raise TypeError("NDArray argument after scalar argument "
                                    "in %s" % op_name)
                inputs.append(a)
            elif isinstance(a, (list, tuple)) and a \
                    and isinstance(a[0], NDArray):
                inputs.extend(a)
            else:
                trailing.append(a)
        if len(trailing) > len(pos_attrs):
            raise TypeError("too many positional arguments to %s" % op_name)
        for attr_name, v in zip(pos_attrs, trailing):
            kwargs.setdefault(attr_name, v)
        attrs = {}
        for k, v in kwargs.items():
            if isinstance(v, NDArray):   # NDArrays by keyword are inputs
                inputs.append(v)
            elif v is not None:
                attrs[k] = v
        return invoke(op_name, inputs, attrs, out=out)

    op_func.__name__ = op_name
    op_func.__doc__ = get_op(op_name).__doc__
    return op_func


def install_ops(module):
    """Install one function per registered op into ``module``."""
    for name in list_ops():
        setattr(module, name, make_op_func(name))
