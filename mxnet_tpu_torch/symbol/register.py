"""Generate the ``sym.*`` op namespace from the registry (counterpart of
``mxnet_tpu/symbol/register.py``): one function per registered op name,
Symbol arguments as inputs, trailing positionals as the attributes of
``ndarray.register._POS_ATTRS``, other keywords as attributes."""
from __future__ import annotations

from ..ndarray.register import _POS_ATTRS
from ..ops.registry import get_op, list_ops
from .symbol import Symbol, _create

__all__ = ["make_sym_func", "install_ops"]


def make_sym_func(op_name):
    pos_attrs = _POS_ATTRS.get(op_name, [])

    def op_func(*args, name=None, attr=None, **kwargs):
        inputs = []
        trailing = []
        for a in args:
            if a is None:
                continue
            if isinstance(a, Symbol):
                if trailing:
                    raise TypeError("Symbol argument after scalar argument "
                                    "in sym.%s" % op_name)
                inputs.append(a)
            elif isinstance(a, (list, tuple)) and a \
                    and isinstance(a[0], Symbol):
                inputs.extend(a)
            else:
                trailing.append(a)
        if trailing:
            if len(trailing) > len(pos_attrs):
                raise TypeError("too many positional arguments to sym.%s"
                                % op_name)
            for attr_name, v in zip(pos_attrs, trailing):
                if attr_name in kwargs:
                    raise TypeError("sym.%s got multiple values for %r"
                                    % (op_name, attr_name))
                kwargs[attr_name] = v
        attrs = dict(attr) if attr else {}
        kw_inputs = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                kw_inputs[k] = v
            elif v is not None:
                attrs[k] = v
        return _create(op_name, inputs, attrs, name=name,
                       kw_inputs=kw_inputs)
    op_func.__name__ = op_name
    op_func.__doc__ = get_op(op_name).__doc__
    return op_func


def install_ops(module, names=None):
    for name in (names or list_ops()):
        setattr(module, name, make_sym_func(name))
