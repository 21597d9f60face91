"""``mx.sym``, the symbolic graph package (counterpart of
``mxnet_tpu/symbol/__init__.py``): :class:`Symbol`, ``Variable``/``var``,
``Group``, ``load``/``load_json``, the creators ``zeros``, ``ones`` and
``arange``, and one function per registered op (``sym.FullyConnected``,
``sym.Convolution`` ...)."""
import sys as _sys

from . import register as _register
from .symbol import (Group, Symbol, Variable, arange, load, load_json,
                     ones, var, zeros)

_register.install_ops(_sys.modules[__name__])
