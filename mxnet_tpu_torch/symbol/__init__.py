"""``mx.sym``, the symbolic graph package (counterpart of
``mxnet_tpu/symbol/__init__.py``): :class:`Symbol`, ``Variable``/``var``,
``Group``, ``load``/``load_json``, the creators ``zeros``, ``ones`` and
``arange``, one function per registered op (``sym.FullyConnected``,
``sym.Convolution`` ...), and the ``random``, ``linalg`` and ``contrib``
namespaces."""
import sys as _sys

from . import register as _register
from .symbol import (Group, Symbol, Variable, arange, load, load_json,
                     ones, var, zeros)

_register.install_ops(_sys.modules[__name__])

# the sym.random, sym.linalg and sym.contrib namespaces, as the JAX
# package fills them
from types import ModuleType as _Mod  # noqa: E402

random = _Mod("mxnet_tpu_torch.symbol.random")
linalg = _Mod("mxnet_tpu_torch.symbol.linalg")
contrib = _Mod("mxnet_tpu_torch.symbol.contrib")

for _name in ("_random_uniform", "_random_normal", "_random_gamma",
              "_random_exponential", "_random_poisson", "_random_randint"):
    setattr(random, _name.replace("_random_", ""),
            _register.make_sym_func(_name))

for _name in ("_linalg_gemm", "_linalg_gemm2", "_linalg_potrf",
              "_linalg_potri", "_linalg_trsm", "_linalg_trmm",
              "_linalg_syrk", "_linalg_gelqf", "_linalg_syevd",
              "_linalg_sumlogdiag"):
    setattr(linalg, _name.replace("_linalg_", ""),
            _register.make_sym_func(_name))
