"""Activation blocks (counterpart of ``mxnet_tpu/gluon/nn/activations.py``):
:class:`Activation`, with the ``act_type``s the JAX ``Activation`` op
accepts (``mxnet_tpu/ops/nn_ops.py:416``: relu, sigmoid, tanh, softrelu
and softsign), and :class:`LeakyReLU`, :class:`PReLU`, :class:`ELU`,
:class:`SELU`, :class:`Swish` and :class:`GELU` (:23-78), which compute
through the ``LeakyReLU`` op's function as the JAX layers call that op.
"""
from __future__ import annotations

import torch

from ...ops.nn_ops import ACTIVATIONS, _leaky_relu
from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU"]


class Activation(HybridBlock):
    def __init__(self, activation, prefix=None, params=None):
        if activation not in ACTIVATIONS:
            raise ValueError("unknown act_type %s" % activation)
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def forward(self, x):
        return ACTIVATIONS[self._act_type](x)

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type, name="fwd")

    def extra_repr(self):
        return self._act_type


class LeakyReLU(HybridBlock):
    """``x`` where ``x >= 0``, ``alpha * x`` elsewhere."""

    def __init__(self, alpha, prefix=None, params=None):
        if alpha < 0:
            raise AssertionError("Slope coefficient for LeakyReLU must be "
                                 "no less than 0.")
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return _leaky_relu({"act_type": "leaky", "slope": self._alpha}, x)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha,
                           name="fwd")

    def extra_repr(self):
        return str(self._alpha)


class PReLU(HybridBlock):
    """A leaky ReLU whose slope is the parameter ``alpha`` (shape (1,),
    ``Constant(0.25)`` unless ``alpha_initializer`` says otherwise)."""

    def __init__(self, alpha_initializer=None, prefix=None, params=None,
                 device=None):
        super().__init__(prefix=prefix, params=params)
        from ... import initializer
        from ...context import resolve_device
        self._device = resolve_device(device)
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(1,),
                init=alpha_initializer or initializer.Constant(0.25))

    def forward(self, x):
        return _leaky_relu({"act_type": "prelu"}, x, self.alpha)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu", name="fwd")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return _leaky_relu({"act_type": "elu", "slope": self._alpha}, x)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return _leaky_relu({"act_type": "selu"}, x)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu", name="fwd")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    """The tanh form of GELU (``jax.nn.gelu``'s default)."""

    def forward(self, x):
        return _leaky_relu({"act_type": "gelu"}, x)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu", name="fwd")
