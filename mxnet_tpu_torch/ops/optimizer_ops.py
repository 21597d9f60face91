"""Optimizer updates (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``
``sgd_update``, ``sgd_mom_update``, ``mp_sgd_update``,
``mp_sgd_mom_update`` and ``adam_update``, :29-95).

Plain functions on tensors that return the new weight and states, as the
JAX ops do; the Optimizer writes them back.  They are elementwise, which
XLA fuses in the JAX package and no Pallas kernel covers, so they stay
PyTorch ops.  ``lr`` and ``wd`` are Python floats, or ``lr`` a 0-d fp32
tensor on the weight's device (a captured train step's learning rate):
the same elementwise arithmetic, a scalar multiply in fp32 either way.

The gradient is prepared as ``_prep_grad`` does there: rescaled, then
clipped to ``[-clip, clip]`` (when ``clip_gradient`` > 0), and only then
is ``wd * weight`` added.  MXNet 1.3 clips after weight decay; the JAX
package clips before, and the port follows the JAX package.

The ``mp_`` updates keep an fp32 master copy of an fp16 or bf16 weight:
the gradient is widened to fp32 before it is prepared, the master weight
(and the momentum) are updated in fp32, and the low-precision weight is
the cast of the new master, not an update of its own.

Each is also a registered op under the JAX name and outputs
(``nd.adam_update(w, g, m, v, lr=...)`` returns ``[w, m, v]``), with
``lr`` and ``wd`` dynamic attributes and ``rescale_grad``,
``clip_gradient``, ``momentum``, ``beta1``, ``beta2`` and ``epsilon`` as
attributes.  Given ``out=`` the weight alone, an op also writes its new
states back into the state inputs, as MXNet's ops mutate them
(``nd.adam_update(w, g, m, v, out=w)`` updates ``m`` and ``v``); the JAX
package's ops do not.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update"]


def _prep_grad(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=None):
    """weight - lr * (g + wd * weight)."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """mom' = momentum * mom - lr * (g + wd * weight); returns
    (weight + mom', mom')."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    mom_new = momentum * mom - lr * (g + wd * weight)
    return weight + mom_new, mom_new


def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=None):
    """:func:`sgd_update` on the fp32 master ``weight32``; returns (the
    master cast to ``weight``'s dtype, the master)."""
    g = _prep_grad(grad.float(), rescale_grad, clip_gradient)
    w32 = weight32 - lr * (g + wd * weight32)
    return w32.to(weight.dtype), w32


def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=None):
    """:func:`sgd_mom_update` on the fp32 master ``weight32`` with an fp32
    momentum; returns (the master cast to ``weight``'s dtype, momentum,
    master)."""
    g = _prep_grad(grad.float(), rescale_grad, clip_gradient)
    mom_new = momentum * mom - lr * (g + wd * weight32)
    w32 = weight32 + mom_new
    return w32.to(weight.dtype), mom_new, w32


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """MXNet's Adam step; returns (weight, mean, var).

    ``lr`` already carries the bias correction (the Optimizer folds
    ``sqrt(1 - beta2^t) / (1 - beta1^t)`` into it), and ``epsilon`` is
    added to the uncorrected ``sqrt(var)``."""
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - lr * m / (torch.sqrt(v) + epsilon)
    return w, m, v


# ---------------------------------------------------------------------------
# the registered ops

def _common(attrs):
    clip = attrs.get("clip_gradient", -1.0)
    return {"lr": float(attrs["lr"]), "wd": float(attrs.get("wd", 0.0)),
            "rescale_grad": float(attrs.get("rescale_grad", 1.0)),
            "clip_gradient": None if clip is None else float(clip)}


_OP = {"dynamic_attrs": ("lr", "wd")}


@register("sgd_update", **_OP)
def _sgd_update_op(attrs, weight, grad):
    return sgd_update(weight, grad, **_common(attrs))


@register("sgd_mom_update", num_outputs=2, mutate_inputs=(2,), **_OP)
def _sgd_mom_update_op(attrs, weight, grad, mom):
    return sgd_mom_update(weight, grad, mom,
                          momentum=float(attrs.get("momentum", 0.0)),
                          **_common(attrs))


@register("mp_sgd_update", num_outputs=2, mutate_inputs=(2,), **_OP)
def _mp_sgd_update_op(attrs, weight, grad, weight32):
    return mp_sgd_update(weight, grad, weight32, **_common(attrs))


@register("mp_sgd_mom_update", num_outputs=3, mutate_inputs=(2, 3), **_OP)
def _mp_sgd_mom_update_op(attrs, weight, grad, mom, weight32):
    return mp_sgd_mom_update(weight, grad, mom, weight32,
                             momentum=float(attrs.get("momentum", 0.0)),
                             **_common(attrs))


@register("adam_update", num_outputs=3, mutate_inputs=(2, 3), **_OP)
def _adam_update_op(attrs, weight, grad, mean, var):
    return adam_update(weight, grad, mean, var,
                       beta1=float(attrs.get("beta1", 0.9)),
                       beta2=float(attrs.get("beta2", 0.999)),
                       epsilon=float(attrs.get("epsilon", 1e-8)),
                       **_common(attrs))
