"""Optimizer updates (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``
``sgd_update``, ``sgd_mom_update`` and ``adam_update``, :29-95).

Plain functions on tensors that return the new weight and states, as the
JAX ops do; the Optimizer writes them back.  They are elementwise, which
XLA fuses in the JAX package and no Pallas kernel covers, so they stay
PyTorch ops.  ``lr`` and ``wd`` are Python floats.

The gradient is prepared as ``_prep_grad`` does there: rescaled, then
clipped to ``[-clip, clip]`` (when ``clip_gradient`` > 0), and only then
is ``wd * weight`` added.  MXNet 1.3 clips after weight decay; the JAX
package clips before, and the port follows the JAX package.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update"]


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
