"""Optimizer updates (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``:
``sgd_update``, ``sgd_mom_update``, ``mp_sgd_update``,
``mp_sgd_mom_update`` and ``adam_update``, :29-95; ``rmsprop_update``,
``rmspropalex_update``, ``ftrl_update``, ``signsgd_update``,
``signum_update``, ``ftml_update``, ``_contrib_group_adagrad_update`` and
``_sparse_adagrad_update``, :97-210).

Plain functions on tensors that return the new weight and states, as the
JAX ops do; the Optimizer writes them back.  They are elementwise, which
XLA fuses in the JAX package and no Pallas kernel covers, so they stay
PyTorch ops.  ``lr`` and ``wd`` are Python floats, or ``lr`` a 0-d fp32
tensor on the weight's device (a captured train step's learning rate):
the same elementwise arithmetic, a scalar multiply in fp32 either way.
``ftml_update``'s step count ``t`` is the same kind of value, a dynamic
attribute as in the JAX op.

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
``lr`` and ``wd`` (and FTML's ``t``) dynamic attributes and the other
hyperparameters as attributes, with the JAX op's defaults.  Given ``out=`` the weight alone, an op also writes its new
states back into the state inputs, as MXNet's ops mutate them
(``nd.adam_update(w, g, m, v, out=w)`` updates ``m`` and ``v``); the JAX
package's ops do not.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update", "ftrl_update", "signsgd_update",
           "signum_update", "ftml_update", "group_adagrad_update",
           "sparse_adagrad_update"]


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


def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None, clip_weights=None):
    """Tieleman and Hinton's RMSProp; returns (weight, n).  ``epsilon`` is
    added inside the square root; ``clip_weights`` > 0 clips the new
    weight."""
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    n_new = (1 - gamma1) * torch.square(g) + gamma1 * n
    w = weight - lr * g / torch.sqrt(n_new + epsilon)
    if clip_weights and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n_new


def rmspropalex_update(weight, grad, n, g_state, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=None):
    """Graves' centered RMSProp; returns (weight, n, g, delta)."""
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    n_new = (1 - gamma1) * torch.square(g) + gamma1 * n
    g_new = (1 - gamma1) * g + gamma1 * g_state
    delta_new = gamma2 * delta - lr * g / torch.sqrt(
        n_new - torch.square(g_new) + epsilon)
    return weight + delta_new, n_new, g_new, delta_new


def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=None):
    """FTRL-proximal; returns (weight, z, n).  A weight whose ``|z|`` is
    at most ``lamda1`` is 0."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    sigma = (torch.sqrt(n + torch.square(g)) - torch.sqrt(n)) / lr
    z_new = z + g - sigma * weight
    n_new = n + torch.square(g)
    w = torch.where(
        torch.abs(z_new) > lamda1,
        -(z_new - torch.sign(z_new) * lamda1)
        / ((beta + torch.sqrt(n_new)) / lr + wd),
        torch.zeros((), dtype=weight.dtype, device=weight.device))
    return w, z_new, n_new


def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=None):
    """weight - lr * (sign(g) + wd * weight)."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


def signum_update(weight, grad, mom, lr, momentum=0.0, wd_lh=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=None):
    """Signum; returns (weight, mom).  ``wd`` folds into the momentum, as
    MXNet's SignumKernel does; ``wd_lh`` decays the weight directly."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    mom_new = momentum * mom - (1 - momentum) * wd * weight \
        - (1 - momentum) * g
    w = (1 - lr * wd_lh) * weight + lr * torch.sign(mom_new)
    return w, mom_new


def ftml_update(weight, grad, d, v, z, lr, t, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """FTML; returns (weight, d, v, z).  ``t`` is the step count, a
    number or a 0-d tensor.  The bias corrections are computed in fp32, as
    the JAX op computes them from its traced ``t`` and ``lr``."""
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    v_new = beta2 * v + (1 - beta2) * torch.square(g)
    if not isinstance(t, torch.Tensor) and not isinstance(lr, torch.Tensor):
        # numbers: numpy fp32 scalars
        t, lr, beta1, beta2 = (np.float32(x) for x in (t, lr, beta1, beta2))
    one = np.float32(1.0)
    d_new = (one - beta1 ** t) / lr * (
        torch.sqrt(v_new / (one - beta2 ** t)) + epsilon)
    sigma = d_new - beta1 * d
    z_new = beta1 * z + (1 - beta1) * g - sigma * weight
    return -z_new / d_new, d_new, v_new, z_new


def group_adagrad_update(weight, grad, history, lr, epsilon=1e-5, wd=0.0,
                         rescale_grad=1.0, clip_gradient=None):
    """Group AdaGrad: one history value a row, ``history[i] +=
    mean(g[i]^2)``; returns (weight, history).  ``wd`` is not used, as in
    the JAX op."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    red = tuple(range(1, g.dim()))
    new_h = history + torch.mean(g * g, dim=red).reshape(history.shape)
    denom = torch.sqrt(new_h + epsilon).reshape((-1,) + (1,) * (g.dim() - 1))
    return weight - lr * g / denom, new_h


def sparse_adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                          rescale_grad=1.0, clip_gradient=None):
    """AdaGrad on a dense gradient (the row-sparse op's arithmetic for
    every row); returns (weight, history).  ``epsilon`` is inside the
    square root."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    new_h = history + g * g
    return weight - lr * g / torch.sqrt(new_h + epsilon), new_h


# ---------------------------------------------------------------------------
# the registered ops

def _scalar(v):
    """A float, or a 0-d tensor as it is (a captured step's value)."""
    return v if isinstance(v, torch.Tensor) else float(v)


def _common(attrs):
    clip = attrs.get("clip_gradient", -1.0)
    return {"lr": _scalar(attrs["lr"]), "wd": _scalar(attrs.get("wd", 0.0)),
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


def _floats(attrs, **defaults):
    return {k: float(attrs.get(k, d)) for k, d in defaults.items()}


@register("rmsprop_update", num_outputs=2, mutate_inputs=(2,), **_OP)
def _rmsprop_update_op(attrs, weight, grad, n):
    clip_weights = attrs.get("clip_weights", -1.0)
    return rmsprop_update(
        weight, grad, n, clip_weights=None if clip_weights is None
        else float(clip_weights), **_floats(attrs, gamma1=0.95, epsilon=1e-8),
        **_common(attrs))


@register("rmspropalex_update", num_outputs=4, mutate_inputs=(2, 3, 4), **_OP)
def _rmspropalex_update_op(attrs, weight, grad, n, g, delta):
    return rmspropalex_update(
        weight, grad, n, g, delta,
        **_floats(attrs, gamma1=0.95, gamma2=0.9, epsilon=1e-8),
        **_common(attrs))


@register("ftrl_update", num_outputs=3, mutate_inputs=(2, 3), **_OP)
def _ftrl_update_op(attrs, weight, grad, z, n):
    return ftrl_update(weight, grad, z, n,
                       **_floats(attrs, lamda1=0.01, beta=1.0),
                       **_common(attrs))


@register("signsgd_update", **_OP)
def _signsgd_update_op(attrs, weight, grad):
    return signsgd_update(weight, grad, **_common(attrs))


@register("signum_update", num_outputs=2, mutate_inputs=(2,), **_OP)
def _signum_update_op(attrs, weight, grad, mom):
    return signum_update(weight, grad, mom,
                         **_floats(attrs, momentum=0.0, wd_lh=0.0),
                         **_common(attrs))


@register("ftml_update", num_outputs=4, mutate_inputs=(2, 3, 4),
          dynamic_attrs=("lr", "wd", "t"))
def _ftml_update_op(attrs, weight, grad, d, v, z):
    return ftml_update(weight, grad, d, v, z, t=_scalar(attrs.get("t", 1)),
                       **_floats(attrs, beta1=0.6, beta2=0.999,
                                 epsilon=1e-8),
                       **_common(attrs))


@register("_contrib_group_adagrad_update", num_outputs=2, mutate_inputs=(2,),
          **_OP)
def _group_adagrad_update_op(attrs, weight, grad, history):
    return group_adagrad_update(weight, grad, history,
                                **_floats(attrs, epsilon=1e-5),
                                **_common(attrs))


@register("_sparse_adagrad_update", num_outputs=2, mutate_inputs=(2,), **_OP)
def _sparse_adagrad_update_op(attrs, weight, grad, history):
    return sparse_adagrad_update(weight, grad, history,
                                 **_floats(attrs, epsilon=1e-7),
                                 **_common(attrs))
