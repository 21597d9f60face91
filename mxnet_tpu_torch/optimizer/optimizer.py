"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``: the
``Optimizer`` base, :27-190; the fourteen optimizers and the registry's
``Test``, :193-634; ``Updater``/``get_updater``, :636-686).

An update computes on tensors and copies the new weight and states back
into them in place, through the plain functions of
``ops/optimizer_ops.py`` where the JAX optimizer calls a registered update
op, and in the same torch arithmetic, op for op, where it computes with
NDArrays (NAG, LBSGD, DCASGD, SGLD, AdaGrad, AdaDelta, Adamax, Nadam).
The step-dependent scalars (Adam's and Adamax's bias corrections) are
Python floats, as on the JAX package's eager path.  An optimizer marked
``trace_safe`` also updates when its learning rate and step count ``t``
are 0-d tensors on the card (``module/compiled_step.py``
``_step_hyperparams``): a captured train step reads them from buffers that
are written before each replay, where a Python float would be frozen into
the graph.  The ``t``-dependent arithmetic then runs in fp32 on the
device, where the eager path runs it in float64.  ``trace_safe`` and
``elementwise`` are the JAX package's flags: LBSGD (host-side norms),
DCASGD, SGLD and Nadam (a host-side schedule) are not trace-safe.

``multi_precision=True`` keeps an fp32 master copy of each fp16 or bf16
weight in its state (``create_state_multi_precision``) and updates the
master, writing its cast back to the weight (``update_multi_precision``);
other weights, and every weight without the option, are updated as they
are.  As in the JAX package, SGD's multi-precision path (which NAG and
LBSGD inherit) calls the ``mp_`` ops directly and never counts the update:
``num_update`` stays at ``begin_num_update`` and an ``lr_scheduler`` does
not advance.  The others go through ``update`` and count.

``sym=`` (a Module passes its symbol) reads the ``__lr_mult__`` and
``__wd_mult__`` attributes of the symbol's arguments, as the JAX package
does.

The states file (``Updater.get_states``) holds numpy arrays and Python
builtins only, so the JAX package's ``Updater.set_states`` reads it with
plain ``pickle``.  A bf16 state is written as an ``ml_dtypes`` bfloat16
array (the JAX package's type) without importing ``ml_dtypes``.  With
``dump_optimizer`` the optimizer's attributes go with it, except
``param_dict`` (the live parameters) and ``lr_scheduler`` (schedules are
stateless: the reader's own gives the same rates).  ``set_states`` reads
such a file, or one the JAX package wrote, through an unpickler that
imports nothing of the JAX package: each of its classes that such a file
names maps to an inert stand-in (``_JAX_CLASSES``), and a class that is
not mapped raises.  Of the optimizer's attributes it keeps the update
counts, ``lr``, ``wd``, the multiplier tables and Nadam's ``m_schedule``.
"""
from __future__ import annotations

import io
import math
import pickle

import numpy as np
import torch

from ..ops import optimizer_ops

__all__ = ["Optimizer", "SGD", "NAG", "Signum", "FTML", "LBSGD", "DCASGD",
           "SGLD", "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl",
           "Adamax", "Nadam", "Test", "Updater", "get_updater", "create",
           "register"]


class Optimizer:
    """Base optimizer: lr/wd multipliers, per-index update counts, lr
    scheduling.  ``index`` is the caller's key for a parameter (the
    Trainer's position of it, the Module's)."""

    opt_registry = {}
    # whether update() is correct with a 0-d tensor learning rate and step
    # count (the compiled step's capture)
    trace_safe = False
    # whether the update of an element reads only that element of the
    # weight, gradient and states (the sharded update's contract)
    elementwise = False

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        # num_update tracks the furthest step any parameter index reached
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.begin_num_update = self.num_update = begin_num_update
        self._index_update_count = {}
        # per-parameter multiplier sources, highest precedence first (see
        # _index_mult): the parameters' own lr_mult/wd_mult attributes,
        # explicit mult tables, names resolved through idx2name
        self.param_dict = dict(param_dict) if param_dict else {}
        self.idx2name = dict(param_idx2name) if param_idx2name else {}
        self.sym_info = () if sym is None \
            else (sym.attr_dict(), sym.list_arguments())
        self.set_lr_mult({})
        self.set_wd_mult({})

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def create_state(self, index, weight):
        return None

    def _keeps_master(self, weight):
        return self.multi_precision and weight.dtype in _LOW_PRECISION

    def create_state_multi_precision(self, index, weight):
        """``create_state``; for an fp16 or bf16 weight under
        ``multi_precision``, (the state of an fp32 master copy, the
        copy)."""
        if self._keeps_master(weight):
            master = weight.detach().to(torch.float32)
            return (self.create_state(index, master), master)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """``update``; for an fp16 or bf16 weight under ``multi_precision``,
        ``update`` of the fp32 master with the widened gradient, then the
        master's cast written to the weight."""
        if self._keeps_master(weight):
            state, master = state
            self.update(index, master, grad.float(), state)
            _write_back((weight,), (master,))
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined.")
        self.lr = lr

    def _sym_mults(self, key):
        """The symbol's arguments that carry the attribute ``key``."""
        if not self.sym_info:
            return {}
        attr, arg_names = self.sym_info
        return {name: float(attr[name][key]) for name in arg_names
                if name in attr and key in attr[name]}

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._sym_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # biases and norms take no weight decay unless the symbol or a
        # table says so
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith("_weight")}
        self.wd_mult.update(self._sym_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _index_mult(self, index, table, param_attr):
        """Per-parameter multiplier for ``index``: the parameter's own
        attribute wins (1 where it has none), then an explicit table entry
        under the raw index, then one under the index's mapped name;
        default 1."""
        param = self.param_dict.get(index)
        if param is not None:
            return getattr(param, param_attr, 1.0)
        if index in table:
            return table[index]
        return table.get(self.idx2name.get(index, index), 1.0)

    def _get_lr(self, index):
        base = self.lr if self.lr_scheduler is None \
            else self.lr_scheduler(self.num_update)
        return base * self._index_mult(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._index_mult(index, self.wd_mult, "wd_mult")

    def _common(self, index):
        return {"lr": self._get_lr(index), "wd": self._get_wd(index),
                "rescale_grad": self.rescale_grad,
                "clip_gradient": self.clip_gradient}

    def _prepared(self, grad):
        """The gradient rescaled, then clipped where ``clip_gradient`` is
        set (the JAX optimizers' NDArray form of it)."""
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g


register = Optimizer.register
create = Optimizer.create_optimizer
_LOW_PRECISION = (torch.float16, torch.bfloat16)


def _write_back(targets, values):
    with torch.no_grad():
        for t, v in zip(targets, values):
            t.copy_(v)


def _zeros(weight, dtype=None):
    return torch.zeros_like(weight, dtype=dtype,
                            memory_format=torch.contiguous_format)


def _sqrt(x):
    """sqrt of a Python float, or of a 0-d tensor (a captured step's)."""
    return x.sqrt() if isinstance(x, torch.Tensor) else math.sqrt(x)


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` > 0."""

    trace_safe = True
    elementwise = True

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common(index)
        if state is not None:
            _write_back((weight, state), optimizer_ops.sgd_mom_update(
                weight, grad, state, momentum=self.momentum, **attrs))
        else:
            _write_back((weight,), (optimizer_ops.sgd_update(
                weight, grad, **attrs),))

    def update_multi_precision(self, index, weight, grad, state):
        """The ``mp_sgd`` ops on the fp32 master; the update is not counted
        (the JAX package's quirk, kept)."""
        if not self._keeps_master(weight):
            self.update(index, weight, grad, state)
            return
        mom, master = state
        attrs = self._common(index)
        if mom is not None:
            _write_back((weight, mom, master), optimizer_ops.mp_sgd_mom_update(
                weight, grad, mom, master, momentum=self.momentum, **attrs))
        else:
            _write_back((weight, master), optimizer_ops.mp_sgd_update(
                weight, grad, master, **attrs))


@register
class NAG(SGD):
    """Nesterov accelerated SGD."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._prepared(grad)
        if state is not None:
            mom = self.momentum * state + g + wd * weight
            _write_back((state, weight),
                        (mom, weight - lr * (g + self.momentum * mom)))
        else:
            _write_back((weight,), (weight - lr * (g + wd * weight),))


@register
class Signum(Optimizer):
    """signSGD, and Signum (its momentum form) when ``momentum`` > 0."""

    trace_safe = True
    elementwise = True

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common(index)
        if state is not None:
            _write_back((weight, state), optimizer_ops.signum_update(
                weight, grad, state, momentum=self.momentum,
                wd_lh=self.wd_lh, **attrs))
        else:
            _write_back((weight,), (optimizer_ops.signsgd_update(
                weight, grad, **attrs),))


@register
class FTML(Optimizer):
    """Follow the Moving Leader; its step count ``t`` rides as the op's
    dynamic attribute."""

    trace_safe = True
    elementwise = True

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        d, v, z = state
        _write_back((weight, d, v, z), optimizer_ops.ftml_update(
            weight, grad, d, v, z, t=self._index_update_count[index],
            beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
            **self._common(index)))


@register
class LBSGD(SGD):
    """Large-batch SGD with a LARS-style layer-wise rate: the weight's
    and gradient's norms are read on the host, so it is not trace-safe,
    and they couple the elements."""

    trace_safe = False
    elementwise = False

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(momentum=momentum, multi_precision=multi_precision,
                         **kwargs)
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.adaptive = True

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._prepared(grad)
        if self.adaptive:
            wnorm = float(torch.linalg.vector_norm(weight))
            gnorm = float(torch.linalg.vector_norm(g))
            if wnorm > 0 and gnorm > 0:
                lr = lr * 0.001 * wnorm / (gnorm + wd * wnorm + 1e-9) \
                    * self.batch_scale
        if state is not None:
            mom = self.momentum * state - lr * (g + wd * weight)
            _write_back((state, weight), (mom, weight + mom))
        else:
            _write_back((weight,), (weight - lr * (g + wd * weight),))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD; its state keeps the previous
    weight."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        previous = weight.detach().clone(
            memory_format=torch.contiguous_format)
        if self.momentum == 0.0:
            return (None, previous)
        return (_zeros(weight), previous)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._prepared(grad)
        mom, previous = state
        d = g + wd * weight + self.lamda * g * g * (weight - previous)
        if mom is not None:
            mom_new = self.momentum * mom - lr * d
            _write_back((mom,), (mom_new,))
            new_weight = weight + mom_new
        else:
            new_weight = weight - lr * d
        # the previous weight first, from the weight not yet written
        _write_back((previous, weight), (weight, new_weight))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: the noise is
    ``nd.random.normal(0, sqrt(lr))``, drawn from the global key as the
    JAX package draws it."""

    def update(self, index, weight, grad, state):
        from ..ndarray import random as ndrandom
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._prepared(grad)
        noise = ndrandom.normal(0, math.sqrt(lr), shape=tuple(weight.shape),
                                dtype="float32", ctx=weight.device)._data
        _write_back((weight,),
                    (weight - lr / 2 * (g + wd * weight) + noise,))


@register
class Adam(Optimizer):
    """MXNet's Adam: the bias correction is folded into the learning rate,
    ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` in Python floats, and
    ``epsilon`` is added to the uncorrected ``sqrt(var)``."""

    trace_safe = True
    elementwise = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        attrs = self._common(index)
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        attrs["lr"] = attrs["lr"] * _sqrt(coef2) / coef1
        mean, var = state
        _write_back((weight, mean, var), optimizer_ops.adam_update(
            weight, grad, mean, var, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, **attrs))


@register
class AdaGrad(Optimizer):
    """AdaGrad: the history sums the prepared gradient's squares; weight
    decay is a direct term outside it."""

    trace_safe = True
    elementwise = True

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._prepared(grad)
        history = state + g * g
        _write_back((state, weight), (history, weight - lr * (
            g / ((history + self.float_stable_eps) ** 0.5) + wd * weight)))


@register
class RMSProp(Optimizer):
    """RMSProp (``rmsprop_update``), or with ``centered`` Graves' form
    (``rmspropalex_update``)."""

    trace_safe = True
    elementwise = True

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return (_zeros(weight),)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common(index)
        if not self.centered:
            (n,) = state
            _write_back((weight, n), optimizer_ops.rmsprop_update(
                weight, grad, n, gamma1=self.gamma1, epsilon=self.epsilon,
                clip_weights=self.clip_weights or None, **attrs))
        else:
            n, g, delta = state
            _write_back((weight, n, g, delta),
                        optimizer_ops.rmspropalex_update(
                            weight, grad, n, g, delta, gamma1=self.gamma1,
                            gamma2=self.gamma2, epsilon=self.epsilon,
                            **attrs))


@register
class AdaDelta(Optimizer):
    """AdaDelta; it takes no learning rate, and weight decay is a direct
    term."""

    trace_safe = True
    elementwise = True

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        g = self._prepared(grad)
        acc_g, acc_delta = state
        acc_g_new = self.rho * acc_g + (1.0 - self.rho) * g * g
        delta = ((acc_delta + self.epsilon) ** 0.5
                 / (acc_g_new + self.epsilon) ** 0.5) * g
        acc_delta_new = self.rho * acc_delta \
            + (1.0 - self.rho) * delta * delta
        _write_back((acc_g, acc_delta, weight),
                    (acc_g_new, acc_delta_new, weight - delta - wd * weight))


@register
class Ftrl(Optimizer):
    """FTRL-proximal (``ftrl_update``)."""

    trace_safe = True
    elementwise = True

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        _write_back((weight, z, n), optimizer_ops.ftrl_update(
            weight, grad, z, n, lamda1=self.lamda1, beta=self.beta,
            **self._common(index)))


@register
class Adamax(Optimizer):
    """Adamax: Adam with the infinity norm; the bias correction divides
    the learning rate, and the gradient is clipped after weight decay."""

    trace_safe = True
    elementwise = True

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        lr = lr / (1.0 - self.beta1 ** t)
        g = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        m_t, u_t = state
        m_new = self.beta1 * m_t + (1.0 - self.beta1) * g
        u_new = torch.maximum(self.beta2 * u_t, g.abs())
        _write_back((m_t, u_t, weight),
                    (m_new, u_new, weight - lr * m_new / u_new))


@register
class Nadam(Optimizer):
    """Nesterov Adam.  ``m_schedule`` is a product over the steps kept on
    the host, so it is not trace-safe."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        g = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = state
        m_new = self.beta1 * m_t + (1.0 - self.beta1) * g
        v_new = self.beta2 * v_t + (1.0 - self.beta2) * g * g
        grad_prime = g / (1.0 - self.m_schedule)
        m_prime = m_new / (1.0 - m_schedule_next)
        v_prime = v_new / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - momentum_t) * grad_prime + momentum_t_1 * m_prime
        _write_back((m_t, v_t, weight), (m_new, v_new, weight - lr * m_bar
                                         / ((v_prime ** 0.5) + self.epsilon)))


@register
class Test(Optimizer):
    """The registry's test optimizer: adds the rescaled gradient and keeps
    the new weight as its state; it counts no update."""

    trace_safe = True
    elementwise = True

    def create_state(self, index, weight):
        return _zeros(weight, torch.float32)

    def update(self, index, weight, grad, state):
        new_weight = weight + grad * self.rescale_grad
        _write_back((weight, state), (new_weight, new_weight))


# ---------------------------------------------------------------------------
# the states file

class _MlDtypesBfloat16:
    """Pickles as the global ``ml_dtypes.bfloat16`` (``_StateWriter``) and
    is what ``_StateReader`` gives for it."""

    def __reduce__(self):
        return "bfloat16"


_ML_BFLOAT16 = _MlDtypesBfloat16()
# numpy's pickle of dtype(ml_dtypes.bfloat16): its __setstate__ argument
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)
# numpy's array and scalar reconstructors (their module differs across
# numpy versions)
_NP_RECONSTRUCT = np.zeros(1, np.uint16).__reduce__()[0]
_NP_SCALAR = np.float32(0).__reduce__()[0]


class _Bfloat16Dtype:
    """``numpy.dtype(ml_dtypes.bfloat16)`` in a states file."""

    def __reduce__(self):
        return (np.dtype, (_ML_BFLOAT16, False, True), _BF16_DTYPE_STATE)

    def __setstate__(self, state):
        pass


class _Bfloat16Array:
    """A bf16 state on its way into a file: numpy's pickle of an
    ``ml_dtypes`` bfloat16 array of the tensor's bits."""

    def __init__(self, tensor):
        self.shape = tuple(tensor.shape)
        self.raw = tensor.detach().contiguous().cpu().view(
            torch.int16).numpy().tobytes()

    def __reduce__(self):
        return (_NP_RECONSTRUCT, (np.ndarray, (0,), b"b"),
                (1, self.shape, _Bfloat16Dtype(), False, self.raw))


class _StateWriter(pickle._Pickler):
    """The Python pickler, which writes ``ml_dtypes.bfloat16`` by name
    without importing it."""

    def save_global(self, obj, name=None):
        if obj is _ML_BFLOAT16:
            self.write(pickle.GLOBAL + b"ml_dtypes\nbfloat16\n")
            self.memoize(obj)
            return
        super().save_global(obj, name)


class _Inert:
    """Stands for an object of a JAX-package class in a states file: takes
    any arguments and state, and keeps them."""

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


def _inert(*args):
    return _Inert(*args)


class _ArrayInProgress:
    """What numpy's ``_reconstruct`` gives while a states file loads; its
    ``__setstate__`` learns the dtype, and a bf16 array becomes a
    ``torch.bfloat16`` tensor of its bits (``_settle``)."""

    def __init__(self, *args):
        self.value = None

    def __setstate__(self, state):
        version, shape, dtype, fortran, raw = state
        if isinstance(dtype, _Bfloat16Dtype):
            bits = np.frombuffer(raw, np.int16).reshape(
                shape, order="F" if fortran else "C")
            self.value = torch.from_numpy(
                bits.copy(order="C")).view(torch.bfloat16)
            return
        arr = _NP_RECONSTRUCT(np.ndarray, (0,), b"b")
        arr.__setstate__(state)
        self.value = arr


def _np_dtype(obj, align=False, copy=False):
    if obj is _ML_BFLOAT16:
        return _Bfloat16Dtype()
    return np.dtype(obj, align, copy)


# the JAX package's classes that a states file names (a Trainer's file
# pickles its optimizer's param_dict: the Parameters, their arrays, their
# Trainer and its updater), each read as an inert stand-in
_JAX_CLASSES = frozenset(
    [("mxnet_tpu.gluon.trainer", "Trainer"),
     ("mxnet_tpu.gluon.parameter", "Parameter"),
     ("mxnet_tpu.gluon.parameter", "Constant"),
     ("mxnet_tpu.ndarray.ndarray", "NDArray"),
     ("mxnet_tpu.context", "Context"),
     ("mxnet_tpu.autograd", "TapeEntry"),
     ("mxnet_tpu.optimizer.optimizer", "Updater"),
     ("mxnet_tpu.initializer", "InitDesc")]
    + [("mxnet_tpu.optimizer.optimizer", n) for n in (
        "Optimizer", "SGD", "NAG", "Signum", "FTML", "LBSGD", "DCASGD",
        "SGLD", "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Adamax",
        "Nadam", "Test")]
    + [("mxnet_tpu.lr_scheduler", n) for n in (
        "LRScheduler", "FactorScheduler", "MultiFactorScheduler",
        "PolyScheduler", "CosineScheduler")]
    + [("mxnet_tpu.initializer", n) for n in (
        "Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
        "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
        "FusedRNN", "Mixed", "Load")])
_JAX_FUNCTIONS = frozenset([("jax._src.array", "_reconstruct_array")])
_NUMPY = {
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): _np_dtype,
    ("numpy._core.multiarray", "_reconstruct"): _ArrayInProgress,
    ("numpy.core.multiarray", "_reconstruct"): _ArrayInProgress,
    ("numpy._core.multiarray", "scalar"): _NP_SCALAR,
    ("numpy.core.multiarray", "scalar"): _NP_SCALAR,
    ("ml_dtypes", "bfloat16"): _ML_BFLOAT16,
}


class _StateReader(pickle.Unpickler):
    """Reads a states file of either package without importing the JAX
    package: numpy's reconstructors, ``ml_dtypes.bfloat16`` as bits, and
    the mapped JAX-package classes as inert stand-ins.  Any other class
    raises."""

    def find_class(self, module, name):
        if (module, name) in _NUMPY:
            return _NUMPY[(module, name)]
        if module == "numpy" and name in np.sctypeDict:   # scalar types
            return np.dtype(name).type
        if (module, name) in _JAX_CLASSES:
            return _Inert
        if (module, name) in _JAX_FUNCTIONS:
            return _inert
        raise pickle.UnpicklingError(
            "a states file names %s.%s, which has no mapping in the port"
            % (module, name))


def _settle(obj):
    """``obj`` with each array loaded through ``_ArrayInProgress``
    replaced by its value, and stand-ins dropped."""
    if isinstance(obj, _ArrayInProgress):
        return obj.value
    if isinstance(obj, dict):
        return {k: _settle(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_settle(x) for x in obj)
    return obj


def load_states(data):
    """The object in a states file (``data``: its bytes), as
    :class:`_StateReader` reads it."""
    return _settle(_StateReader(io.BytesIO(data)).load())


def dump_states(obj):
    """``obj`` (states of tensors, arrays and builtins) as a states file:
    each tensor as a numpy array, a bf16 tensor as an ``ml_dtypes``
    bfloat16 array."""
    def host(s):
        if isinstance(s, torch.Tensor):
            if s.dtype == torch.bfloat16:
                return _Bfloat16Array(s)
            return s.detach().cpu().numpy()
        if isinstance(s, dict):
            return {k: host(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(host(x) for x in s)
        return s
    out = io.BytesIO()
    _StateWriter(out, protocol=4).dump(host(obj))
    return out.getvalue()


class Updater:
    """Applies an optimizer to (index, grad, weight), keeping per-index
    state; ``get_states``/``set_states`` carry that state to and from
    bytes."""

    # the optimizer attributes a states file carries into the reader
    RESTORED = ("num_update", "_index_update_count", "lr", "wd", "lr_mult",
                "wd_mult", "m_schedule")
    # and the ones it never writes
    NOT_WRITTEN = ("param_dict", "lr_scheduler")

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            self.states[index] = self._to_tensor(self.states[index],
                                                 weight.device)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    @staticmethod
    def _to_tensor(s, device):
        if isinstance(s, np.ndarray):
            return torch.from_numpy(np.array(s)).to(device)
        if isinstance(s, torch.Tensor):
            return s.to(device)
        if isinstance(s, (list, tuple)):
            return type(s)(Updater._to_tensor(x, device) for x in s)
        return s

    def set_states(self, states):
        """Load a states file written by either package (see the module
        docstring for what it keeps)."""
        states = load_states(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, opt_dict = states
            for key in self.RESTORED:
                if key in opt_dict and hasattr(self.optimizer, key):
                    setattr(self.optimizer, key, opt_dict[key])
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        """The states file: numpy arrays and builtins, with
        ``dump_optimizer`` the optimizer's attributes too (but
        ``NOT_WRITTEN``)."""
        if not dump_optimizer:
            return dump_states(self.states)
        opt_dict = {k: v for k, v in self.optimizer.__dict__.items()
                    if k not in self.NOT_WRITTEN}
        return dump_states((self.states, opt_dict))


def get_updater(optimizer):
    return Updater(optimizer)
