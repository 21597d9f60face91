"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``: the
``Optimizer`` base, :27-190; ``SGD``, :193-240; ``Adam``, :406-434;
``Updater``/``get_updater``, :636-686).

An update calls a plain function of ``ops/optimizer_ops.py`` and copies the
new weight and states back into the tensors in place.  The step-dependent
scalars (Adam's bias correction) are Python floats, as on the JAX
package's eager path.  ``multi_precision=True`` (bf16 weights with fp32
master copies) is not ported yet and raises.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from ..ops import optimizer_ops

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register"]


class Optimizer:
    """Base optimizer: lr/wd multipliers, per-index update counts, lr
    scheduling.  ``index`` is the caller's key for a parameter (the
    Trainer's position of it)."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False,
                 param_dict=None):
        if multi_precision:
            raise NotImplementedError(
                "multi_precision (fp32 master weights for bf16 parameters) "
                "is not ported yet")
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

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # biases and norms take no weight decay unless a table says so
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith("_weight")}
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


register = Optimizer.register
create = Optimizer.create_optimizer


def _write_back(targets, values):
    with torch.no_grad():
        for t, v in zip(targets, values):
            t.copy_(v)


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` > 0."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight, memory_format=torch.contiguous_format)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common(index)
        if state is not None:
            _write_back((weight, state), optimizer_ops.sgd_mom_update(
                weight, grad, state, momentum=self.momentum, **attrs))
        else:
            _write_back((weight,), (optimizer_ops.sgd_update(
                weight, grad, **attrs),))


@register
class Adam(Optimizer):
    """MXNet's Adam: the bias correction is folded into the learning rate,
    ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` in Python floats, and
    ``epsilon`` is added to the uncorrected ``sqrt(var)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight,
                                 memory_format=torch.contiguous_format),
                torch.zeros_like(weight,
                                 memory_format=torch.contiguous_format))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        attrs = self._common(index)
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        attrs["lr"] = attrs["lr"] * math.sqrt(coef2) / coef1
        mean, var = state
        _write_back((weight, mean, var), optimizer_ops.adam_update(
            weight, grad, mean, var, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, **attrs))


class Updater:
    """Applies an optimizer to (index, grad, weight), keeping per-index
    state; ``get_states``/``set_states`` carry that state to and from
    bytes."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            self.states[index] = self._to_tensor(self.states[index],
                                                 weight.device)
            self.states_synced[index] = True
        self.optimizer.update(index, weight, grad, self.states[index])

    @staticmethod
    def _to_tensor(s, device):
        if isinstance(s, np.ndarray):
            return torch.from_numpy(s).to(device)
        if isinstance(s, (list, tuple)):
            return type(s)(Updater._to_tensor(x, device) for x in s)
        return s

    def set_states(self, states):
        """Load what :meth:`get_states` wrote.  Unpickles: pass only bytes
        this package wrote."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, opt_dict = states
            self.optimizer.__dict__.update(opt_dict)
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        """The states as pickled numpy arrays; with ``dump_optimizer`` the
        optimizer's attributes too, except ``param_dict`` (the live
        parameters stay with the optimizer that loads them)."""
        def to_np(s):
            if isinstance(s, torch.Tensor):
                return s.detach().cpu().numpy()
            if isinstance(s, (list, tuple)):
                return type(s)(to_np(x) for x in s)
            return s
        states = {k: to_np(v) for k, v in self.states.items()}
        if not dump_optimizer:
            return pickle.dumps(states)
        opt_dict = {k: v for k, v in self.optimizer.__dict__.items()
                    if k != "param_dict"}
        return pickle.dumps((states, opt_dict))


def get_updater(optimizer):
    return Updater(optimizer)
