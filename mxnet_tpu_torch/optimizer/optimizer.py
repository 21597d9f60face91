"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``: the
``Optimizer`` base, :27-190; ``SGD``, :193-240; ``Adam``, :406-434;
``Updater``/``get_updater``, :636-686).

An update calls a plain function of ``ops/optimizer_ops.py`` and copies the
new weight and states back into the tensors in place.  The step-dependent
scalars (Adam's bias correction) are Python floats, as on the JAX
package's eager path.  An optimizer marked ``trace_safe`` (SGD, Adam) also
updates when its learning rate and Adam's step count ``t`` are 0-d tensors
on the card (``module/compiled_step.py`` ``_step_hyperparams``): a captured
train step reads them from buffers that are written before each replay,
where a Python float would be frozen into the graph.  Adam's bias
correction then runs in fp32 on the device, where the eager path runs it in
float64.

``multi_precision=True`` keeps an fp32 master copy of each fp16 or bf16
weight in its state (``create_state_multi_precision``) and updates the
master, writing its cast back to the weight (``update_multi_precision``);
other weights, and every weight without the option, are updated as they
are.  As in the JAX package, SGD's multi-precision path calls the ``mp_``
ops directly and never counts the update: ``num_update`` stays at
``begin_num_update`` and an ``lr_scheduler`` does not advance.  Adam's
goes through ``update`` and counts.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from ..base import tensor_from_numpy
from ..ops import optimizer_ops

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register"]


class Optimizer:
    """Base optimizer: lr/wd multipliers, per-index update counts, lr
    scheduling.  ``index`` is the caller's key for a parameter (the
    Trainer's position of it)."""

    opt_registry = {}
    # whether update() is correct with a 0-d tensor learning rate and step
    # count (the compiled step's capture)
    trace_safe = False

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False,
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
_LOW_PRECISION = (torch.float16, torch.bfloat16)


def _write_back(targets, values):
    with torch.no_grad():
        for t, v in zip(targets, values):
            t.copy_(v)


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` > 0."""

    trace_safe = True

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
class Adam(Optimizer):
    """MXNet's Adam: the bias correction is folded into the learning rate,
    ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` in Python floats, and
    ``epsilon`` is added to the uncorrected ``sqrt(var)``."""

    trace_safe = True

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
        # t is a 0-d tensor under the compiled step's capture
        root = coef2.sqrt() if isinstance(coef2, torch.Tensor) \
            else math.sqrt(coef2)
        attrs["lr"] = attrs["lr"] * root / coef1
        mean, var = state
        _write_back((weight, mean, var), optimizer_ops.adam_update(
            weight, grad, mean, var, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, **attrs))


class _Bfloat16Bits:
    """A bf16 optimizer state on the host: its bits as int16, so that a
    state file round-trips it exactly without a bf16 numpy type."""

    def __init__(self, tensor):
        self.bits = tensor.detach().cpu().view(torch.int16).numpy()

    def tensor(self):
        return torch.from_numpy(self.bits).view(torch.bfloat16)


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
            return tensor_from_numpy(s).to(device)
        if isinstance(s, _Bfloat16Bits):
            return s.tensor().to(device)
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
        """The states as pickled numpy arrays (a bf16 state as its bits,
        which numpy cannot hold as bf16); with ``dump_optimizer`` the
        optimizer's attributes too, except ``param_dict`` (the live
        parameters stay with the optimizer that loads them)."""
        def to_np(s):
            if isinstance(s, torch.Tensor):
                if s.dtype == torch.bfloat16:
                    return _Bfloat16Bits(s)
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
