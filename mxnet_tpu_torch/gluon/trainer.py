"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``).

Applies an Optimizer to a module's parameters.  ``step(batch_size)`` sets
``rescale_grad = scale / batch_size``, aggregates the gradients across
devices (nothing to do on one device, as in the JAX package, which makes
no kvstore for a single context), and updates every parameter that takes a
gradient.

Gluon's ``grad_req='write'``: a backward writes a parameter's gradient,
where torch adds to it.  The Trainer hooks each parameter's gradient
accumulator so that it drops the old ``.grad`` just before a backward
stores the new one.  ``.grad`` then holds the last gradient written, as
the JAX package's gradient buffer does, and a ``step`` with no backward
since the last one applies that gradient again (zeros before the first
backward).  ``torch.autograd.grad`` does not run the accumulator and leaves
``.grad`` alone.  A parameter with ``requires_grad=False``
(``grad_req='null'``) is left alone.
"""
from __future__ import annotations

import weakref

import torch

from .. import optimizer as opt
from ..base import MXNetError

__all__ = ["Trainer"]


def _write_grads(param):
    """Hook ``param``'s gradient accumulator to drop ``.grad`` before it
    stores a new one; returns the accumulator, which the caller holds."""
    ref = weakref.ref(param)
    accumulator = param.view_as(param).grad_fn.next_functions[0][0]

    def drop_grad(grad_outputs):
        ref().grad = None

    accumulator.register_prehook(drop_grad)
    return accumulator


def _param_list(params):
    """``params`` as a list of parameters: a list or tuple of them, a dict
    of them, or (name, parameter) pairs such as
    ``module.named_parameters()`` gives."""
    if isinstance(params, dict):
        params = list(params.values())
    elif isinstance(params, (list, tuple)) or hasattr(params, "__next__"):
        params = [p[1] if isinstance(p, tuple) else p for p in params]
    else:
        raise ValueError("First argument must be a list or dict of "
                         "Parameters, got %s." % type(params))
    for param in params:
        if not isinstance(param, torch.nn.Parameter):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got list of %s." % type(param))
    return params


class Trainer:
    """``Trainer(params, optimizer, optimizer_params)``; ``optimizer`` is a
    name (``"adam"``, ``"sgd"``) or an :class:`~..optimizer.Optimizer`.
    ``kvstore`` may be ``"device"``, ``"local"`` or None: on one device
    there is none.  A ``dist`` kvstore is not ported yet and raises."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device"):
        self._params = _param_list(params)
        devices = {p.device for p in self._params}
        if len(devices) > 1:
            raise MXNetError("All Parameters must be on one device, got %s"
                             % sorted(str(d) for d in devices))
        if kvstore is not None and (not isinstance(kvstore, str)
                                    or "dist" in kvstore):
            raise MXNetError(
                "kvstore %r is not ported yet: the port trains on one device "
                "without a kvstore" % (kvstore,))
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)
        # held so that each parameter keeps the accumulator that is hooked
        self._accumulators = [_write_grads(p) for p in self._params
                              if p.requires_grad]

    @property
    def learning_rate(self):
        sched = self._optimizer.lr_scheduler
        return self._optimizer.lr if sched is None \
            else sched(self._optimizer.num_update)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size):
        """Normalize by ``batch_size``, aggregate, update."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update()

    def allreduce_grads(self):
        """Aggregate the gradients across devices: none on one device."""

    def update(self, batch_size):
        """Normalize by ``batch_size`` and update, without aggregating."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
        for i, param in enumerate(self._params):
            if param.requires_grad:
                grad = param.grad
                self._updater(i, torch.zeros_like(param) if grad is None
                              else grad, param)

    def save_states(self, fname):
        """Write the optimizer's states and attributes to ``fname``."""
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read what :meth:`save_states` wrote (a pickle: load only files
        this package wrote)."""
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._optimizer = self._updater.optimizer
