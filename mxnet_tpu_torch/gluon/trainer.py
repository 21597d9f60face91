"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``).

Applies an Optimizer to a module's parameters.  ``step(batch_size)`` sets
``rescale_grad = scale / batch_size``, aggregates the gradients across
devices (nothing to do on one device, as in the JAX package, which makes
no kvstore for a single context), and updates every parameter that takes a
gradient.

Gluon's ``grad_req='write'``: a backward writes a parameter's gradient,
where torch adds to it.  The Trainer hooks each parameter's gradient
accumulator so that it drops the old ``.grad`` just before a backward
stores the new one (again after ``cast`` changes the parameter's dtype).
``.grad`` then holds the last gradient written, as the JAX package's
gradient buffer does, and a ``step`` with no backward since the last one
applies that gradient again (zeros before the first backward).
``torch.autograd.grad`` does not run the accumulator and leaves ``.grad``
alone.  A parameter with ``requires_grad=False`` (``grad_req='null'``) is
left alone.

``params`` is ``net.collect_params()`` (a ``ParameterDict``) or a list of
Gluon parameters, as in MXNet; their ``grad_req='null'`` entries
(BatchNorm's running statistics) keep their indices and are skipped.  A
parameter whose shape waits for the block's first call is looked up at the
first ``step``.  Torch parameters (``net.named_parameters()``, a list or a
dict) are accepted too.
"""
from __future__ import annotations

import weakref

import torch

from .. import optimizer as opt
from ..base import MXNetError
from . import parameter

__all__ = ["Trainer"]


class _GradWrite:
    """``grad_req='write'`` for one parameter: a hook on its gradient
    accumulator drops ``.grad`` before the accumulator stores a new one.
    Holds the accumulator, which the parameter only references weakly.
    ``gluon.parameter.cast`` calls :meth:`hook` again: a parameter whose
    dtype changes gets a new accumulator."""

    def __init__(self, param):
        self._param = weakref.ref(param)
        parameter.watch_cast(param, self)
        self.hook()

    def hook(self):
        param = self._param()
        self.accumulator = param.view_as(param).grad_fn.next_functions[0][0]
        self.accumulator.register_prehook(self._drop_grad)

    def _drop_grad(self, grad_outputs):
        self._param().grad = None


def _param_list(params):
    """``params`` as a list of Gluon or torch parameters: a
    ``ParameterDict`` or dict of them, a list or tuple of them, or (name,
    parameter) pairs such as ``module.named_parameters()`` gives."""
    if isinstance(params, (dict, parameter.ParameterDict)):
        params = list(params.values())
    elif isinstance(params, (list, tuple)) or hasattr(params, "__next__"):
        params = [p[1] if isinstance(p, tuple) else p for p in params]
    else:
        raise ValueError("First argument must be a list or dict of "
                         "Parameters, got %s." % type(params))
    for param in params:
        if not isinstance(param, (torch.nn.Parameter, parameter.Parameter)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got list of %s." % type(param))
    return params


class Trainer:
    """``Trainer(params, optimizer, optimizer_params)``; ``optimizer`` is a
    name (``"adam"``, ``"sgd"``) or an :class:`~..optimizer.Optimizer`.
    ``optimizer_params`` may set ``multi_precision`` (fp32 master copies of
    fp16 and bf16 parameters).
    ``kvstore`` may be ``"device"``, ``"local"`` or None: on one device
    there is none.  A ``dist`` kvstore is not ported yet and raises."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device"):
        self._entries = _param_list(params)
        if kvstore is not None and (not isinstance(kvstore, str)
                                    or "dist" in kvstore):
            raise MXNetError(
                "kvstore %r is not ported yet: the port trains on one device "
                "without a kvstore" % (kvstore,))
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(self._entries))
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
        self._params = None
        if not any(isinstance(p, parameter.Parameter) and p._is_lazy()
                   for p in self._entries):
            self._init_params()

    def _init_params(self):
        """Resolve the tensors (Gluon parameters' registered ones; None for
        a ``grad_req='null'`` entry) and hook their gradient writes."""
        params = []
        for p in self._entries:
            if isinstance(p, parameter.Parameter):
                params.append(None if p.grad_req == "null"
                              else p._check_and_get())
            else:
                params.append(p)
        devices = {p.device for p in params if p is not None}
        if len(devices) > 1:
            raise MXNetError("All Parameters must be on one device, got %s"
                             % sorted(str(d) for d in devices))
        self._params = params
        self._grad_writes = [_GradWrite(p) for p in params
                             if p is not None and p.requires_grad]

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
        if self._params is None:
            self._init_params()
        for i, param in enumerate(self._params):
            if param is not None and param.requires_grad:
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
