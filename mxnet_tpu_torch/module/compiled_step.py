"""CompiledTrainStep: a whole training iteration as one CachedOp
(counterpart of ``mxnet_tpu/module/compiled_step.py``).

Forward, backward, the optimizer update of every parameter and the metric
accumulators run as one function of the training state, which a
``cached_op.CachedOp`` captures into one CUDA graph per window signature
on the card and replays after that (the JAX package compiles it with
``jax.jit``):

* the state is a flat ``{key: tensor}``: ``p:`` parameters, ``a:`` aux
  arrays, ``o:`` optimizer-state leaves, ``m:`` metric accumulators; the
  SAME tensors the module or block reads, updated in place inside the
  graph (so ``donate`` has nothing to do and is accepted for parity);
* ``steps_per_call=N`` captures a window of N batches as one graph, the
  microsteps one after another (a shorter window, such as an epoch's
  tail, is one more signature);
* metrics accumulate on the device through each metric's
  ``traced_update``; the host fetches the (sum, count) pair only at
  ``metric_interval`` boundaries or at an epoch's end (:meth:`sync_metric`),
  and nothing inside the step;
* the learning rate (scheduler applied on the host) and the step count
  ``t`` enter as per-step 0-d tensors copied in before each replay, so
  schedules and the ``t``-dependent arithmetic of every ``trace_safe``
  optimizer (Adam's and Adamax's bias corrections, FTML's ``t`` attribute)
  run captured without a new capture (``_step_hyperparams``);
* a resume that loads optimizer states after the step was built copies
  them into the tensors the graph updates (:meth:`reload_optimizer_states`,
  called by ``Module.load_optimizer_states``).

Two frontends: :meth:`CompiledTrainStep.from_module` (a bound ``Module``
and its optimizer: the executor's graph, gradients with ones head
gradients as ``backward()`` gives them, the optimizer's own
``update_multi_precision``) and :meth:`CompiledTrainStep.from_block` (a
Gluon block with an explicit loss, through ``gluon.block.functional_call``
and ``torch.autograd.grad``).  Configurations the capture cannot express
raise :class:`CompiledStepUnsupported`, and ``fit`` falls back to the
eager loop with a one-line warning: multi-context binds, kvstore updates,
optimizers that are not ``trace_safe``, metrics with no device twin.
"""
from __future__ import annotations

import contextlib

import torch

from .. import autograd
from ..base import MXNetError
from ..cached_op import CachedOp
from ..ndarray.ndarray import NDArray

__all__ = ["CompiledTrainStep", "CompiledStepUnsupported"]


class CompiledStepUnsupported(MXNetError):
    """This configuration cannot be captured as one step; the message says
    why.  Callers fall back to the eager loop."""


_MISSING = object()


@contextlib.contextmanager
def _step_hyperparams(opt, lr_val, t_val):
    """Route the optimizer's per-step values through 0-d tensors for one
    captured update: ``_get_lr`` gives ``lr_val`` (the scheduler's base
    rate for this microstep) times the parameter's multiplier, and the
    update counts read ``t_val``.  Count writes are dropped: the host
    advances the real counters after the call (``_advance_counts``)."""

    class _Counts(dict):
        def __missing__(self, key):
            return t_val

        def __setitem__(self, key, value):
            pass

    saved = {name: opt.__dict__.get(name, _MISSING)
             for name in ("_get_lr", "_update_count", "_index_update_count")}
    opt._get_lr = lambda index: lr_val * opt._index_mult(
        index, opt.lr_mult, "lr_mult")
    opt._update_count = lambda index: None
    opt._index_update_count = _Counts()
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is _MISSING:
                del opt.__dict__[name]
            else:
                setattr(opt, name, value)


def _state_leaves(state):
    """Tensor leaves of an optimizer-state structure, depth-first."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (list, tuple)):
        return [leaf for part in state for leaf in _state_leaves(part)]
    return []


def _rebuild_state(template, leaf_iter):
    if isinstance(template, torch.Tensor):
        return next(leaf_iter)
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild_state(part, leaf_iter)
                              for part in template)
    return template


def _check_optimizer(opt):
    if not getattr(opt, "trace_safe", False):
        raise CompiledStepUnsupported(
            "optimizer %s is not marked trace_safe (its update cannot be "
            "captured in a fixed trace)" % type(opt).__name__)


def _metric_leaves(metric):
    """A metric, composite or not, as its device-updatable leaves."""
    from .. import metric as metric_mod
    if metric is None:
        return []
    if isinstance(metric, metric_mod.CompositeEvalMetric):
        leaves = []
        for child in metric.metrics:
            leaves.extend(_metric_leaves(child))
        return leaves
    if not metric.supports_device_update():
        raise CompiledStepUnsupported(
            "metric %s (%s) has no traced_update device twin"
            % (metric.name, type(metric).__name__))
    return [metric]


def _val(handle):
    return handle._data if isinstance(handle, NDArray) else handle


def _fetch(t):
    """The step's one kind of host fetch: a scalar accumulator's value."""
    return t.item()


class CompiledTrainStep:
    """Training over windows of up to ``steps_per_call`` batches, one
    CachedOp call a window.  Build it with :meth:`from_module` or
    :meth:`from_block`.  ``state`` is the flat dict of handles (tensors,
    or the module's NDArrays) that the step reads and writes in place.
    ``donate`` is accepted for the JAX package's signature and changes
    nothing: a graph updates its state in place already."""

    def __init__(self, microstep, state, optimizer, opt_bindings,
                 opt_indices, metrics, metric_keys, n_inputs,
                 steps_per_call, device, donate="auto", owner=None,
                 updater=None):
        if steps_per_call < 1:
            raise ValueError("steps_per_call must be >= 1")
        self._microstep = microstep
        self.state = state
        self._state_names = sorted(state)
        self._optimizer = optimizer
        self._opt_bindings = opt_bindings
        self._opt_indices = opt_indices
        self._metrics = metrics
        self._metric_keys = metric_keys
        self._n_inputs = n_inputs
        self.steps_per_call = steps_per_call
        self._device = device
        self._owner = owner
        self._updater = updater
        self.cached_op = CachedOp(self._make_forward_fn(), state,
                                  aux_names=tuple(state))

    # -- the captured function ------------------------------------------
    def _make_forward_fn(self):
        from ..gluon.block import _CachedForward
        microstep = self._microstep
        opt_bindings = self._opt_bindings
        metrics = self._metrics
        metric_keys = self._metric_keys
        opt = self._optimizer

        def apply_optimizer(p, grads, lr_t, t_t):
            staged = []
            for index, pkey, template, leaf_keys in opt_bindings:
                state = _rebuild_state(template,
                                       iter([p[k] for k in leaf_keys]))
                staged.append((index, p[pkey], grads[pkey], state))
            with _step_hyperparams(opt, lr_t, t_t):
                for index, weight, grad, state in staged:
                    opt.update_multi_precision(index, weight, grad, state)

        def body(p, t_t, lr_t, batch):
            grads, updates, preds, labels, extra = microstep(p, batch)
            with torch.no_grad():
                for key, v in updates.items():
                    p[key].copy_(v)
                apply_optimizer(p, grads, lr_t, t_t)
                deltas = []
                for m, (skey, ckey) in zip(metrics, metric_keys):
                    stat, count = m.traced_update(labels, preds)
                    p[skey].add_(stat)
                    p[ckey].add_(count)
                    deltas += [stat, count]
            if extra is not None:
                return extra.detach().to(torch.float32).reshape(())
            if deltas:
                return torch.stack(deltas)
            return t_t.new_zeros(())

        def forward_fn(p, t_vec, lr_vec, *stacked):
            with _CachedForward():
                ys = [body(p, t_vec[k], lr_vec[k], [s[k] for s in stacked])
                      for k in range(t_vec.shape[0])]
            return torch.stack(ys)

        return forward_fn

    # -- dispatch -------------------------------------------------------
    def _hyper_vectors(self, window):
        """The window's step counts and learning rates, on the device (a
        pinned copy, so the host does not wait on the card)."""
        opt = self._optimizer
        ts, lrs = [], []
        for k in range(1, window + 1):
            t = opt.num_update + k
            ts.append(float(t))
            lrs.append(float(opt.lr_scheduler(t)) if opt.lr_scheduler
                       is not None else float(opt.lr))
        host = torch.tensor([ts, lrs], dtype=torch.float32)
        if self._device.type == "cuda":
            host = host.pin_memory()
        dev = host.to(self._device, non_blocking=True)
        return dev[0], dev[1]

    def _advance_counts(self, window):
        opt = self._optimizer
        for index in self._opt_indices:
            count = opt._index_update_count.get(
                index, opt.begin_num_update) + window
            opt._index_update_count[index] = count
            opt.num_update = max(count, opt.num_update)

    def run_window(self, batches_io):
        """Train on a window of 1..steps_per_call batches in one call.

        ``batches_io``: one tuple of input arrays (tensors or NDArrays) per
        batch, in the step's input order (data, then labels).  Returns the
        per-microstep outputs without fetching them: the losses of a
        ``from_block`` step, the metric deltas of a ``from_module`` one."""
        window = len(batches_io)
        if not 1 <= window <= self.steps_per_call:
            raise ValueError("window of %d batches vs steps_per_call=%d"
                             % (window, self.steps_per_call))
        if self._n_inputs is not None and \
                len(batches_io[0]) != self._n_inputs:
            raise ValueError("batch provides %d inputs, step expects %d"
                             % (len(batches_io[0]), self._n_inputs))
        t_vec, lr_vec = self._hyper_vectors(window)
        stacked = [torch.stack([_val(b[j]).detach() for b in batches_io])
                   .to(self._device, non_blocking=True)
                   for j in range(len(batches_io[0]))]
        with autograd.train_mode():
            out = self.cached_op({k: _val(v) for k, v in self.state.items()},
                                 t_vec, lr_vec, *stacked)
        self._advance_counts(window)
        if self._owner is not None:
            self._owner._params_dirty = True
        return out

    def step(self, *inputs):
        """One batch: :meth:`run_window` of a window of one."""
        return self.run_window([tuple(inputs)])

    def sync_metric(self):
        """Fetch the device accumulators into their metrics and zero them:
        the step's only host fetch, for ``metric_interval`` boundaries and
        an epoch's end."""
        for m, (skey, ckey) in zip(self._metrics, self._metric_keys):
            s, c = _val(self.state[skey]), _val(self.state[ckey])
            stat, count = _fetch(s), _fetch(c)
            if stat or count:
                m._device_accumulate(stat, count)
            with torch.no_grad():
                s.zero_()
                c.zero_()

    def reload_optimizer_states(self):
        """Copy the updater's states, loaded from a file since this step
        was built, into the state tensors the step updates in place, and
        point the updater at those tensors again (a resume under the
        compiled path)."""
        updater = self._updater
        for index, _pkey, template, leaf_keys in self._opt_bindings:
            if updater.states_synced.get(index, True):
                continue
            loaded = updater._to_tensor(updater.states[index], self._device)
            with torch.no_grad():
                for key, value in zip(leaf_keys, _state_leaves(loaded)):
                    _val(self.state[key]).copy_(value)
            updater.states[index] = template
            updater.states_synced[index] = True

    def cache_stats(self):
        """The CachedOp's signature counts."""
        return self.cached_op.cache_stats()

    def capture_stats(self):
        return self.cached_op.capture_stats()

    @staticmethod
    def _metric_state(state, metrics, device):
        """One (sum, count) pair of fp32 0-d accumulators a metric."""
        keys = []
        for j, _m in enumerate(metrics):
            skey, ckey = "m:%d:s" % j, "m:%d:n" % j
            for key in (skey, ckey):
                state[key] = torch.zeros((), dtype=torch.float32,
                                         device=device)
            keys.append((skey, ckey))
        return keys

    # -- frontends -------------------------------------------------------
    @classmethod
    def from_module(cls, module, eval_metric=None, steps_per_call=1,
                    donate="auto"):
        """Capture a bound, initialized Module's forward, backward and
        update.  The state is the executor's own ``arg_dict``/``aux_dict``
        arrays and the updater's states, so ``get_params()`` and the
        eager path see what the step trains."""
        handles_fn = getattr(module, "_compiled_step_handles", None)
        if handles_fn is None:
            raise CompiledStepUnsupported(
                "%s has no compiled-step support" % type(module).__name__)
        h = handles_fn()
        exe, opt, updater = h["executor"], h["optimizer"], h["updater"]
        if updater is None:
            raise CompiledStepUnsupported("no local updater")
        _check_optimizer(opt)
        metrics = _metric_leaves(eval_metric)

        param_names = [n for n in h["param_names"] if n in exe.arg_names]
        input_names = list(h["data_names"]) + list(h["label_names"])
        for name in h["data_names"]:
            if name not in exe.arg_names:
                raise CompiledStepUnsupported(
                    "data input %r is not a graph argument" % name)
        wrt_names = [n for n in param_names
                     if exe.grad_req.get(n, "null") != "null"]
        for n in wrt_names:
            if exe.grad_req[n] != "write":
                raise CompiledStepUnsupported(
                    "grad_req=%r for %r (only 'write' is capturable)"
                    % (exe.grad_req[n], n))
        if not wrt_names:
            raise CompiledStepUnsupported("no trainable parameters")

        fn = exe._build_fn(True)
        aux_names = list(exe.aux_names)
        arg_names = list(exe.arg_names)
        # optimizer states under the eager updater's indices, so the two
        # paths share them
        name_to_index = {n: i for i, n in enumerate(param_names)}
        for n in wrt_names:
            index = name_to_index[n]
            weight = exe.arg_dict[n]._data
            if index not in updater.states:
                updater.states[index] = \
                    opt.create_state_multi_precision(index, weight)
                updater.states_synced[index] = True
            elif not updater.states_synced.get(index, True):
                updater.states[index] = updater._to_tensor(
                    updater.states[index], weight.device)
                updater.states_synced[index] = True

        state = {}
        for n in param_names:
            state["p:" + n] = exe.arg_dict[n]
        for n in aux_names:
            state["a:" + n] = exe.aux_dict[n]
        opt_bindings, opt_indices = [], []
        for n in wrt_names:
            index = name_to_index[n]
            template = updater.states[index]
            leaves = _state_leaves(template)
            leaf_keys = ["o:%s:%d" % (n, i) for i in range(len(leaves))]
            state.update(zip(leaf_keys, leaves))
            opt_bindings.append((index, "p:" + n, template, leaf_keys))
            opt_indices.append(index)
        device = exe._ctx
        metric_keys = cls._metric_state(state, metrics, device)

        input_pos = {n: i for i, n in enumerate(input_names)}
        label_idx = [input_pos[n] for n in h["label_names"]]
        wrt_set = set(wrt_names)

        def microstep(p, batch):
            leaves = {n: p["p:" + n].detach().requires_grad_()
                      for n in wrt_names}
            arg_vals = [batch[input_pos[n]] if n in input_pos
                        else leaves[n] if n in wrt_set else p["p:" + n]
                        for n in arg_names]
            with torch.enable_grad():
                outs = fn(arg_vals, [p["a:" + n] for n in aux_names])
                # the fit loop's backward(): ones head gradients
                diff = [o for o in outs if o.requires_grad]
                grad_vals = torch.autograd.grad(
                    diff, [leaves[n] for n in wrt_names],
                    [torch.ones_like(o) for o in diff], allow_unused=True)
            grads = {"p:" + n: g if g is not None
                     else torch.zeros_like(leaves[n])
                     for n, g in zip(wrt_names, grad_vals)}
            preds = [o.detach() for o in outs]
            labels = [batch[i] for i in label_idx]
            return grads, {}, preds, labels, None

        return cls(microstep, state, opt, opt_bindings, opt_indices, metrics,
                   metric_keys, len(input_names), steps_per_call, device,
                   donate, owner=module, updater=updater)

    @classmethod
    def from_block(cls, block, loss_fn, optimizer, n_inputs=1,
                   eval_metric=None, steps_per_call=1, donate="auto"):
        """Capture a Gluon block, an explicit loss and an optimizer.

        ``loss_fn(outputs, *labels)`` takes the block's outputs (a list of
        tensors) and the labels and returns a one-element loss, whose
        gradient is the step's; the first ``n_inputs`` step inputs feed the
        block, the rest the loss and the metrics.  Parameters and aux
        arrays are updated in place in the block's own tensors; the
        optimizer's states are made here, as a Trainer makes them at its
        first step."""
        from ..gluon.block import functional_call, split_param_names
        _check_optimizer(optimizer)
        metrics = _metric_leaves(eval_metric)
        params = {p.name: p for p in block.collect_params().values()}
        train_names, frozen_names = split_param_names(block)
        tensors = {n: params[n]._check_and_get() for n in params}
        device = next(iter(tensors.values())).device

        state = {"p:" + n: tensors[n] for n in params}
        opt_bindings = []
        for n in train_names:
            template = optimizer.create_state_multi_precision(n, tensors[n])
            leaves = _state_leaves(template)
            leaf_keys = ["o:%s:%d" % (n, i) for i in range(len(leaves))]
            state.update(zip(leaf_keys, leaves))
            opt_bindings.append((n, "p:" + n, template, leaf_keys))
        metric_keys = cls._metric_state(state, metrics, device)

        def microstep(p, batch):
            x_vals, label_vals = batch[:n_inputs], batch[n_inputs:]
            leaves = {n: p["p:" + n].detach().requires_grad_()
                      for n in train_names}
            full = {n: p["p:" + n] for n in frozen_names}
            full.update(leaves)
            with torch.enable_grad():
                outs, new_aux = functional_call(block, full, *x_vals,
                                                training=True)
                loss = loss_fn(list(outs), *label_vals).reshape(())
                grad_vals = torch.autograd.grad(
                    loss, [leaves[n] for n in train_names],
                    allow_unused=True)
            grads = {"p:" + n: g if g is not None
                     else torch.zeros_like(leaves[n])
                     for n, g in zip(train_names, grad_vals)}
            updates = {"p:" + n: v for n, v in new_aux.items()}
            return (grads, updates, [o.detach() for o in outs],
                    list(label_vals), loss)

        return cls(microstep, state, optimizer, opt_bindings,
                   list(train_names), metrics, metric_keys, None,
                   steps_per_call, device, donate)
