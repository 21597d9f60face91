"""BaseModule: the high-level symbolic training loop (counterpart of
``mxnet_tpu/module/base_module.py``).

``fit`` drives bind, init_params, init_optimizer, then per batch
forward_backward, update and update_metric with the epoch callbacks;
``score``, ``predict`` and ``iter_predict`` evaluate.  ``fit(compiled=None)``
trains through one ``CompiledTrainStep`` (one CUDA graph a window on the
card) unless the configuration is one the capture cannot express, where it
falls back to the eager loop with a one-line warning, as the JAX package
does.  ``fit(resume_from=, auto_resume=)`` restores the newest checkpoint
that the manifest committed (crash recovery, docs/ROBUSTNESS.md).
``fit(prefetch_to_device=ctx)`` reads each epoch through an
``io.DeviceFeed`` that stages the batches on ``ctx`` ahead of the step
(its totals land in ``feed_stats``).  The ZeRO update (``shard_update``,
``wire_format``) and monitors are not ported yet and raise, naming the
ROADMAP item that brings them.
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from ..base import MXNetError
from ..model import BatchEndParam


def _as_list(obj):
    if isinstance(obj, list):
        return obj
    return [obj]


def _fire(callbacks, *args):
    """Invoke a callback, a list of callbacks, or nothing (None)."""
    if callbacks is None:
        return
    for callback in _as_list(callbacks):
        callback(*args)


_NO_BATCH = object()  # sentinel: iterator exhausted


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        candidates = [arg for arg in args if arg not in names]
        msg = "You created Module with Module(..., %s_names=%s) but input " \
              "with name '%s' is not found in symbol.list_arguments(). " \
              "Did you mean one of:\n\t%s" % (typename, str(names), name,
                                               "\n\t".join(candidates))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class BaseModule:
    # lifecycle flags, all False until the corresponding stage runs
    _STAGE_FLAGS = ("binded", "for_training", "inputs_need_grad",
                    "params_initialized", "optimizer_initialized")

    def __init__(self, logger=logging):
        self.logger = logger
        for flag in self._STAGE_FLAGS:
            setattr(self, flag, False)
        self._symbol = None
        self._total_exec_bytes = 0

    # ------------------------------------------------------------------
    # high-level
    # ------------------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self._metric_from_batch(eval_metric, eval_batch)
            _fire(batch_end_callback,
                  BatchEndParam(epoch=epoch, nbatch=nbatch,
                                eval_metric=eval_metric, locals=locals()))
            actual_num_batch += 1
        if score_end_callback:
            _fire(score_end_callback,
                  BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def _metric_from_batch(self, eval_metric, batch):
        """Update a metric from one batch, which may be pre-sliced per device."""
        if isinstance(batch, list):
            self.update_metric(eval_metric, [b.label for b in batch],
                               pre_sliced=True)
        else:
            self.update_metric(eval_metric, batch.label)

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True, reset=True,
                always_output_list=False, sparse_row_id_fn=None):
        from .. import ndarray as nd
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - (pad or 0)].copy()
                       for out in self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                assert len(out) == num_outputs
            output_list2 = [nd.concat(*[out[i] for out in output_list], dim=0)
                            for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None, monitor=None,
            sparse_row_id_fn=None, prefetch_to_device=None,
            resume_from=None, auto_resume=False, compiled=None,
            steps_per_call=1, metric_interval=None, donate="auto",
            shard_update=False, wire_format=None, wire_threshold=0.5):
        """Train the module (``base_module.py:140-260``).

        ``compiled=None``/``True`` captures forward, backward and the
        optimizer update as one ``CompiledTrainStep``: parameters and
        optimizer state update in place on the device, metrics accumulate
        there, and the host fetches them only every ``metric_interval``
        batches (``None``: at an epoch's end), so callbacks see values that
        lag by up to that many batches.  ``steps_per_call=N`` captures a
        window of N batches as one call.  Configurations the capture cannot
        express (kvstore updates, optimizers that are not trace_safe,
        metrics with no device twin) fall back to the eager loop with a
        one-line warning; ``compiled=False`` forces it.  ``donate`` is
        accepted and changes nothing (a graph updates in place).

        Crash recovery (``base_module.py:191-260``): ``resume_from=prefix``
        finds the newest checkpoint that ``prefix-manifest.json`` committed
        and whose files hash-verify (a torn or uncommitted save is
        skipped), restores its parameters, the optimizer state when the
        manifest lists the ``.states`` file, and the epoch, and trains on
        from there; with no complete checkpoint it raises.
        ``auto_resume=True`` resumes when a complete checkpoint exists and
        starts fresh otherwise; without ``resume_from`` it takes the prefix
        from a ``do_checkpoint``/``module_checkpoint`` epoch callback (their
        ``checkpoint_prefix``).

        ``prefetch_to_device=ctx`` reads each epoch through a fresh
        ``io.DeviceFeed`` over ``train_data``: a thread runs the iterator
        and stages each batch on ``ctx`` (pinned memory, a copy on the
        feed's CUDA stream) up to two batches ahead; ``self.feed_stats``
        holds the last epoch's ``DeviceFeed.stats()``."""
        assert num_epoch is not None, "please specify number of epochs"
        for flag, value, item in (
                ("shard_update", shard_update, "queue 1 #8"),
                ("wire_format", wire_format, "queue 1 #8"),
                ("monitor", monitor, "queue 1 #9"),
                ("sparse_row_id_fn", sparse_row_id_fn, "queue 1 #9")):
            if value:
                raise MXNetError("fit(%s=...) is not ported yet (ROADMAP %s)"
                                 % (flag, item))
        import os
        from ..initializer import Uniform
        if initializer is None:
            initializer = Uniform(0.01)

        resume_prefix = resume_from
        if resume_prefix is None and auto_resume and \
                epoch_end_callback is not None:
            for cb in _as_list(epoch_end_callback):
                prefix = getattr(cb, "checkpoint_prefix", None)
                if prefix:
                    resume_prefix = prefix
                    break
        resume_epoch = None
        if resume_prefix is not None:
            from ..model import latest_complete_checkpoint, load_checkpoint
            resume_epoch = latest_complete_checkpoint(resume_prefix)
            if resume_epoch is None:
                if not auto_resume:
                    raise FileNotFoundError(
                        "resume_from=%r: no complete checkpoint found "
                        "(torn/partial saves are skipped via the manifest)"
                        % resume_prefix)
                self.logger.info("auto_resume: no complete checkpoint under "
                                 "%r; starting fresh", resume_prefix)
            else:
                _, arg_params, aux_params = load_checkpoint(
                    resume_prefix, resume_epoch, ctx=self._context[0])
                force_init = True
                allow_missing = False
                begin_epoch = max(begin_epoch, resume_epoch)
                self.logger.info("Resuming from checkpoint %r epoch %d",
                                 resume_prefix, resume_epoch)

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        if resume_epoch is not None:
            # the optimizer state comes along only when the manifest
            # committed it for that epoch: a stray .states from a torn save
            # is not trusted (checkpoint_files lists hash-verified files)
            from ..model import checkpoint_files
            state_file = "%s-%04d.states" % (resume_prefix, resume_epoch)
            listed = checkpoint_files(resume_prefix, resume_epoch)
            if listed is not None and state_file in listed and \
                    os.path.exists(state_file) and \
                    hasattr(self, "load_optimizer_states"):
                self.load_optimizer_states(state_file)
                self.logger.info("Restored optimizer state from %r",
                                 state_file)

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        compiled_step = None
        if compiled is None or compiled:
            from .compiled_step import (CompiledTrainStep,
                                        CompiledStepUnsupported)
            try:
                compiled_step = CompiledTrainStep.from_module(
                    self, eval_metric=eval_metric,
                    steps_per_call=steps_per_call, donate=donate)
            except CompiledStepUnsupported as exc:
                self.logger.warning(
                    "fit(compiled=%s): falling back to the eager loop: %s",
                    compiled, exc)
        self._compiled_step = compiled_step

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            eval_name_vals = []
            feed = None
            if prefetch_to_device is not None:
                from ..io.device_feed import DeviceFeed
                feed = DeviceFeed(train_data, ctx=prefetch_to_device,
                                  name="fit")
                batches = iter(feed)
            else:
                batches = iter(train_data)
            try:
                if compiled_step is not None:
                    nbatch, eval_name_vals = self._fit_compiled_epoch(
                        compiled_step, batches, eval_metric, epoch,
                        batch_end_callback, metric_interval)
                    data_batch = _NO_BATCH
                else:
                    data_batch = next(batches, _NO_BATCH)
                    nbatch = 0
                while data_batch is not _NO_BATCH:
                    self.forward_backward(data_batch)
                    self.update()
                    self._metric_from_batch(eval_metric, data_batch)
                    # fetch the next batch only after training on this one:
                    # an iterator may reuse the previous batch's buffers (a
                    # feed's batches are copies, staged before the source
                    # moves on)
                    upcoming = next(batches, _NO_BATCH)
                    if upcoming is _NO_BATCH:
                        # snapshot before callbacks may auto-reset the metric
                        eval_name_vals = eval_metric.get_name_value()
                    _fire(batch_end_callback,
                          BatchEndParam(epoch=epoch, nbatch=nbatch,
                                        eval_metric=eval_metric,
                                        locals=locals()))
                    data_batch = upcoming
                    nbatch += 1
            finally:
                if feed is not None:
                    self.feed_stats = feed.stats()
                    feed.close()
            for name, val in eval_name_vals:
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            toc = time.time()
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, (toc - tic))
            arg_params_, aux_params_ = self.get_params()
            if compiled_step is None:
                # the reference's sync-back of the averaged parameters; the
                # compiled step's state handles are the parameters already
                self.set_params(arg_params_, aux_params_)
            _fire(epoch_end_callback, epoch, self.symbol, arg_params_,
                  aux_params_)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    def _fit_compiled_epoch(self, cstep, batches, eval_metric, epoch,
                            batch_end_callback, metric_interval):
        """One epoch through the compiled train step.

        Batches group into windows of ``cstep.steps_per_call`` (the epoch
        tail dispatches as a shorter window — one extra compiled signature,
        stable across epochs); each window is ONE CachedOp dispatch with no
        host fetch.  Metrics sync from the device accumulators only every
        ``metric_interval`` batches and at epoch end, so callbacks observe
        values that lag up to one interval."""
        nbatch = 0
        eval_name_vals = []
        window = []
        data_batch = next(batches, _NO_BATCH)
        while data_batch is not _NO_BATCH:
            window.append(data_batch)
            upcoming = next(batches, _NO_BATCH)
            if len(window) == cstep.steps_per_call or upcoming is _NO_BATCH:
                cstep.run_window([tuple(b.data) + tuple(b.label or ())
                                  for b in window])
                last_in_epoch = upcoming is _NO_BATCH
                for i in range(len(window)):
                    done = nbatch + 1
                    is_final = last_in_epoch and i == len(window) - 1
                    if is_final or (metric_interval
                                    and done % metric_interval == 0):
                        cstep.sync_metric()
                    if is_final:
                        # snapshot before callbacks may auto-reset the metric
                        eval_name_vals = eval_metric.get_name_value()
                    _fire(batch_end_callback,
                          BatchEndParam(epoch=epoch, nbatch=nbatch,
                                        eval_metric=eval_metric,
                                        locals=locals()))
                    nbatch = done
                window = []
            data_batch = upcoming
        return nbatch, eval_name_vals

    # ------------------------------------------------------------------
    # abstract interface
    # ------------------------------------------------------------------
    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    @property
    def symbol(self):
        return self._symbol

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        from ..ndarray import utils as nd
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        from ..ndarray import utils as nd
        save_dict = nd.load(fname, ctx=self._context[0])
        arg_params = {}
        aux_params = {}
        for k, value in save_dict.items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()
