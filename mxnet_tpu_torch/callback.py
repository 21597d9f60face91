"""Epoch / batch callbacks for the fit loops (counterpart of
``mxnet_tpu/callback.py``): the same factories and callables, around two
small helpers (`_every`, a period gate, and `_metric_pairs`, a safe metric
reader).

Batch callbacks receive a ``BatchEndParam``-style object with ``epoch``,
``nbatch``, ``eval_metric`` and ``locals`` fields; epoch callbacks receive
``(epoch, symbol, arg_params, aux_params)``.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint", "log_train_metric",
           "module_checkpoint"]


def _every(period):
    """Normalize a save/log period: at least 1, integer."""
    return max(1, int(period))


def _metric_pairs(metric, reset=False):
    """(name, value) pairs from an EvalMetric, or [] when there is none."""
    if metric is None:
        return []
    pairs = metric.get_name_value()
    if reset:
        metric.reset()
    return pairs


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback: checkpoint a Module every `period` epochs."""
    period = _every(period)

    def _save(epoch, sym=None, arg=None, aux=None):
        done = epoch + 1
        if done % period == 0:
            mod.save_checkpoint(prefix, done, save_optimizer_states)
    # the prefix a resuming fit would find (resume is not ported yet)
    _save.checkpoint_prefix = prefix
    return _save


def do_checkpoint(prefix, period=1):
    """Epoch-end callback: save symbol + params every `period` epochs."""
    from .model import save_checkpoint
    period = _every(period)

    def _save(epoch, sym, arg, aux):
        done = epoch + 1
        if done % period == 0:
            save_checkpoint(prefix, done, sym, arg, aux)
    _save.checkpoint_prefix = prefix
    return _save


def log_train_metric(period, auto_reset=False):
    """Batch-end callback: log the training metric every `period` batches."""
    period = _every(period)

    def _log(param):
        if param.nbatch % period:
            return
        for name, value in _metric_pairs(param.eval_metric, reset=auto_reset):
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
    return _log


class Speedometer:
    """Batch-end callback: log samples/sec (and metrics) every `frequent`
    batches, timing each window from the end of the previous report."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = _every(frequent)
        self.auto_reset = auto_reset
        self._window_start = None   # perf_counter at last report (or epoch start)
        self._window_batch = 0      # nbatch at that moment

    def __call__(self, param):
        now = time.perf_counter()
        if self._window_start is None or param.nbatch < self._window_batch:
            # first call, or a new epoch rewound the batch counter
            self._window_start, self._window_batch = now, param.nbatch
            return
        self._window_batch = param.nbatch
        if param.nbatch == 0 or param.nbatch % self.frequent:
            return
        elapsed = max(now - self._window_start, 1e-12)
        rate = self.frequent * self.batch_size / elapsed
        parts = ["Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                 % (param.epoch, param.nbatch, rate)]
        parts += ["%s=%f" % pair
                  for pair in _metric_pairs(param.eval_metric,
                                            reset=self.auto_reset)]
        logging.info("\t".join(parts))
        self._window_start = time.perf_counter()


class ProgressBar:
    """Batch-end callback: render a textual progress bar over `total`."""

    def __init__(self, total, length=80):
        self.total = total
        self.length = length

    def __call__(self, param):
        frac = min(param.nbatch / float(self.total), 1.0)
        done = int(round(self.length * frac))
        bar = "=" * done + "-" * (self.length - done)
        logging.info("[%s] %d%%\r", bar, int(frac * 100 + 0.999999))
