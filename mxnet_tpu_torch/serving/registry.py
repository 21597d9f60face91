"""Multi-model registry: loadable, warmable, inference-mode models.

Counterpart of ``mxnet_tpu/serving/registry.py``.  A ``ServableModel``
wraps one ``nn.Module`` plus its bucket menu (admissible input shapes x
batch ladder).  The JAX package runs the block as an inference-mode
``CachedOp`` and warms up to compile every signature; here the module runs
eagerly under ``torch.inference_mode()`` on its own device, and
``warmup()`` runs every (shape variant, ladder rung) once so first traffic
meets built kernels and a settled allocator.  There is nothing to compile,
so the warmup report carries no compile counts.

The registry itself is a flat name -> ServableModel map guarded by one lock;
models load/unload independently and hold no shared mutable state.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .. import util
from ..base import MXNetError
from .buckets import BucketLadder, normalize_shape_variants, shape_key
from .health import CircuitBreaker
from .stats import ModelStats

__all__ = ["ServableModel", "ModelRegistry"]

# retry envelope around one batch execution: transient faults are absorbed
# here; anything that outlasts the budget surfaces to the batcher as the
# batch failure it is
_EXEC_ATTEMPTS = 3
_EXEC_BACKOFF_S = 0.002


class ServableModel:
    """One loaded model: module + device + bucket menu + per-model stats +
    circuit breaker (health.py)."""

    def __init__(self, name, block, input_shapes, device, dtype="float32",
                 max_batch=8, batch_ladder=None, breaker_threshold=5,
                 breaker_backoff_ms=50.0, breaker_max_backoff_ms=2000.0):
        self.name = name
        self.block = block
        self.device = device
        self.ladder = (batch_ladder if isinstance(batch_ladder, BucketLadder)
                       else BucketLadder(max_batch, batch_ladder))
        self.variants = normalize_shape_variants(input_shapes)
        n_inputs = len(self.variants[0])
        if any(len(v) != n_inputs for v in self.variants):
            raise ValueError("all shape variants must have the same number "
                             "of inputs")
        self.n_inputs = n_inputs
        if isinstance(dtype, (list, tuple)):
            if len(dtype) != n_inputs:
                raise ValueError("need one dtype per input")
            self.dtypes = [np.dtype(d) for d in dtype]
        else:
            self.dtypes = [np.dtype(dtype)] * n_inputs
        self.stats = ModelStats()
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_threshold,
            backoff_s=breaker_backoff_ms / 1e3,
            max_backoff_s=breaker_max_backoff_ms / 1e3)
        self._execute_retry = util.retry(
            attempts=_EXEC_ATTEMPTS, backoff=_EXEC_BACKOFF_S,
            on_retry=lambda exc, i: self.stats.on_retry())(self._execute_once)
        self.warmup_report = None
        # every admissible (per-request shapes, dtypes) coalescing key
        self.allowed_keys = frozenset(
            tuple((shape, str(dt)) for shape, dt in zip(v, self.dtypes))
            for v in self.variants)

    # ------------------------------------------------------------------
    def execute(self, batch_arrays):
        """Run one padded batch (numpy, batch-major) -> list of numpy
        outputs, still batch-major, behind the transient-retry envelope.
        Failures that outlast the budget propagate to the batcher, which
        fails the batch and reports to the circuit breaker."""
        return self._execute_retry(batch_arrays)

    def _execute_once(self, batch_arrays):
        # inference mode is per-thread state: enter it here, on whichever
        # thread (batcher worker, warmup caller) runs the batch; CUDA
        # kernels launch on that thread's current stream of self.device
        with torch.inference_mode():
            inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                      for a in batch_arrays]
            out = self.block(*inputs)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            # serving boundary: results materialize on the host
            return [o.cpu().numpy() for o in outs]

    def warmup(self):
        """Run every (shape variant, ladder rung) signature once.

        Returns {"signatures": n} and stores it as ``self.warmup_report``."""
        n = 0
        for variant in self.variants:
            for rung in self.ladder:
                arrays = [np.zeros((rung,) + shape, dt)
                          for shape, dt in zip(variant, self.dtypes)]
                self.execute(arrays)
                n += 1
        self.warmup_report = {"signatures": n}
        return self.warmup_report

    def admissible(self, arrays):
        return shape_key(arrays) in self.allowed_keys


class ModelRegistry:
    """Thread-safe name -> ServableModel map."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models = {}

    def add(self, model):
        with self._lock:
            if model.name in self._models:
                raise MXNetError("model %r is already loaded" % model.name)
            self._models[model.name] = model

    def remove(self, name):
        with self._lock:
            try:
                return self._models.pop(name)
            except KeyError:
                raise MXNetError("no model %r; loaded: %s"
                                 % (name, sorted(self._models) or "none"))

    def get(self, name):
        with self._lock:
            try:
                return self._models[name]
            except KeyError:
                raise MXNetError("no model %r; loaded: %s"
                                 % (name, sorted(self._models) or "none"))

    def names(self):
        with self._lock:
            return sorted(self._models)
