"""Multi-model registry: loadable, warmable, inference-mode CachedOps.

Counterpart of ``mxnet_tpu/serving/registry.py``.  A ``ServableModel``
wraps one Gluon block as an inference-mode ``cached_op.CachedOp`` (its
own instance, built by ``gluon.block.build_cached_op``, so the block's
``hybridize`` cache is left alone) plus its bucket menu (admissible input
shapes x batch ladder).  ``warmup()`` runs a zeros batch for every (shape
variant, ladder rung) at load time, which on the card captures each
signature's CUDA graph before traffic arrives; after that
``cache_stats()`` shows no new misses in steady state, and each batch is
one graph replay.  On the CPU the op runs the block eagerly.

The registry itself is a flat name -> ServableModel map guarded by one lock;
models load/unload independently and hold no shared mutable state.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .. import autograd, faults, util
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
    """One loaded model: CachedOp + device + bucket menu + per-model stats
    + circuit breaker (health.py)."""

    def __init__(self, name, block, input_shapes, device, dtype="float32",
                 max_batch=8, batch_ladder=None, breaker_threshold=5,
                 breaker_backoff_ms=50.0, breaker_max_backoff_ms=2000.0,
                 generation=None):
        self.name = name
        self.block = block
        self.device = device
        # weight generation tag (serving/deploy.py): which checkpoint epoch
        # this copy's params came from; None = untagged standalone use
        self.generation = generation
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
        self._ensure_initialized(block)
        from ..gluon.block import build_cached_op
        self._cop, params = build_cached_op(block)
        self._params = {n: p._check_and_get() for n, p in params.items()}
        self.stats = ModelStats(name)
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

    def _ensure_initialized(self, block):
        """Finish deferred parameter shapes with a zeros probe if needed."""
        if not any(p._is_lazy() for p in block.collect_params().values()):
            return
        probe = [torch.zeros((1,) + v, dtype=_torch_dtype(dt),
                             device=self.device)
                 for v, dt in zip(self.variants[0], self.dtypes)]
        with autograd.pause():
            block(*probe)

    # ------------------------------------------------------------------
    def execute(self, batch_arrays):
        """Run one padded batch (numpy, batch-major) -> list of numpy
        outputs, still batch-major, behind the transient-retry envelope.
        Failures that outlast the budget propagate to the batcher, which
        fails the batch and reports to the circuit breaker."""
        return self._execute_retry(batch_arrays)

    def _execute_once(self, batch_arrays):
        faults.fault_point("serving.predict", model=self.name)
        # recording and training are per-thread state: pause both here, on
        # whichever thread (batcher worker, warmup caller) runs the batch;
        # the op replays and copies its outputs under its own lock, on that
        # thread's current stream of self.device
        inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                  for a in batch_arrays]
        with autograd.pause():
            out = self._cop(self._params, *inputs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        # serving boundary: results materialize on the host
        return [o.cpu().numpy() for o in outs]

    def warmup(self):
        """Capture every (shape variant, ladder rung) signature.

        Returns {"signatures": n, "compiles": misses_delta, "cache": {...}}
        and stores it as ``self.warmup_report``: load-time cost for zero
        captures in steady state."""
        before = self._cop.cache_stats()["misses"]
        n = 0
        for variant in self.variants:
            for rung in self.ladder:
                arrays = [np.zeros((rung,) + shape, dt)
                          for shape, dt in zip(variant, self.dtypes)]
                self.execute(arrays)
                n += 1
        after = self._cop.cache_stats()
        self.warmup_report = {
            "signatures": n,
            "compiles": after["misses"] - before,
            "cache": {"hits": after["hits"], "misses": after["misses"]},
        }
        return self.warmup_report

    def cache_stats(self):
        return self._cop.cache_stats()

    def capture_stats(self):
        return self._cop.capture_stats()

    def admissible(self, arrays):
        return shape_key(arrays) in self.allowed_keys


def _torch_dtype(dtype):
    return torch.from_numpy(np.zeros(0, dtype)).dtype


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
