"""ModelServer: the in-process serving front-end.

Counterpart of ``mxnet_tpu/serving/server.py``: multi-model, dynamically
batched, deadline-aware and overload-safe, serving ``nn.Module``s on a CUDA
card (or on the CPU when the caller asks for ``device="cpu"``).

Request lifecycle::

    predict() -> admission (shape check, bounded queue) -> micro-batcher
    coalesces same-shape requests -> padded batch on the bucket ladder ->
    one eager forward on the model's device -> per-row results fan back out

Every terminal state is a *status*, not an exception: TIMEOUT (deadline
passed before execution), OVERLOADED (queue full — shed at admission),
INVALID_INPUT (shape not in the model's bucket menu), ERROR (model raised),
UNAVAILABLE (retryable: circuit breaker open, or the server/model is
shutting down).  Callers distinguish outcomes without try/except around the
hot path, and an overloaded server degrades to fast rejections instead of
growing a queue.

Self-healing (docs/ROBUSTNESS.md): each model carries a circuit breaker
(serving/health.py).  After K consecutive batch failures the breaker opens
and admission fast-fails with UNAVAILABLE — no queueing, no model call —
then half-open probing with exponential backoff recovers the model the
moment its backend comes back.  ``stats()`` exposes per-model ``health``
(HEALTHY/DEGRADED/UNAVAILABLE) and the breaker counters.

Not yet ported: decode engines (``attach_engine``/``detach_engine``/
``engines``, the decode slice), ``load_exported`` (the symbol/export slice)
and the ``serving.predict`` fault point (the port of ``faults.py``).

Quickstart::

    server = serving.ModelServer()
    server.load_model("lm", net, input_shapes=[((128,), (128,))],
                      dtype=("int32", "int32"))
    res = server.predict("lm", (tokens, positions), timeout_ms=500)
    assert res.status == serving.OK
    server.stats()["models"]["lm"]
    server.stop()
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from .batcher import MicroBatcher, Request
from .health import PROBE, REJECT
from .registry import ModelRegistry, ServableModel

__all__ = ["ModelServer", "InferenceResult",
           "OK", "TIMEOUT", "OVERLOADED", "INVALID_INPUT", "ERROR",
           "UNAVAILABLE"]

OK = "OK"
TIMEOUT = "TIMEOUT"
OVERLOADED = "OVERLOADED"
INVALID_INPUT = "INVALID_INPUT"
ERROR = "ERROR"
# retryable terminal state: breaker open or server/model shutting down —
# the caller should back off and try again (or another replica), unlike
# ERROR which means THIS request's execution failed
UNAVAILABLE = "UNAVAILABLE"

# extra client-side wait beyond the deadline before declaring TIMEOUT
# locally (covers worker wakeup jitter; the completion race is settled by
# Request.complete's first-wins lock either way)
_WAIT_GRACE_S = 0.25
# how long result() waits on a deadline-less request whose model is being
# torn down before claiming UNAVAILABLE itself: must exceed the batcher's
# stop() join timeout (5 s) so the drain normally wins the claim
_TEARDOWN_WAIT_S = 6.0


class InferenceResult:
    """Terminal state of one request: status + outputs + latency."""

    __slots__ = ("status", "outputs", "latency_ms", "error")

    def __init__(self, status, outputs=None, latency_ms=None, error=None):
        self.status = status
        self.outputs = outputs
        self.latency_ms = latency_ms
        self.error = error

    @property
    def output(self):
        """First output array (the common single-output convenience)."""
        return self.outputs[0] if self.outputs else None

    def __repr__(self):
        return ("InferenceResult(status=%s, latency_ms=%s%s)"
                % (self.status,
                   None if self.latency_ms is None
                   else round(self.latency_ms, 3),
                   ", error=%r" % self.error if self.error else ""))


class _Entry:
    __slots__ = ("model", "batcher", "default_timeout_ms")

    def __init__(self, model, batcher, default_timeout_ms):
        self.model = model
        self.batcher = batcher
        self.default_timeout_ms = default_timeout_ms


class ModelServer:
    def __init__(self):
        self._registry = ModelRegistry()
        self._t_start = time.time()
        self._lifecycle_lock = threading.Lock()
        # guarded by _lifecycle_lock: name -> _Entry map, the closed flag,
        # and the set of names that were EVER loaded (so result() can tell
        # "model torn down mid-flight" from a caller's typo'd name)
        self._entries = {}
        self._closed = False
        self._ever_loaded = set()

    def _is_closed(self):
        with self._lifecycle_lock:
            return self._closed

    # -- model management ----------------------------------------------
    def load_model(self, name, block, input_shapes, dtype="float32",
                   max_batch=8, batch_ladder=None, max_queue=64,
                   linger_ms=2.0, default_timeout_ms=None, warmup=True,
                   breaker_threshold=5, breaker_backoff_ms=50.0,
                   breaker_max_backoff_ms=2000.0, device=None):
        """Load an ``nn.Module`` for serving on ``device``.

        ``device`` defaults to ``cuda:0`` and raises without CUDA; pass
        ``device="cpu"`` to serve on the CPU.  The module is moved there
        (``block.to(device)``) and runs in inference mode.
        ``input_shapes`` is the complete menu of admissible per-request
        shapes (batch dim excluded); requests outside it get
        INVALID_INPUT.  ``warmup=True`` runs every (shape, ladder rung)
        signature once before the model takes traffic.  Outputs must be
        batch-major (row i of every output belongs to request i) — true of
        standard inference-mode networks.
        """
        device = resolve_device(device)
        with self._lifecycle_lock:
            if self._closed:
                raise MXNetError("server is stopped; create a new "
                                 "ModelServer")
            duplicate = name in self._entries
        if duplicate:
            # cheap early duplicate check so a name collision fails before
            # the model move + whole-bucket-menu warmup; the
            # registry.add below is the authoritative (locked) check
            raise MXNetError("model %r is already loaded" % name)
        model = ServableModel(name, block.to(device), input_shapes, device,
                              dtype=dtype, max_batch=max_batch,
                              batch_ladder=batch_ladder,
                              breaker_threshold=breaker_threshold,
                              breaker_backoff_ms=breaker_backoff_ms,
                              breaker_max_backoff_ms=breaker_max_backoff_ms)
        if warmup:
            model.warmup()
        self._registry.add(model)
        entry = None
        try:
            entry = _Entry(model, MicroBatcher(model, max_queue=max_queue,
                                               linger_ms=linger_ms),
                           default_timeout_ms)
            # final registration re-checks closed under the lifecycle lock:
            # a stop() that raced the (slow) build + warmup above must not
            # end up with a live batcher thread on a stopped server
            with self._lifecycle_lock:
                if self._closed:
                    raise MXNetError("server stopped while loading %r"
                                     % name)
                self._entries[name] = entry
                self._ever_loaded.add(name)
        except Exception:
            self._registry.remove(name)
            if entry is not None:
                entry.batcher.stop()
            raise
        return model

    def unload(self, name):
        # registry first: concurrent predicts turn into unknown-model errors
        # for the whole teardown window (the reverse of load_model's order)
        self._registry.remove(name)
        with self._lifecycle_lock:
            entry = self._entries.pop(name)
        entry.batcher.stop()

    def models(self):
        return self._registry.names()

    def pause(self, name):
        """Stop dispatching ``name`` (maintenance/drain); admission stays
        open up to the queue bound."""
        self._entry(name).batcher.pause()

    def resume(self, name):
        self._entry(name).batcher.resume()

    # -- inference ------------------------------------------------------
    def predict_async(self, name, data, timeout_ms=None):
        """Submit one request; returns a Request handle (``wait()`` then
        read status/outputs) or an InferenceResult for immediate
        rejections (shed / invalid shape / breaker open / shutting down)."""
        if self._is_closed():
            # a closed server is a lifecycle condition, not a caller error:
            # clean retryable status instead of raising at every call site
            return InferenceResult(UNAVAILABLE, latency_ms=0.0,
                                   error="server stopped")
        try:
            entry = self._entry(name)
        except MXNetError:
            if self._is_closed() or name in self._registry.names():
                # closing, or caught mid load/unload transition
                return InferenceResult(UNAVAILABLE, latency_ms=0.0,
                                       error="model %r is mid load/unload "
                                             "or shutting down; retry" % name)
            raise   # genuinely unknown model: keep the helpful error
        model = entry.model
        try:
            inputs = self._coerce(model, data)
        except (ValueError, TypeError) as exc:
            # malformed payload (wrong input count, ragged/uncastable data)
            # is a status like every other terminal state, not an exception
            model.stats.on_invalid()
            return InferenceResult(INVALID_INPUT, latency_ms=0.0,
                                   error=str(exc))
        if not model.admissible(inputs):
            model.stats.on_invalid()
            return InferenceResult(
                INVALID_INPUT, latency_ms=0.0,
                error="shapes %s not in bucket menu %s"
                % ([tuple(a.shape) for a in inputs],
                   sorted(tuple(s for s, _ in k)
                          for k in model.allowed_keys)))
        # breaker admission runs AFTER validation, immediately before the
        # queue: a request that can never execute (invalid shape, malformed
        # payload) must not consume the half-open probe slot, or junk
        # traffic could starve recovery indefinitely
        decision = model.breaker.admit()
        if decision == REJECT:
            # fast retryable rejection: the breaker is open — no queueing,
            # no batcher wakeup, no model call (the self-healing fast path)
            model.stats.on_unavailable(rejected=True)
            snap = model.breaker.snapshot()
            return InferenceResult(
                UNAVAILABLE, latency_ms=0.0,
                error="circuit open after %d consecutive failure(s); "
                      "retry in <= %.0f ms"
                      % (snap["consecutive_failures"],
                         snap["backoff_s"] * 1e3))
        if timeout_ms is None:
            timeout_ms = entry.default_timeout_ms
        deadline = (time.monotonic() + timeout_ms / 1e3
                    if timeout_ms is not None else None)
        request = Request(inputs, deadline=deadline, stats=model.stats)
        admitted = entry.batcher.submit(request)
        if admitted is not True:
            if decision == PROBE:
                # THIS request held the half-open probe slot and never
                # reached the worker: hand the slot back (releasing
                # unconditionally could cancel another request's live probe
                # window and break the single-probe invariant)
                model.breaker.release_probe()
            if admitted == "stopping":
                # the batcher itself reports WHY it refused, so exactly one
                # outcome is counted: a shutdown refusal is UNAVAILABLE
                # (counted here), a full queue already counted its shed
                model.stats.on_unavailable(rejected=True)
                return InferenceResult(UNAVAILABLE, latency_ms=0.0,
                                       error="server shutting down")
            return InferenceResult(OVERLOADED, latency_ms=0.0,
                                   error="admission queue full")
        return request

    def predict(self, name, data, timeout_ms=None):
        """Blocking inference; always returns an InferenceResult."""
        handle = self.predict_async(name, data, timeout_ms=timeout_ms)
        if isinstance(handle, InferenceResult):
            return handle
        return self.result(name, handle)

    def result(self, name, request):
        """Wait a submitted Request out and convert it to a result.

        Safe against teardown races: if the model was unloaded (or the
        server stopped) while the request was in flight, the batcher's
        stop() has completed — or is about to complete — every queued
        request with UNAVAILABLE, so this never hangs on a dead queue and
        never raises KeyError; worst case it claims UNAVAILABLE itself
        after a bounded wait, counting the terminal through the stats
        handle the request carries (conservation survives teardown).  A
        name that was NEVER loaded still raises the unknown-model error —
        a typo must not clobber a live request on a healthy server."""
        try:
            entry = self._entry(name)
        except MXNetError:
            with self._lifecycle_lock:
                known = name in self._ever_loaded
            if not known and not self._is_closed():
                raise
            entry = None   # unloaded/closing mid-flight; see docstring
        stats = entry.model.stats if entry is not None else request.stats
        if request.deadline is not None:
            request.wait(request.deadline - time.monotonic() + _WAIT_GRACE_S)
            # complete() is the atomic claim: if the worker's completion is
            # mid-flight (fields half-written under the lock) this blocks
            # until it finishes and then loses cleanly — an unlocked
            # `status is None` pre-check could pair our TIMEOUT with the
            # worker's outputs
            if request.complete(TIMEOUT):
                if stats is not None:
                    stats.on_result(TIMEOUT, request.latency_ms)
        elif entry is not None:
            request.wait()
        else:
            # no deadline and the model is gone: the teardown drain
            # completes every queued request, but its batcher join can
            # take up to its 5 s timeout with a wedged batch — wait that
            # out before claiming UNAVAILABLE ourselves (counted through
            # the carried stats so the admitted request still reaches
            # exactly one terminal counter)
            if not request.wait(_TEARDOWN_WAIT_S):
                if request.complete(UNAVAILABLE,
                                    error="server shutting down"):
                    if stats is not None:
                        stats.on_result(UNAVAILABLE, request.latency_ms)
        status, outputs, latency_ms, error = request.snapshot()
        return InferenceResult(status, outputs, latency_ms, error)

    # -- observability --------------------------------------------------
    def stats(self):
        """Snapshot: per-model counters + warmup report + health/breaker
        state (health.py)."""
        models = {}
        for name in self._registry.names():
            try:
                model = self._registry.get(name)
            except MXNetError:
                continue   # unloaded between names() and get()
            snap = model.stats.snapshot()
            snap["warmup"] = model.warmup_report
            snap["health"] = model.breaker.health()
            snap["breaker"] = model.breaker.snapshot()
            # convenience alias; the breaker snapshot is the single source
            snap["breaker_opens"] = snap["breaker"]["opens"]
            models[name] = snap
        return {"uptime_s": time.time() - self._t_start, "models": models}

    def health(self, name):
        """HEALTHY / DEGRADED / UNAVAILABLE for one model."""
        return self._entry(name).model.breaker.health()

    # -- lifecycle ------------------------------------------------------
    def stop(self):
        with self._lifecycle_lock:
            self._closed = True
            names = list(self._entries)
        for name in names:
            self.unload(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- internals ------------------------------------------------------
    def _entry(self, name):
        self._registry.get(name)       # raises the helpful unknown-model error
        with self._lifecycle_lock:
            entry = self._entries.get(name)
        if entry is None:
            # registry row exists but the entry doesn't: caller raced a
            # load/unload transition — a clean retryable error, not KeyError
            raise MXNetError("model %r is mid load/unload; retry" % name)
        return entry

    @staticmethod
    def _coerce(model, data):
        """Normalize user data (array / tensor / tuple) to the model's
        per-input numpy arrays with the configured dtypes."""
        if isinstance(data, (list, tuple)):
            items = list(data)
        else:
            items = [data]
        if len(items) != model.n_inputs:
            raise ValueError("model %r takes %d input(s), got %d"
                             % (model.name, model.n_inputs, len(items)))
        out = []
        for x, dt in zip(items, model.dtypes):
            if isinstance(x, torch.Tensor):
                # request admission: device tensors coerce to host rows once
                x = x.detach().cpu().numpy()
            out.append(np.asarray(x, dtype=dt))
        return tuple(out)
