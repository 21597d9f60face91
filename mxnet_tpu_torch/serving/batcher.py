"""Dynamic micro-batcher: bounded admission queue + coalescing worker.

Counterpart of ``mxnet_tpu/serving/batcher.py``, unchanged in behaviour.

One ``MicroBatcher`` (one worker thread) per loaded model:

* **admission** — ``submit()`` either enqueues or refuses immediately when
  the bounded queue is full (load-shedding backpressure: the caller gets an
  OVERLOADED status now instead of the queue growing until the process
  OOMs).  The reference engine has the same discipline at the C++ boundary
  (bounded ThreadedEngine task queues).
* **coalescing** — the worker pops the oldest request, lingers up to
  ``linger_ms`` for companions with the SAME shape key (different shapes
  never mix: batch-dim padding is exact, feature-dim padding is not — see
  buckets.py), then executes one batch padded to the smallest ladder rung.
* **deadlines** — a request whose deadline passed while queued or lingering
  completes with TIMEOUT *without* executing; the linger window is clipped
  so a lone request dispatches a little before its deadline rather than
  expiring in the queue.

The worker holds the lock only to move requests between queue and batch;
execution (the model call) runs unlocked, so submitters never block on
compute.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from .buckets import shape_key

__all__ = ["Request", "MicroBatcher"]

# linger is clipped to (deadline - margin) so a near-deadline request is
# dispatched rather than expired while waiting for companions
_DEADLINE_MARGIN_S = 0.005


class Request:
    """One in-flight inference request (also the async result handle)."""

    __slots__ = ("inputs", "key", "t_enqueue", "deadline", "status",
                 "outputs", "error", "latency_ms", "stats", "_event",
                 "_done_lock")

    def __init__(self, inputs, deadline=None, stats=None):
        self.inputs = tuple(inputs)          # per-request numpy arrays
        self.key = shape_key(self.inputs)
        self.t_enqueue = time.monotonic()
        self.deadline = deadline             # monotonic seconds or None
        # the owning model's ModelStats, attached at submission so a
        # claimant can keep the terminal counters conserved even after the
        # model/server entry is torn down (result() across unload)
        self.stats = stats
        self.status = None
        self.outputs = None
        self.error = None
        self.latency_ms = None
        self._event = threading.Event()
        self._done_lock = threading.Lock()

    def expired(self, now=None):
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                >= self.deadline)

    def complete(self, status, outputs=None, error=None):
        """First completion wins (client timeout vs worker result race)."""
        with self._done_lock:
            if self.status is not None:
                return False
            self.outputs = outputs
            self.error = error
            self.latency_ms = (time.monotonic() - self.t_enqueue) * 1e3
            # status is assigned LAST: it is the done flag every racing
            # reader keys on, so a terminal status must never be visible
            # before the fields that go with it
            self.status = status
        self._event.set()
        return True

    def wait(self, timeout=None):
        return self._event.wait(timeout)

    def snapshot(self):
        """Atomic read of the terminal state.

        Readers must NOT sample ``status``/``outputs``/``latency_ms`` as
        separate unlocked reads: a deadline expiry racing a batch
        completion could interleave them and pair a TIMEOUT status with
        the other completion's outputs (the torn-read this method
        regression-tests against under tools/mxstress.py)."""
        with self._done_lock:
            return (self.status, self.outputs, self.latency_ms, self.error)


class MicroBatcher:
    def __init__(self, model, max_queue=64, linger_ms=2.0):
        self._model = model
        self._stats = model.stats
        self._max_queue = int(max_queue)
        self._linger_s = float(linger_ms) / 1e3
        self._queue = deque()
        self._cond = threading.Condition()
        self._running = True
        self._paused = False
        self._thread = threading.Thread(
            target=self._run, name="mx-serve-%s" % model.name, daemon=True)
        self._thread.start()

    # -- client side ----------------------------------------------------
    def submit(self, request):
        """Admit or refuse.  Returns True when admitted, else the refusal
        reason: ``"full"`` (a shed was counted here) or ``"stopping"``
        (lifecycle — counted by the caller as its one UNAVAILABLE, never
        double-counted with shed)."""
        with self._cond:
            if not self._running:
                return "stopping"
            if len(self._queue) >= self._max_queue:
                self._stats.on_shed()
                return "full"
            self._queue.append(request)
            self._stats.on_admitted()
            self._stats.on_queue_depth(len(self._queue))
            self._cond.notify_all()
        return True

    def pause(self):
        """Stop dispatching (drain/maintenance); queue keeps admitting."""
        with self._cond:
            self._paused = True

    def resume(self):
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def stop(self):
        """Tear down; every queued request terminates with the retryable
        UNAVAILABLE status (shutdown is a lifecycle event, not a model
        error) — no waiter is ever left hanging on a dead queue."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._thread.join(timeout=5)
        from .server import UNAVAILABLE
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
        for r in leftovers:
            if r.complete(UNAVAILABLE, error="server shutting down"):
                self._stats.on_result(UNAVAILABLE, r.latency_ms)

    # -- worker side ----------------------------------------------------
    def _run(self):
        from .server import TIMEOUT
        while True:
            with self._cond:
                while self._running and (self._paused or not self._queue):
                    self._cond.wait(0.05)
                if not self._running:
                    return
                first = self._queue.popleft()
                self._stats.on_queue_depth(len(self._queue))
            if first.expired():
                if first.complete(TIMEOUT):
                    self._stats.on_result(TIMEOUT, first.latency_ms)
                continue

            self._linger(first)
            batch = self._gather(first)
            now = time.monotonic()
            live = []
            for r in batch:
                if r.expired(now):
                    if r.complete(TIMEOUT):
                        self._stats.on_result(TIMEOUT, r.latency_ms)
                else:
                    live.append(r)
            if live:
                self._execute(live)

    def _linger(self, first):
        """Wait for same-shape companions, bounded by linger window and
        the first request's deadline margin."""
        until = first.t_enqueue + self._linger_s
        if first.deadline is not None:
            until = min(until, first.deadline - _DEADLINE_MARGIN_S)
        max_more = self._model.ladder.max_batch - 1
        with self._cond:
            while self._running:
                now = time.monotonic()
                same = sum(1 for r in self._queue if r.key == first.key)
                if same >= max_more or now >= until:
                    return
                self._cond.wait(until - now)

    def _gather(self, first):
        """Pop up to max_batch same-shape requests; others keep their
        queue order for the next iteration."""
        batch = [first]
        with self._cond:
            skipped = []
            while self._queue and len(batch) < self._model.ladder.max_batch:
                r = self._queue.popleft()
                if r.key == first.key:
                    batch.append(r)
                else:
                    skipped.append(r)
            for r in reversed(skipped):
                self._queue.appendleft(r)
            self._stats.on_queue_depth(len(self._queue))
        return batch

    def _execute(self, batch):
        from .server import OK, ERROR
        import numpy as np
        n = len(batch)
        bucket = self._model.ladder.bucket(n)
        arrays = []
        for i in range(self._model.n_inputs):
            stacked = np.stack([r.inputs[i] for r in batch])
            if bucket > n:
                pad = np.zeros((bucket - n,) + stacked.shape[1:],
                               stacked.dtype)
                stacked = np.concatenate([stacked, pad])
            arrays.append(stacked)
        t0 = time.monotonic()
        breaker = getattr(self._model, "breaker", None)
        try:
            outs = self._model.execute(arrays)
        except Exception as exc:  # model bug: fail the batch, keep serving
            if breaker is not None:
                breaker.on_failure()
            for r in batch:
                if r.complete(ERROR, error=repr(exc)):
                    self._stats.on_result(ERROR, r.latency_ms)
            return
        if breaker is not None:
            # success closes a half-open breaker (the probe path) and
            # resets the failure streak
            breaker.on_success()
        batch_ms = (time.monotonic() - t0) * 1e3
        self._stats.on_batch(n, bucket, batch_ms)
        for i, r in enumerate(batch):
            # first-completion-wins: a client that already timed out locally
            # keeps its TIMEOUT status and must not be double-counted
            if r.complete(OK, [o[i] for o in outs]):
                self._stats.on_result(OK, r.latency_ms)
