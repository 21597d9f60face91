"""Serving observability: per-model counters + latency percentiles.

Counterpart of ``mxnet_tpu/serving/stats.py`` (``LatencyWindow`` and
``ModelStats``).  Every event updates plain numeric fields read by
``ModelServer.stats()`` under a lock.  The JAX package also mirrors them
into profiler counters; that waits for the port of the profiler, and the
decode-stream helpers wait for the decode slice.
"""
from __future__ import annotations

import threading

__all__ = ["ModelStats", "LatencyWindow"]


class LatencyWindow:
    """Ring buffer of the last ``capacity`` latencies, for percentiles."""

    def __init__(self, capacity=2048):
        self._cap = int(capacity)
        self._buf = []
        self._next = 0

    def add(self, ms):
        if len(self._buf) < self._cap:
            self._buf.append(ms)
        else:
            self._buf[self._next] = ms
            self._next = (self._next + 1) % self._cap

    def percentiles(self, ps=(50, 95, 99)):
        """{"p50": ms, ...} over the window (zeros when empty)."""
        if not self._buf:
            return {"p%d" % p: 0.0 for p in ps}
        ordered = sorted(self._buf)
        out = {}
        for p in ps:
            idx = min(len(ordered) - 1, int(round(p / 100.0 * (len(ordered) - 1))))
            out["p%d" % p] = ordered[idx]
        return out


class ModelStats:
    """All counters for one loaded model.  Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0        # admitted submissions
        self.ok = 0
        self.timeouts = 0
        self.shed = 0            # rejected: queue full
        self.invalid = 0         # rejected: shape not in the bucket menu
        self.errors = 0
        # UNAVAILABLE is split like shed/invalid vs the terminal counters:
        # `unavailable` counts ADMITTED requests drained at teardown (they
        # are part of `requests`, so conservation reads requests == ok +
        # timeouts + errors + unavailable); `unavailable_rejected` counts
        # fast admission rejections (breaker open / shutting down), which
        # — like shed — never enter `requests`
        self.unavailable = 0
        self.unavailable_rejected = 0
        self.retries = 0         # transient execute failures absorbed
        self.batches = 0
        self.batched_requests = 0   # real rows executed
        self.padded_rows = 0        # ladder pad rows executed
        self.queue_depth = 0
        self._req_lat = LatencyWindow()
        self._batch_lat = LatencyWindow()

    # -- event hooks ----------------------------------------------------
    def on_queue_depth(self, depth):
        with self._lock:
            self.queue_depth = depth

    def on_admitted(self):
        with self._lock:
            self.requests += 1

    def on_shed(self):
        with self._lock:
            self.shed += 1

    def on_invalid(self):
        with self._lock:
            self.invalid += 1

    def on_unavailable(self, rejected=False):
        """An UNAVAILABLE outcome.  ``rejected=True`` for fast admission
        rejections (breaker open / shutting down — the request never
        entered the queue); False for an admitted request terminated by
        teardown."""
        with self._lock:
            if rejected:
                self.unavailable_rejected += 1
            else:
                self.unavailable += 1

    def on_retry(self):
        """One transient execute failure absorbed by the retry envelope."""
        with self._lock:
            self.retries += 1

    def on_batch(self, n_real, bucket, latency_ms):
        with self._lock:
            self.batches += 1
            self.batched_requests += n_real
            self.padded_rows += bucket - n_real
            self._batch_lat.add(latency_ms)

    def on_result(self, status, latency_ms=None):
        from .server import OK, TIMEOUT, ERROR, UNAVAILABLE
        if status == UNAVAILABLE:
            self.on_unavailable()
            with self._lock:
                if latency_ms is not None:
                    self._req_lat.add(latency_ms)
            return
        with self._lock:
            if status == OK:
                self.ok += 1
            elif status == TIMEOUT:
                self.timeouts += 1
            elif status == ERROR:
                self.errors += 1
            if latency_ms is not None:
                self._req_lat.add(latency_ms)

    # -- snapshot -------------------------------------------------------
    def snapshot(self):
        with self._lock:
            rows = self.batched_requests + self.padded_rows
            return {
                "requests": self.requests,
                "ok": self.ok,
                "timeouts": self.timeouts,
                "shed": self.shed,
                "invalid": self.invalid,
                "errors": self.errors,
                "unavailable": self.unavailable,
                "unavailable_rejected": self.unavailable_rejected,
                "retries": self.retries,
                "batches": self.batches,
                "batched_requests": self.batched_requests,
                "avg_batch": (self.batched_requests / self.batches
                              if self.batches else 0.0),
                "pad_waste": (self.padded_rows / rows if rows else 0.0),
                "queue_depth": self.queue_depth,
                "latency_ms": self._req_lat.percentiles(),
                "batch_latency_ms": self._batch_lat.percentiles(),
            }
