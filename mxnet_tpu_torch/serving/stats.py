"""Serving observability: per-model counters + latency percentiles.

Counterpart of ``mxnet_tpu/serving/stats.py`` (``LatencyWindow`` and
``ModelStats``, and the decode-stream helpers ``stream_tpot_ms`` and
``goodput_under_slo``).  Two sinks, one writer: every event updates plain
numeric fields read by ``ModelServer.stats()`` under a lock, and a
``serving`` profiler Domain's Counters (``<model>:queue_depth``,
``:batch_ms``, ``:shed``, ``:breaker_state``, ``:unavailable``), so that a
``profiler.dump()`` trace shows the server on the same timeline as the op
spans.  Counter writes are gated on ``profiler.profiling_active()``: each
``Counter.set_value`` appends a trace event, and an ungated per-request
write would grow the event buffer without bound in a long-lived server.
"""
from __future__ import annotations

import threading

from .. import profiler

__all__ = ["ModelStats", "LatencyWindow", "stream_tpot_ms",
           "goodput_under_slo"]


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


def stream_tpot_ms(latency_ms, ttft_ms, tokens):
    """Time-per-output-token of one finished stream: the decode-phase
    latency (total minus time-to-first-token) spread over the tokens
    after the first.  None when the stream has fewer than two tokens or
    is missing either timestamp — a one-token stream has no decode phase
    to measure."""
    if tokens is None or int(tokens) < 2:
        return None
    if latency_ms is None or ttft_ms is None:
        return None
    return max(0.0, float(latency_ms) - float(ttft_ms)) / (int(tokens) - 1)


def goodput_under_slo(rows, slo_ttft_ms=None, slo_tpot_ms=None):
    """Goodput accounting over finished streams: how many completed OK
    *and* met every configured latency SLO.

    ``rows`` is an iterable of per-stream dicts with keys ``status``
    (the server.py vocabulary), ``ttft_ms``, ``latency_ms`` and
    ``tokens`` (count).  A ``None`` SLO is unchecked.  Returns::

        {"total": all rows, "ok": OK rows, "good": OK rows within SLO,
         "ttft_violations": OK rows past slo_ttft_ms,
         "tpot_violations": OK rows past slo_tpot_ms,
         "ttft_ms": {"p50": ..., "p99": ...},   # over OK rows
         "tpot_ms": {"p50": ..., "p99": ...}}   # over OK rows with >= 2 tokens

    The rate (goodput per second) is the caller's division: only the
    bench knows the open-loop window the rows arrived in."""
    total = ok = good = ttft_bad = tpot_bad = 0
    ttft_w, tpot_w = LatencyWindow(), LatencyWindow()
    for row in rows:
        total += 1
        if row.get("status") != "OK":
            continue
        ok += 1
        ttft = row.get("ttft_ms")
        tpot = stream_tpot_ms(row.get("latency_ms"), ttft,
                              row.get("tokens"))
        if ttft is not None:
            ttft_w.add(float(ttft))
        if tpot is not None:
            tpot_w.add(tpot)
        meets = True
        if slo_ttft_ms is not None and (ttft is None
                                        or ttft > slo_ttft_ms):
            ttft_bad += 1
            meets = False
        if slo_tpot_ms is not None and tpot is not None \
                and tpot > slo_tpot_ms:
            tpot_bad += 1
            meets = False
        if meets:
            good += 1
    return {
        "total": total,
        "ok": ok,
        "good": good,
        "ttft_violations": ttft_bad,
        "tpot_violations": tpot_bad,
        "ttft_ms": ttft_w.percentiles(ps=(50, 99)),
        "tpot_ms": tpot_w.percentiles(ps=(50, 99)),
    }


class ModelStats:
    """All counters for one loaded model.  Thread-safe."""

    def __init__(self, model_name):
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
        domain = profiler.Domain("serving")
        self._c_queue = domain.new_counter("%s:queue_depth" % model_name)
        self._c_batch_ms = domain.new_counter("%s:batch_ms" % model_name)
        self._c_shed = domain.new_counter("%s:shed" % model_name)
        # breaker state on the same timeline: 0 closed, 1 half-open, 2 open
        self._c_breaker = domain.new_counter("%s:breaker_state" % model_name)
        self._c_unavail = domain.new_counter("%s:unavailable" % model_name)

    # -- event hooks ----------------------------------------------------
    def on_queue_depth(self, depth):
        with self._lock:
            self.queue_depth = depth
        if profiler.profiling_active():
            self._c_queue.set_value(depth)

    def on_admitted(self):
        with self._lock:
            self.requests += 1

    def on_shed(self):
        with self._lock:
            self.shed += 1
            count = self.shed
        if profiler.profiling_active():
            self._c_shed.set_value(count)

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
            count = self.unavailable + self.unavailable_rejected
        if profiler.profiling_active():
            self._c_unavail.set_value(count)

    def on_retry(self):
        """One transient execute failure absorbed by the retry envelope."""
        with self._lock:
            self.retries += 1

    def on_breaker_state(self, state):
        """Put a breaker transition on the profiler timeline (the open and
        rejection counts themselves live in the breaker's snapshot)."""
        if profiler.profiling_active():
            self._c_breaker.set_value(
                {"closed": 0, "half_open": 1, "open": 2}.get(state, 0))

    def on_batch(self, n_real, bucket, latency_ms):
        with self._lock:
            self.batches += 1
            self.batched_requests += n_real
            self.padded_rows += bucket - n_real
            self._batch_lat.add(latency_ms)
        if profiler.profiling_active():
            self._c_batch_ms.set_value(latency_ms)

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
