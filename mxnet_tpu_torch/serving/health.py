"""Per-model health + circuit breaking: the self-healing serving path.

Counterpart of ``mxnet_tpu/serving/health.py``, unchanged in behaviour;
``CircuitBreaker.reset`` (used only by rolling deploys) waits for that
slice.

A model whose backend starts failing must degrade to *fast, retryable*
rejections instead of queue-then-throw on every request (docs/ROBUSTNESS.md
has the full state machine).  Classic three-state breaker:

``closed``  — traffic flows; consecutive execute failures are counted.
``open``    — after ``failure_threshold`` consecutive failures: admission
              rejects instantly with the retryable ``UNAVAILABLE`` status
              (no queueing, no batcher wakeup, no model call) until the
              backoff expires.  Backoff doubles on every re-open, capped.
``half_open`` — backoff expired: exactly one in-flight *probe* batch is
              admitted.  Success closes the breaker (and resets the
              backoff); failure re-opens it with the doubled backoff.  A
              probe that never reports (e.g. timed out in queue) releases
              its slot after ``probe_timeout_s`` so recovery cannot wedge.

Health is derived, not stored: ``closed`` with a clean streak is HEALTHY,
``closed`` mid-streak or ``half_open`` is DEGRADED, ``open`` is UNAVAILABLE.
The breaker records outcomes per *batch execution* (the unit that actually
fails), and every transition is counted for ``ModelServer.stats()``.
"""
from __future__ import annotations

import threading
import time

__all__ = ["HEALTHY", "DEGRADED", "UNAVAILABLE_HEALTH", "CircuitBreaker",
           "ADMIT", "PROBE", "REJECT", "HEALTH_RANK", "worst_health"]

# health states (UNAVAILABLE the request *status* lives in server.py;
# UNAVAILABLE_HEALTH is the same word as a *health* level)
HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
UNAVAILABLE_HEALTH = "UNAVAILABLE"

# severity order for aggregating health across replicas/engines
HEALTH_RANK = {HEALTHY: 0, DEGRADED: 1, UNAVAILABLE_HEALTH: 2}


def worst_health(levels):
    """The most severe level in ``levels`` (HEALTHY when empty)."""
    worst = HEALTHY
    for level in levels:
        if HEALTH_RANK.get(level, 2) > HEALTH_RANK[worst]:
            worst = level
    return worst

# admit() decisions
ADMIT = "admit"
PROBE = "probe"
REJECT = "reject"

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """K-consecutive-failure breaker with half-open probing and capped
    exponential backoff.  Thread-safe; every field is guarded by ``_lock``
    (admission runs on client threads, outcomes on the batcher worker)."""

    def __init__(self, failure_threshold=5, backoff_s=0.05, max_backoff_s=2.0,
                 probe_timeout_s=None, clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self._lock = threading.Lock()
        self._clock = clock
        self._threshold = int(failure_threshold)
        self._base_backoff = float(backoff_s)
        self._max_backoff = float(max_backoff_s)
        self._probe_timeout = (float(probe_timeout_s)
                               if probe_timeout_s is not None
                               else max(4 * self._base_backoff, 1.0))
        self._state = _CLOSED
        self._consecutive = 0
        self._backoff = self._base_backoff
        self._open_until = 0.0
        self._probe_expire = None   # monotonic deadline while a probe runs
        self._opens = 0             # lifetime open transitions
        self._rejections = 0        # fast-rejected admissions

    # -- admission (client threads) -------------------------------------
    def admit(self):
        """ADMIT (closed), PROBE (half-open slot granted), or REJECT."""
        with self._lock:
            if self._state == _CLOSED:
                return ADMIT
            now = self._clock()
            if self._state == _OPEN and now >= self._open_until:
                self._state = _HALF_OPEN
                self._probe_expire = None
            if self._state == _HALF_OPEN and (
                    self._probe_expire is None or now >= self._probe_expire):
                # grant the (single) probe slot; auto-expire so a probe
                # lost to a queue timeout cannot wedge recovery forever
                self._probe_expire = now + self._probe_timeout
                return PROBE
            self._rejections += 1
            return REJECT

    def release_probe(self):
        """Return an unused probe slot (the probe request never reached
        execution — invalid input, shed, shutdown).  Without this, a
        stream of non-executing requests could hold the slot for
        ``probe_timeout_s`` at a time and starve recovery."""
        with self._lock:
            if self._state == _HALF_OPEN:
                self._probe_expire = None

    # -- outcomes (batcher worker) --------------------------------------
    def on_success(self):
        with self._lock:
            self._consecutive = 0
            self._probe_expire = None
            if self._state != _CLOSED:
                self._state = _CLOSED
                self._backoff = self._base_backoff

    def on_failure(self):
        """One failed batch execution; returns True if this opened it."""
        with self._lock:
            self._consecutive += 1
            now = self._clock()
            if self._state == _HALF_OPEN:
                # failed probe: re-open with doubled (capped) backoff
                self._state = _OPEN
                self._opens += 1
                self._backoff = min(self._backoff * 2, self._max_backoff)
                self._open_until = now + self._backoff
                self._probe_expire = None
                return True
            if self._state == _CLOSED and \
                    self._consecutive >= self._threshold:
                self._state = _OPEN
                self._opens += 1
                self._open_until = now + self._backoff
                return True
            return False

    # -- observability ---------------------------------------------------
    def state(self):
        with self._lock:
            return self._state

    def health(self):
        """Derived health level (see module docstring)."""
        with self._lock:
            if self._state == _OPEN:
                return UNAVAILABLE_HEALTH
            if self._state == _HALF_OPEN or self._consecutive > 0:
                return DEGRADED
            return HEALTHY

    def snapshot(self):
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "failure_threshold": self._threshold,
                "backoff_s": self._backoff,
                "opens": self._opens,
                "rejections": self._rejections,
            }
