"""Open-loop traffic generation for serving benchmarks.

Every decode bench before this module was CLOSED-loop: N client threads
each submit, wait, submit again — so the arrival rate adapts to the
system under test, and a slow server conveniently slows its own load
down.  Production traffic does not wait: users arrive when they arrive.
Goodput-under-SLO (the number serving is actually measured by) only
means something under an **open loop**, where arrivals are a fixed
seeded schedule and a struggling system visibly blows its tail latency
instead of quietly throttling the benchmark.

Three arrival processes, all driven by one ``random.Random(seed)`` (same
seed => bit-identical trace, the reproducibility contract every bench
artifact and test leans on):

* :func:`poisson_trace` — homogeneous Poisson arrivals at ``rate_hz``
  (exponential inter-arrival gaps), the memoryless baseline.
* :func:`bursty_trace` — a square-wave modulated Poisson process:
  periodic burst windows run at ``burst_factor`` times the base rate
  (flash crowds, retry storms).
* :func:`diurnal_trace` — a sinusoidally modulated Poisson process
  (the day/night cycle compressed into ``period_s``), via Lewis-Shedler
  thinning against the peak rate.

:func:`tenant_mix` assigns each arrival a tenant by seeded weighted
draw, and :func:`replay` fires a trace against a submit callable in
real (or scaled) time WITHOUT waiting on completions — the open loop
itself.

Counterpart of ``mxnet_tpu/serving/traffic.py``, line for line: the same
seed gives the same trace, float for float, in both packages.
``chip_smoke.py``'s ``disagg`` and ``deploy`` phases fire their arrivals
through :func:`replay`.
"""
from __future__ import annotations

import math
import random
import time

__all__ = ["poisson_trace", "bursty_trace", "diurnal_trace", "tenant_mix",
           "replay"]


def _thinned(rate_fn, max_rate, duration_s, rng):
    """Lewis-Shedler thinning: draw candidate arrivals from a Poisson
    process at ``max_rate`` and keep each with probability
    ``rate_fn(t) / max_rate`` — an exact sampler for any intensity
    bounded by ``max_rate``, consuming the RNG in arrival order so the
    trace is a pure function of (intensity, seed)."""
    out = []
    t = 0.0
    while True:
        t += rng.expovariate(max_rate)
        if t >= duration_s:
            return out
        if rng.random() < rate_fn(t) / max_rate:
            out.append(t)


def poisson_trace(rate_hz, duration_s, seed=0):
    """Sorted arrival offsets (seconds in ``[0, duration_s)``) of a
    homogeneous Poisson process at ``rate_hz``."""
    if rate_hz <= 0:
        raise ValueError("rate_hz must be > 0, got %r" % (rate_hz,))
    if duration_s <= 0:
        raise ValueError("duration_s must be > 0, got %r" % (duration_s,))
    rng = random.Random(seed)
    out = []
    t = rng.expovariate(rate_hz)
    while t < duration_s:
        out.append(t)
        t += rng.expovariate(rate_hz)
    return out


def bursty_trace(rate_hz, duration_s, seed=0, burst_factor=4.0,
                 burst_fraction=0.25, n_bursts=4):
    """Square-wave bursty arrivals: ``n_bursts`` evenly spaced windows,
    each covering the first ``burst_fraction`` of its period, run at
    ``burst_factor * rate_hz``; the rest of the time runs at the base
    rate.  Models flash crowds / synchronized retry storms."""
    if rate_hz <= 0:
        raise ValueError("rate_hz must be > 0, got %r" % (rate_hz,))
    if duration_s <= 0:
        raise ValueError("duration_s must be > 0, got %r" % (duration_s,))
    if burst_factor < 1.0:
        raise ValueError("burst_factor must be >= 1, got %r"
                         % (burst_factor,))
    if not 0.0 < burst_fraction < 1.0:
        raise ValueError("burst_fraction must be in (0, 1), got %r"
                         % (burst_fraction,))
    if n_bursts < 1:
        raise ValueError("n_bursts must be >= 1, got %r" % (n_bursts,))
    period = duration_s / float(n_bursts)

    def rate(t):
        in_burst = (t % period) < burst_fraction * period
        return rate_hz * (burst_factor if in_burst else 1.0)

    return _thinned(rate, rate_hz * burst_factor, duration_s,
                    random.Random(seed))


def diurnal_trace(rate_hz, duration_s, seed=0, period_s=None, depth=0.8):
    """Sinusoidally modulated arrivals: intensity
    ``rate_hz * (1 + depth * sin(2*pi*t / period_s))`` — the day/night
    cycle compressed into ``period_s`` (default: the whole duration is
    one cycle).  ``depth`` in [0, 1) sets how deep the trough goes."""
    if rate_hz <= 0:
        raise ValueError("rate_hz must be > 0, got %r" % (rate_hz,))
    if duration_s <= 0:
        raise ValueError("duration_s must be > 0, got %r" % (duration_s,))
    if not 0.0 <= depth < 1.0:
        raise ValueError("depth must be in [0, 1), got %r" % (depth,))
    period = float(period_s) if period_s is not None else float(duration_s)
    if period <= 0:
        raise ValueError("period_s must be > 0, got %r" % (period_s,))

    def rate(t):
        return rate_hz * (1.0 + depth * math.sin(2.0 * math.pi * t / period))

    return _thinned(rate, rate_hz * (1.0 + depth), duration_s,
                    random.Random(seed))


def tenant_mix(arrivals, weights, seed=0):
    """Assign each arrival a tenant by seeded weighted draw; returns a
    list of tenant names aligned with ``arrivals``.  ``weights`` maps
    tenant name -> positive weight; the draw order consumes one uniform
    per arrival, so the assignment is a pure function of
    (len(arrivals), weights, seed)."""
    if not weights:
        raise ValueError("weights must name at least one tenant")
    names = sorted(weights)
    cum = []
    total = 0.0
    for name in names:
        w = float(weights[name])
        if w <= 0:
            raise ValueError("tenant %r weight must be > 0, got %r"
                             % (name, weights[name]))
        total += w
        cum.append(total)
    rng = random.Random(seed)
    out = []
    for _ in arrivals:
        u = rng.random() * total
        for name, edge in zip(names, cum):
            if u < edge:
                out.append(name)
                break
        else:
            out.append(names[-1])
    return out


def replay(arrivals, submit, time_scale=1.0, now=None, sleep=None):
    """Fire ``submit(i, t)`` at each scheduled offset — the open loop.

    Arrivals are honored on the wall clock (scaled by ``time_scale``;
    0.5 replays twice as fast) REGARDLESS of what earlier submissions
    are doing: nothing here waits on a stream, so a backed-up system
    keeps receiving load exactly like production.  When the clock has
    already passed an arrival's offset (the submit path itself was
    slow), the submission fires immediately — arrivals are never
    dropped.  Returns the number of submissions fired, which tests
    hold equal to ``len(arrivals)`` (arrival-count conservation).

    ``now``/``sleep`` inject clocks for tests; defaults are
    ``time.monotonic`` / ``time.sleep``."""
    if time_scale <= 0:
        raise ValueError("time_scale must be > 0, got %r" % (time_scale,))
    now = now if now is not None else time.monotonic
    sleep = sleep if sleep is not None else time.sleep
    t0 = now()
    fired = 0
    for i, t in enumerate(arrivals):
        due = t0 + float(t) * time_scale
        while True:
            delta = due - now()
            if delta <= 0:
                break
            sleep(min(delta, 0.05))
        submit(i, float(t))
        fired += 1
    return fired
