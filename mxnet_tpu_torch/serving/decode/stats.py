"""Decode-engine observability: per-engine counters + latency windows
(counterpart of ``mxnet_tpu/serving/decode/stats.py``).

Same two-sink design as the JAX package's ``serving/stats.py``: always-on
numeric fields behind one lock for ``DecodeEngine.stats_snapshot()``, plus
profiler Counters on the ``serving`` Domain — gated on
``profiler.profiling_active()`` — so a trace shows the decode loop's
occupancy next to op spans:

* ``<engine>:live_seqs``      — sequences in decode slots after each step
* ``<engine>:kv_blocks_used`` — allocated KV pool blocks after each step
* ``<engine>:kv_blocks_free`` — absolute pool headroom (the routing signal)
* ``<engine>:ttft_ms``        — time-to-first-token of each prefill
* ``<engine>:tokens_per_s``   — instantaneous decode throughput per step
* ``<engine>:prefix_blocks_shared`` — KV blocks attached via prefix hits
* ``<engine>:spec_accept_rate``     — draft tokens accepted / proposed

Conservation contract (the chaos scenario's invariant): ``requests`` counts
ADMITTED streams and every one of them reaches exactly one terminal
counter, so ``requests == ok + timeouts + errors + unavailable``; ``shed``,
``invalid`` and ``unavailable_rejected`` count fast rejections that never
enter ``requests`` (the same split as ``ModelStats``).
"""
from __future__ import annotations

import threading

from ... import profiler
from ..stats import LatencyWindow

__all__ = ["DecodeStats"]


class DecodeStats:
    """All counters for one decode engine.  Thread-safe."""

    def __init__(self, engine_name, kv_capacity=0, tp_degree=1):
        self._lock = threading.Lock()
        self.requests = 0            # admitted streams
        self.ok = 0
        self.timeouts = 0
        self.errors = 0
        self.unavailable = 0         # admitted, terminated by teardown
        self.shed = 0                # rejected: queue/KV pool full
        self.invalid = 0             # rejected: prompt outside the menu
        self.unavailable_rejected = 0  # rejected: breaker open / closed
        self.retries = 0             # transient execute failures absorbed
        self.prefills = 0
        self.steps = 0               # decode iterations executed
        self.tokens_out = 0          # tokens emitted across all streams
        self.step_slot_sum = 0       # live slots summed over steps
        self.live_seqs = 0
        self.kv_capacity = int(kv_capacity)  # allocatable pool blocks
        self.tp_degree = int(tp_degree)      # mesh devices this engine spans
        self.kv_blocks_used = 0
        self.kv_blocks_free = int(kv_capacity)
        self.tokens_per_s = 0.0      # instantaneous, from the last step
        self.handed_off = 0          # admitted, exported to another engine
        self.imported = 0            # admitted via import_stream
        self.prefix_hits = 0         # admissions that attached shared pages
        self.prefix_blocks_shared = 0  # blocks attached by those hits
        self.cow_forks = 0           # shared pages privatized on write
        self.spec_rounds = 0         # speculative verify dispatches scored
        self.spec_proposed = 0       # draft tokens offered for verification
        self.spec_accepted = 0       # draft tokens the target agreed with
        self._ttft = LatencyWindow()
        self._step_ms = LatencyWindow()
        domain = profiler.Domain("serving")
        self._c_live = domain.new_counter("%s:live_seqs" % engine_name)
        self._c_blocks = domain.new_counter("%s:kv_blocks_used" % engine_name)
        self._c_free = domain.new_counter("%s:kv_blocks_free" % engine_name)
        self._c_ttft = domain.new_counter("%s:ttft_ms" % engine_name)
        self._c_tps = domain.new_counter("%s:tokens_per_s" % engine_name)
        self._c_shared = domain.new_counter(
            "%s:prefix_blocks_shared" % engine_name)
        self._c_accept = domain.new_counter(
            "%s:spec_accept_rate" % engine_name)
        # static for the engine's life: set once so every profiler dump
        # carries the device footprint next to the per-step gauges
        self._c_tp = domain.new_counter("%s:tp_degree" % engine_name)
        self._c_tp.set_value(self.tp_degree)

    # -- event hooks ----------------------------------------------------
    def on_admitted(self):
        with self._lock:
            self.requests += 1

    def on_shed(self):
        with self._lock:
            self.shed += 1

    def on_invalid(self):
        with self._lock:
            self.invalid += 1

    def on_unavailable_rejected(self):
        with self._lock:
            self.unavailable_rejected += 1

    def on_retry(self):
        with self._lock:
            self.retries += 1

    def on_prefill(self, ttft_ms):
        with self._lock:
            self.prefills += 1
            self._ttft.add(ttft_ms)
        if profiler.profiling_active():
            self._c_ttft.set_value(ttft_ms)

    def on_step(self, live, tokens_emitted, step_ms, kv_blocks_used):
        with self._lock:
            self.steps += 1
            self.step_slot_sum += live
            self.tokens_out += tokens_emitted
            self.live_seqs = live
            self.kv_blocks_used = kv_blocks_used
            self.kv_blocks_free = max(0, self.kv_capacity - kv_blocks_used)
            free = self.kv_blocks_free
            if step_ms > 0:
                self.tokens_per_s = tokens_emitted / (step_ms / 1e3)
            self._step_ms.add(step_ms)
        if profiler.profiling_active():
            self._c_live.set_value(live)
            self._c_blocks.set_value(kv_blocks_used)
            self._c_free.set_value(free)
            if step_ms > 0:
                self._c_tps.set_value(tokens_emitted / (step_ms / 1e3))

    def on_tokens(self, n):
        """Tokens emitted outside a decode step (the prefill's first)."""
        with self._lock:
            self.tokens_out += n

    def on_idle(self, live, kv_blocks_used):
        """Occupancy update without a step (join/finish bookkeeping)."""
        with self._lock:
            self.live_seqs = live
            self.kv_blocks_used = kv_blocks_used
            self.kv_blocks_free = max(0, self.kv_capacity - kv_blocks_used)
            free = self.kv_blocks_free
        if profiler.profiling_active():
            self._c_live.set_value(live)
            self._c_blocks.set_value(kv_blocks_used)
            self._c_free.set_value(free)

    def on_prefix(self, blocks_shared):
        """A fresh admission resolved its prompt against the prefix
        registry: ``blocks_shared`` pages attached without prefill work
        (0 means the lookup missed — only hits count)."""
        if blocks_shared <= 0:
            return
        with self._lock:
            self.prefix_hits += 1
            self.prefix_blocks_shared += blocks_shared
            shared = self.prefix_blocks_shared
        if profiler.profiling_active():
            self._c_shared.set_value(shared)

    def on_cow_fork(self):
        """A shared page was privatized on first divergent write."""
        with self._lock:
            self.cow_forks += 1

    def on_spec(self, proposed, accepted):
        """One speculative round settled for one greedy slot: ``proposed``
        draft tokens were verified, ``accepted`` agreed with the target."""
        with self._lock:
            self.spec_rounds += 1
            self.spec_proposed += proposed
            self.spec_accepted += accepted
            rate = (self.spec_accepted / self.spec_proposed
                    if self.spec_proposed else 0.0)
        if profiler.profiling_active():
            self._c_accept.set_value(rate)

    def on_handed_off(self):
        """An admitted stream left this engine via ``export_stream`` — it
        terminates elsewhere, so it leaves this engine's conservation set
        through ``handed_off`` instead of a terminal counter."""
        with self._lock:
            self.handed_off += 1

    def on_imported(self):
        """A stream entered via ``import_stream`` — joins the conservation
        set on the ``imported`` side: ``requests + imported ==
        ok + timeouts + errors + unavailable + handed_off``."""
        with self._lock:
            self.imported += 1

    def on_result(self, status):
        from ..server import OK, TIMEOUT, ERROR, UNAVAILABLE
        with self._lock:
            if status == OK:
                self.ok += 1
            elif status == TIMEOUT:
                self.timeouts += 1
            elif status == ERROR:
                self.errors += 1
            elif status == UNAVAILABLE:
                self.unavailable += 1

    # -- snapshot -------------------------------------------------------
    def snapshot(self):
        with self._lock:
            return {
                "requests": self.requests,
                "ok": self.ok,
                "timeouts": self.timeouts,
                "errors": self.errors,
                "unavailable": self.unavailable,
                "shed": self.shed,
                "invalid": self.invalid,
                "unavailable_rejected": self.unavailable_rejected,
                "retries": self.retries,
                "prefills": self.prefills,
                "steps": self.steps,
                "tokens_out": self.tokens_out,
                "avg_live_slots": (self.step_slot_sum / self.steps
                                   if self.steps else 0.0),
                "live_seqs": self.live_seqs,
                "kv_capacity": self.kv_capacity,
                "tp_degree": self.tp_degree,
                "kv_blocks_used": self.kv_blocks_used,
                "kv_blocks_free": self.kv_blocks_free,
                "tokens_per_s": self.tokens_per_s,
                "handed_off": self.handed_off,
                "imported": self.imported,
                "prefix_hits": self.prefix_hits,
                "prefix_blocks_shared": self.prefix_blocks_shared,
                "cow_forks": self.cow_forks,
                "spec_rounds": self.spec_rounds,
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "spec_accept_rate": (self.spec_accepted / self.spec_proposed
                                     if self.spec_proposed else 0.0),
                "ttft_ms": self._ttft.percentiles(ps=(50, 95, 99)),
                "step_ms": self._step_ms.percentiles(ps=(50, 95, 99)),
            }
