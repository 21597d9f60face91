"""Disaggregated prefill/decode topology: two fleets, one stream.

Prefill is compute-bound (one big batched matmul over the prompt) and
decode is memory-bandwidth-bound (one token per step, the whole KV
resident); co-locating them makes each steal the other's latency
budget — a long prefill stalls every decode step behind it, and decode
occupancy starves prefill of compute.  :class:`DisaggRouter` splits the
roles across two independent :class:`~mxnet_tpu_torch.serving.fleet.FleetRouter`
tiers:

* the **prefill tier** runs chunked-prefill-only engines
  (``DecodeEngine(prefill_only=True)``): each stream is admitted here,
  prefills in chunks, emits its first token (TTFT), and is immediately
  handed off;
* the **decode tier** owns the stream from token two to its terminal:
  the handoff carries the prompt's K/V pages, the sampler state (seed +
  draws burned), and the cursor — the exact ``export_stream`` snapshot
  shape — and lands via ``FleetRouter.adopt_stream``, which re-owns the
  stream to the target replica's ``(rid, generation)`` fencing token
  BEFORE importing, so the prefill incarnation can never emit past the
  handoff point.

Conservation across the boundary stays on ONE ledger: the prefill
router admits every stream and holds the single ``on_terminal`` hook,
so its ``decode_stats`` settles ``requests == ok + timeouts + errors +
unavailable`` for the whole pipeline regardless of which tier produced
the terminal.  ``mark_departed`` detaches the stream's replica pin the
moment it leaves the prefill tier (a later prefill-replica death must
not fence a stream that now lives elsewhere), and a failed adoption —
decode tier full, draining, or gone — terminates the stream UNAVAILABLE
with its one-token prefix intact for re-admission.

Handoff-at-first-token state machine (docs/SERVING.md "Disaggregated
prefill/decode" has the full walk-through)::

    prefill worker            DisaggRouter              decode tier
    --------------            ------------              -----------
    final chunk done
    emit token 1 (TTFT)
    snapshot K/V+sampler
    free local blocks
    sink(stream, snap) ──────> mark_departed(stream)
                               adopt_stream ──────────> check_generation
                                                        set_owner((rid2,g2))
                                                        import_stream
                               record handoff_ms
    handed_off += 1   <─────── True
                                                        decode to terminal
                                                        (one complete(),
                                                         prefill router's
                                                         terminal hook
                                                         settles counters)

Counterpart of ``mxnet_tpu/serving/disagg/router.py``.  On one card the
two tiers' engines share the device; the handoff moves the K/V pages
through host memory (``export_stream``/``import_stream``), as in the JAX
package.

Locking: the router itself holds no lock — every mutable piece lives in
the two tier routers (each with its own ``_lock`` discipline) or in
:class:`DisaggStats` (one ``threading.Lock``).  The handoff sink runs on
a prefill engine worker thread and calls only lock-safe tier-router
entry points, never an engine on the prefill tier.
"""
from __future__ import annotations

import threading
import time

from ... import profiler
from ...base import MXNetError
from ..fleet import FleetRouter
from ..stats import LatencyWindow

__all__ = ["DisaggRouter", "DisaggStats"]


class DisaggStats:
    """Cross-tier handoff counters + latency window.  Thread-safe.

    ``handoffs`` counts streams that found a decode home; ``failures``
    counts streams the decode tier could not adopt (they terminate
    UNAVAILABLE, prefix intact).  ``handoff_ms`` measures the sink's
    wall time — detach, adopt, import — which is dead air between the
    first token and the second, so it sits directly on TPOT.  The same
    number lands on the profiler timeline as the ``prefill:handoff_ms``
    Counter (gated on ``profiling_active()``, like every serving
    counter)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.handoffs = 0
        self.failures = 0
        self._handoff_ms = LatencyWindow()
        domain = profiler.Domain("serving")
        self._c_handoff_ms = domain.new_counter("prefill:handoff_ms")

    def on_handoff(self, ms, ok):
        with self._lock:
            if ok:
                self.handoffs += 1
            else:
                self.failures += 1
            self._handoff_ms.add(ms)
        if profiler.profiling_active():
            self._c_handoff_ms.set_value(ms)

    def snapshot(self):
        with self._lock:
            return {
                "handoffs": self.handoffs,
                "handoff_failures": self.failures,
                "handoff_ms": self._handoff_ms.percentiles(),
            }


class DisaggRouter:
    """Two-tier disaggregated serving: prefill fleet + decode fleet.

    Both tiers are full :class:`FleetRouter` instances — per-tier
    KV/queue-aware routing, breakers, drains, kills, and
    ``scaling_advice()`` all work unchanged within each tier; this class
    only adds the admission path (prefill tier) and the first-token
    handoff wiring between them.  ``serving/disagg/autoscaler.py``
    drives each tier's replica count against SLO + headroom signals.
    """

    def __init__(self, prefill_replicas=1, decode_replicas=1,
                 replica_factory=None, failover_budget=2,
                 breaker_threshold=3, breaker_backoff_ms=50.0):
        kw = dict(replica_factory=replica_factory,
                  failover_budget=failover_budget,
                  breaker_threshold=breaker_threshold,
                  breaker_backoff_ms=breaker_backoff_ms)
        self.prefill = FleetRouter(replicas=prefill_replicas, **kw)
        self.decode = FleetRouter(replicas=decode_replicas, **kw)
        self.stats_sink = DisaggStats()

    # -- model lifecycle --------------------------------------------------
    def load(self, name, prefill_factory, decode_factory,
             prefill_replicas=1, decode_replicas=1, tp=None):
        """Load one model onto both tiers.  ``prefill_factory`` must
        build engines with ``prefill_only=True`` (enforced — a full
        engine on the prefill tier would decode there and never hand
        off); ``decode_factory`` builds the engines that own streams to
        completion.  The decode tier loads FIRST so the earliest prefill
        completion already has a warm home."""
        def _wrap(n):
            eng = prefill_factory(n)
            if not getattr(eng, "prefill_only", False):
                eng.stop()
                raise MXNetError(
                    "prefill tier engine for %r must be built with "
                    "prefill_only=True" % (name,))
            eng.set_handoff(
                lambda stream, snap, _n=n: self._on_first_token(
                    _n, stream, snap))
            return eng

        self.decode.load_decode(name, decode_factory,
                                replicas=decode_replicas, tp=tp)
        try:
            self.prefill.load_decode(name, _wrap,
                                     replicas=prefill_replicas, tp=tp)
        except Exception:
            self.decode.unload_decode(name)
            raise

    def unload(self, name):
        self.prefill.unload_decode(name)
        self.decode.unload_decode(name)

    # -- admission --------------------------------------------------------
    def submit_stream(self, name, prompt, **kwargs):
        """Admit one stream at the prefill tier.  All QoS (tenant
        weights/budgets), shedding, and conservation accounting live on
        the prefill router — it holds the stream's single terminal hook,
        so ``self.prefill.decode_stats`` is the end-to-end ledger."""
        return self.prefill.submit_stream(name, prompt, **kwargs)

    def set_tenant(self, name, weight=1.0, token_budget=None):
        self.prefill.set_tenant(name, weight=weight,
                                token_budget=token_budget)

    def tenant_snapshot(self):
        return self.prefill.tenant_snapshot()

    # -- the handoff ------------------------------------------------------
    def _on_first_token(self, name, stream, snap):
        """The prefill engines' handoff sink: detach the stream from its
        prefill pin, then land it on the decode tier.  Runs on a prefill
        worker thread; returns truthy iff the stream found a decode home
        (the engine counts ``handed_off`` on truth, terminates
        UNAVAILABLE otherwise)."""
        t0 = time.monotonic()
        self.prefill.mark_departed(stream)
        try:
            ok = bool(self.decode.adopt_stream(name, stream, snap))
        except MXNetError:
            # decode tier lost the model (unload/stop race): the engine
            # terminates the stream UNAVAILABLE, prefix intact
            ok = False
        self.stats_sink.on_handoff((time.monotonic() - t0) * 1e3, ok)
        return ok

    # -- observability ----------------------------------------------------
    def stats(self):
        return {
            "prefill": self.prefill.stats(),
            "decode": self.decode.stats(),
            "disagg": self.stats_sink.snapshot(),
        }

    def scaling_advice(self):
        """Per-tier advice: each tier's own ``FleetRouter`` advice (with
        its per-engine-name breakdown) under its tier key — prefill
        reasons and decode reasons never blur, and each carries its own
        device footprint."""
        return {
            "prefill": self.prefill.scaling_advice(),
            "decode": self.decode.scaling_advice(),
        }

    def health(self, name=None):
        return {
            "prefill": self.prefill.health(name),
            "decode": self.decode.health(name),
        }

    def wait_converged(self, timeout_s=10.0):
        deadline = time.monotonic() + timeout_s
        self.prefill.wait_converged(
            timeout_s=max(0.0, deadline - time.monotonic()))
        self.decode.wait_converged(
            timeout_s=max(0.0, deadline - time.monotonic()))

    # -- lifecycle --------------------------------------------------------
    def stop(self):
        """Stop the prefill tier first — no new handoffs can originate —
        then the decode tier (in-flight adopted streams terminate
        UNAVAILABLE through each engine's drain, settling on the prefill
        router's ledger before it is read)."""
        self.prefill.stop()
        self.decode.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
