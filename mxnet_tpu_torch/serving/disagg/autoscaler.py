"""SLO-driven per-tier autoscaling for the disaggregated topology.

``FleetRouter.scaling_advice()`` has always *described* what a policy
should do; this module closes the loop and does it.  An
:class:`Autoscaler` polls both tiers of a :class:`~.router.DisaggRouter`
and, per tier, compares live signals against a :class:`TierPolicy`:

* **SLO tail latency** — p99 TTFT (prefill's product) and p99 TPOT
  (decode's product), both read from the prefill router's end-to-end
  ``decode_stats`` ledger (the single terminal hook means only that
  ledger sees finished streams);
* **headroom** — the tier's own ``scaling_advice()`` KV utilization and
  queue fill.

A breach of either scales the tier OUT: ``add_replica()`` joins a bare
replica, then ``scale_decode()`` raises the engine target so the
rebalancer builds AND warms the new engine before its placement commits
(warm-before-cutover — a joining replica never serves cold).  A
sustained-idle tier (no SLO breach, KV and queue under the low-water
marks) scales IN: the target drops first (so the rebalancer cannot
re-place onto survivors), then the victim is drained — every in-flight
stream hands off to a survivor via the fenced export/import protocol —
and retired with ``remove_replica()``.  One action per tier per poll,
bounded by ``min_replicas``/``max_replicas`` and a per-tier cooldown so
a burst cannot thrash the fleet.

Every poll lands the decision on the profiler timeline (gated on
``profiling_active()``, like all serving counters): ``<tier>:replicas``,
``<tier>:slo_p99_ttft_ms``, ``<tier>:slo_p99_tpot_ms`` — a trace dump
shows replica counts stepping against the tail latencies that drove
them.

Counterpart of ``mxnet_tpu/serving/disagg/autoscaler.py``, unchanged in
behaviour; tests/test_torch_disagg.py drives both directions.
"""
from __future__ import annotations

import threading
import time

from ... import profiler

__all__ = ["Autoscaler", "TierPolicy"]


class TierPolicy:
    """Scaling targets for one tier.

    ``slo_p99_ttft_ms`` / ``slo_p99_tpot_ms``: tail-latency ceilings
    (None = unchecked; prefill typically sets TTFT, decode sets TPOT).
    ``kv_high``/``queue_high``: headroom breach thresholds (scale out);
    ``kv_low``/``queue_low``: idle thresholds (scale in, only when no
    SLO is breached).  ``cooldown_s`` spaces actions on the same tier.
    """

    def __init__(self, min_replicas=1, max_replicas=8,
                 slo_p99_ttft_ms=None, slo_p99_tpot_ms=None,
                 kv_high=0.85, kv_low=0.15,
                 queue_high=0.85, queue_low=0.15, cooldown_s=0.0):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if not 0.0 <= kv_low < kv_high <= 1.0:
            raise ValueError("need 0 <= kv_low < kv_high <= 1")
        if not 0.0 <= queue_low < queue_high <= 1.0:
            raise ValueError("need 0 <= queue_low < queue_high <= 1")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.slo_p99_ttft_ms = slo_p99_ttft_ms
        self.slo_p99_tpot_ms = slo_p99_tpot_ms
        self.kv_high = float(kv_high)
        self.kv_low = float(kv_low)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.cooldown_s = float(cooldown_s)


class Autoscaler:
    """Drive both tiers of a :class:`~.router.DisaggRouter` toward
    their :class:`TierPolicy` targets.  Call :meth:`poll` on whatever
    cadence the deployment likes (tests call it directly); each call
    evaluates both tiers and performs at most one scaling action per
    tier.  Not re-entrant: serialize polls (one ``_lock`` enforces
    it)."""

    TIERS = ("prefill", "decode")

    def __init__(self, disagg, prefill=None, decode=None):
        self.disagg = disagg
        self.policies = {"prefill": prefill or TierPolicy(),
                         "decode": decode or TierPolicy()}
        self._lock = threading.Lock()
        self._last_action = {t: None for t in self.TIERS}
        self.decisions = []   # every non-hold action, in order
        domain = profiler.Domain("serving")
        self._counters = {
            t: {"replicas": domain.new_counter("%s:replicas" % t),
                "ttft": domain.new_counter("%s:slo_p99_ttft_ms" % t),
                "tpot": domain.new_counter("%s:slo_p99_tpot_ms" % t)}
            for t in self.TIERS}

    # -- signal plumbing --------------------------------------------------
    def _live(self, router):
        return sorted(rid for rid, st in router.replicas().items()
                      if st == "LIVE")

    def _victim(self, router):
        """Scale-in victim: the highest-numbered LIVE replica hosting a
        decode engine (deterministic, and the last to have joined under
        the rid scheme — survivors keep the longest-warmed copies)."""
        placed = set()
        for name in router.decode_models():
            placed.update(router.stats()["decode_models"][name]["placement"])
        live = [rid for rid in self._live(router) if rid in placed]
        if not live:
            return None
        return max(live, key=lambda rid: int(rid.lstrip("r")))

    # -- the loop body ----------------------------------------------------
    def poll(self):
        """Evaluate both tiers; returns ``{tier: decision}`` where each
        decision carries the action taken (``scale_out``/``scale_in``/
        ``hold``), the replica count after it, the signals read, and the
        reasons."""
        with self._lock:
            slo = self.disagg.prefill.decode_stats.snapshot()
            p99_ttft = slo["ttft_ms"]["p99"]
            p99_tpot = slo["tpot_ms"]["p99"]
            out = {}
            for tier in self.TIERS:
                out[tier] = self._poll_tier(tier, p99_ttft, p99_tpot)
            return out

    def _poll_tier(self, tier, p99_ttft, p99_tpot):
        router = getattr(self.disagg, tier)
        pol = self.policies[tier]
        advice = router.scaling_advice()
        kv = advice["kv_utilization"]
        queue = advice["queue_fill"]
        live = self._live(router)
        n = len(live)
        reasons = []
        if pol.slo_p99_ttft_ms is not None and p99_ttft > pol.slo_p99_ttft_ms:
            reasons.append("p99 TTFT %.1fms > SLO %.1fms"
                           % (p99_ttft, pol.slo_p99_ttft_ms))
        if pol.slo_p99_tpot_ms is not None and p99_tpot > pol.slo_p99_tpot_ms:
            reasons.append("p99 TPOT %.1fms > SLO %.1fms"
                           % (p99_tpot, pol.slo_p99_tpot_ms))
        if kv >= pol.kv_high:
            reasons.append("kv utilization %.2f >= %.2f" % (kv, pol.kv_high))
        if queue >= pol.queue_high:
            reasons.append("queue fill %.2f >= %.2f"
                           % (queue, pol.queue_high))
        action = "hold"
        if reasons:
            if n >= pol.max_replicas:
                reasons.append("at max_replicas %d" % pol.max_replicas)
            elif self._cooling(tier, pol):
                reasons.append("in cooldown")
            else:
                action = "scale_out"
        elif kv <= pol.kv_low and queue <= pol.queue_low \
                and n > pol.min_replicas and not self._cooling(tier, pol):
            action = "scale_in"
            reasons = ["idle: kv %.2f <= %.2f, queue %.2f <= %.2f"
                       % (kv, pol.kv_low, queue, pol.queue_low)]
        if action == "scale_out":
            n = self._scale_out(router, n)
        elif action == "scale_in":
            n = self._scale_in(router, n)
        decision = {"action": action, "replicas": n, "reasons": reasons,
                    "kv_utilization": kv, "queue_fill": queue,
                    "p99_ttft_ms": p99_ttft, "p99_tpot_ms": p99_tpot}
        if action != "hold":
            self._last_action[tier] = time.monotonic()
            self.decisions.append(dict(decision, tier=tier))
        if profiler.profiling_active():
            c = self._counters[tier]
            c["replicas"].set_value(n)
            c["ttft"].set_value(p99_ttft)
            c["tpot"].set_value(p99_tpot)
        return decision

    def _cooling(self, tier, pol):
        last = self._last_action[tier]
        return (last is not None
                and time.monotonic() - last < pol.cooldown_s)

    def _scale_out(self, router, n):
        """Join a bare replica, then raise every engine target so the
        rebalancer builds + warms onto it before placement commits."""
        router.add_replica()
        for name in router.decode_models():
            router.scale_decode(name, n + 1)
        return n + 1

    def _scale_in(self, router, n):
        """Lower every engine target FIRST (the rebalancer must not
        re-place onto survivors), then drain the victim — its streams
        hand off via the fenced export/import protocol — and retire
        it."""
        victim = self._victim(router)
        if victim is None:
            return n
        for name in router.decode_models():
            router.scale_decode(name, max(1, n - 1))
        router.drain(victim)
        router.remove_replica(victim)
        return n - 1
