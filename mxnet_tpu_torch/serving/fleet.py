"""Elastic serving fleet: health-routed predicts across N server replicas.

One :class:`~mxnet_tpu_torch.serving.server.ModelServer` is one *replica*; this
router is the tier above it — the dynamic-membership story of the TensorFlow
paper (replicas come and go; the system reroutes, drains, and resumes) made
concrete for the serving path:

* **Placement** — ``load_model(name, ..., replicas=k)`` spreads the model
  over the k least-loaded live replicas; every copy is warmed (the full
  bucket-menu precompile) before it takes traffic.
* **Health-routed selection** — one ``serving/health.py`` CircuitBreaker per
  (model, replica) pair, fed by what the *router* observes: an UNAVAILABLE
  result or an unreachable/dead replica is a failure, any answered request
  is a success.  Selection rotates round-robin over the model's placement,
  skipping DRAINING/DEAD replicas and open breakers.
* **Bounded failover** — a predict that lands on a dead or UNAVAILABLE
  replica is retried on the next routable one, at most ``failover_budget``
  times; the request reaches exactly one terminal status either way, so
  fleet conservation (``requests == ok + timeouts + errors + unavailable``)
  holds across failovers.
* **Drain** — ``drain(rid)`` stops admission to a replica while its
  in-flight requests finish (the replica's server keeps running); new
  submissions that have nowhere else to go get UNAVAILABLE with a
  ``draining`` reason.  ``enable(rid)`` restores routing.
* **Rebalance** — when a replica joins (``add_replica``) or dies, every
  under-replicated model is re-loaded — *and re-warmed* — on a new replica
  BEFORE the placement cutover, so failover never recompiles in the hot
  path.  Death-triggered rebalancing runs on a background thread; the dying
  request has already failed over to an existing warm copy.

Replica death is observed, not announced: a ``faults.SimulatedCrash``
injected at the ``fleet.replica`` site (or an explicit ``kill_replica``)
models the replica process dying mid-request.  This is the one site where
production code catches SimulatedCrash — the router IS the surviving
process (see faults.py).

**Stateful decode tier.**  ``predict()`` traffic is stateless — any warm
replica can serve any request — but decode streams are not: a stream's KV
pages live on exactly one replica.  ``load_decode()`` places DecodeEngines
the way ``load_model`` places models, and ``submit_stream()`` routes each
NEW stream onto the replica with the most free KV blocks and the
shallowest queue (weighted score over the engine's live
``routing_signals()``), after which **session affinity** pins every token
of that stream to its placement.  The lifecycle verbs then honor the
state:

* ``drain(rid)`` performs a **fenced KV handoff**: each engine on the
  replica quiesces at a step boundary, every live stream's token prefix +
  K/V pages are exported, the replica's lease generation bumps (the
  fencing token — a zombie presenting the old generation can neither emit
  nor import), and the router resumes each stream on a survivor via
  ``import_stream`` — the merged stream is bitwise-equal to an
  uninterrupted one.
* ``kill_replica(rid)``/crash (no snapshot exists) terminates the
  replica's streams UNAVAILABLE with their valid prefix within a bounded
  deadline — never a hang — and the client re-admits with
  ``prompt + prefix`` as the new prompt.
* **Multi-tenant QoS**: ``set_tenant(name, weight, token_budget)`` gives
  every tenant a weighted-fair share of the fleet's KV token capacity; an
  over-budget tenant sheds OVERLOADED while the rest keep flowing.
  ``scaling_advice()``/``poll_scaling()`` turn breaker + KV-utilization
  signals into scale-out/scale-in policy hooks, with a per-engine-name
  breakdown; ``scale_decode()`` closes the loop into an actual replica
  retarget (serving/disagg/autoscaler.py drives it).
* **Cross-tier handoff**: ``adopt_stream()`` lands a snapshot exported
  by ANOTHER router's tier on this fleet's best replica, and
  ``mark_departed()`` detaches a handed-off stream from its local
  replica pin without dropping its accounting rec — together they are
  the primitive pair the disaggregated prefill/decode topology
  (serving/disagg/) is built from.

Counterpart of ``mxnet_tpu/serving/fleet.py``, the same state machine on
the port's ``ModelServer`` and ``DecodeEngine``.  On one CUDA card every
replica's batcher and engine worker threads launch on the same device, and
a joining copy warms (captures its CUDA graphs) while the others replay
theirs: a capture holds ``cached_op``'s process-wide capture lock, and an
engine that parks for a drain waits for its own stream, never for the
whole device (a device-wide synchronize would invalidate another thread's
capture in flight).  Deliberate divergences from the JAX package:

* ``scaling_advice()``'s device budget (``devices_total``) counts the
  CUDA devices this process sees (``torch.cuda.device_count()``), or 1
  (the host) without CUDA; the JAX package counts
  ``jax.local_device_count()``.  Two replicas on one H100 read as 2 of 1
  devices in use, which is the truth: they share the card.
* ``load_decode(tp=k)`` with k > 1 raises ``NotImplementedError``: the
  tensor-parallel engine needs ``serving/decode/sharding.py``, not ported
  yet.
"""
from __future__ import annotations

import threading
import time

from .. import faults
from ..base import MXNetError
from ..kvstore_server import MembershipTable
from .health import (CircuitBreaker, HEALTHY, DEGRADED, UNAVAILABLE_HEALTH,
                     REJECT, worst_health)
from .server import (ModelServer, InferenceResult,
                     OK, TIMEOUT, ERROR, UNAVAILABLE, OVERLOADED,
                     INVALID_INPUT)
from .stats import LatencyWindow

__all__ = ["FleetRouter", "FleetStats", "DecodeFleetStats",
           "LIVE", "DRAINING", "DEAD"]

# replica lifecycle states
LIVE = "LIVE"          # routable
DRAINING = "DRAINING"  # no new admissions; in-flight requests finish
DEAD = "DEAD"          # crashed or removed; never routable again


class FleetStats:
    """Fleet-level counters.  Thread-safe; same two-tier split as
    ModelStats: ``requests`` counts routed client calls that reached a
    terminal OK/TIMEOUT/ERROR/UNAVAILABLE status (the conservation set);
    ``shed``/``invalid`` count pass-through fast rejections outside it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.ok = 0
        self.timeouts = 0
        self.errors = 0
        self.unavailable = 0
        self.shed = 0            # OVERLOADED passed through from a replica
        self.invalid = 0         # INVALID_INPUT passed through
        self.failovers = 0       # attempts re-routed to another replica
        self.replica_deaths = 0
        self.rebalances = 0      # placement commits after a re-warm
        self._lat = LatencyWindow()

    def on_result(self, status, latency_ms=None):
        with self._lock:
            if status == OK:
                self.requests += 1
                self.ok += 1
            elif status == TIMEOUT:
                self.requests += 1
                self.timeouts += 1
            elif status == ERROR:
                self.requests += 1
                self.errors += 1
            elif status == UNAVAILABLE:
                self.requests += 1
                self.unavailable += 1
            elif status == OVERLOADED:
                self.shed += 1
            elif status == INVALID_INPUT:
                self.invalid += 1
            if latency_ms is not None:
                self._lat.add(latency_ms)

    def on_failover(self):
        with self._lock:
            self.failovers += 1

    def on_replica_death(self):
        with self._lock:
            self.replica_deaths += 1

    def on_rebalance(self):
        with self._lock:
            self.rebalances += 1

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
                "failovers": self.failovers,
                "replica_deaths": self.replica_deaths,
                "rebalances": self.rebalances,
                "latency_ms": self._lat.percentiles(),
            }


class DecodeFleetStats:
    """Router-level counters for the stateful decode tier.  Thread-safe;
    same two-tier split as FleetStats: ``requests`` counts streams the
    router ADMITTED and every one of them reaches exactly one terminal
    OK/TIMEOUT/ERROR/UNAVAILABLE count — across handoffs — so
    ``requests == ok + timeouts + errors + unavailable`` is the chaos
    gate's conservation invariant; ``shed`` (QoS/engine OVERLOADED),
    ``invalid`` and ``unavailable_rejected`` count fast rejections that
    never enter it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.ok = 0
        self.timeouts = 0
        self.errors = 0
        self.unavailable = 0
        self.shed = 0
        self.invalid = 0
        self.unavailable_rejected = 0
        self.handoffs = 0        # streams resumed on a survivor
        self.failovers = 0       # placement attempts re-routed
        self.fenced = 0          # streams terminated by a fence token
        self.tokens_out = 0      # tokens delivered across terminal streams
        self._lat = LatencyWindow()
        self._ttft = LatencyWindow()
        self._tpot = LatencyWindow()   # per-token decode latency (ms)

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

    def on_handoff(self):
        with self._lock:
            self.handoffs += 1

    def on_failover(self):
        with self._lock:
            self.failovers += 1

    def on_fenced(self):
        with self._lock:
            self.fenced += 1

    def on_result(self, status, latency_ms=None, ttft_ms=None, tokens=0):
        with self._lock:
            if status == OK:
                self.ok += 1
            elif status == TIMEOUT:
                self.timeouts += 1
            elif status == ERROR:
                self.errors += 1
            elif status == UNAVAILABLE:
                self.unavailable += 1
            else:
                return   # OVERLOADED/INVALID never register a stream rec
            self.tokens_out += int(tokens)
            if latency_ms is not None:
                self._lat.add(latency_ms)
            if ttft_ms is not None:
                self._ttft.add(ttft_ms)
            if int(tokens) > 1 and latency_ms is not None \
                    and ttft_ms is not None:
                # time-per-output-token: decode-phase latency spread over
                # the tokens after the first (the TPOT SLO's sample)
                self._tpot.add(max(0.0, latency_ms - ttft_ms)
                               / (int(tokens) - 1))

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
                "handoffs": self.handoffs,
                "failovers": self.failovers,
                "fenced": self.fenced,
                "tokens_out": self.tokens_out,
                "latency_ms": self._lat.percentiles(),
                "ttft_ms": self._ttft.percentiles(),
                "tpot_ms": self._tpot.percentiles(),
            }


class _Replica:
    """One replica row; every field except ``server`` is guarded by the
    router's ``_lock`` (``server`` is assigned once and never rebound)."""

    __slots__ = ("rid", "server", "state", "inflight", "gen")

    def __init__(self, rid, server):
        self.rid = rid
        self.server = server
        self.state = LIVE
        self.inflight = 0
        self.gen = 0             # current lease generation (fencing token)


class _ModelSpec:
    """Everything needed to re-load a model on a joining replica.
    ``wgen`` is the weight generation the spec currently serves (None
    until a deployment commits one); rebalance passes compare it at
    commit time so a copy warmed from a superseded generation is rolled
    back instead of routed."""

    __slots__ = ("name", "block", "input_shapes", "replicas", "kwargs",
                 "wgen")

    def __init__(self, name, block, input_shapes, replicas, kwargs):
        self.name = name
        self.block = block
        self.input_shapes = input_shapes
        self.replicas = replicas
        self.kwargs = kwargs
        self.wgen = None


class _EngineSpec:
    """Everything needed to re-build a decode engine on a joining replica.
    ``factory(name)`` must return a warmed DecodeEngine; ``max_new`` is
    learned from the first committed engine (the QoS need estimate for
    submissions that leave max_new_tokens to the engine default).  ``tp``
    is the declared tensor-parallel degree: every placement of this
    engine spans that many mesh devices (1 = unsharded), checked against
    the built engine's ``tp_degree``."""

    __slots__ = ("name", "factory", "replicas", "max_new", "tp", "wgen")

    def __init__(self, name, factory, replicas, tp=None):
        self.name = name
        self.factory = factory
        self.replicas = replicas
        self.max_new = 0
        self.tp = tp
        self.wgen = None         # weight generation the spec serves


class _StreamRec:
    """Router-side record of one admitted stream (the session-affinity
    pin).  Guarded by the router's ``_lock``."""

    __slots__ = ("name", "rid", "gen", "tenant", "need_tokens", "wgen")

    def __init__(self, name, rid, gen, tenant, need_tokens, wgen=None):
        self.name = name
        self.rid = rid
        self.gen = gen
        self.tenant = tenant
        self.need_tokens = need_tokens
        # weight generation the stream STARTED on; pinned for life
        # (docs/CONCURRENCY.md invariant 13) — handoffs may move the
        # stream between engines but never across generations
        self.wgen = wgen


class _Tenant:
    """Per-tenant QoS accounting.  Guarded by the router's ``_lock``."""

    __slots__ = ("name", "weight", "token_budget", "inflight_tokens",
                 "admitted", "completed", "ok", "qos_sheds")

    def __init__(self, name, weight=1.0, token_budget=None):
        self.name = name
        self.weight = float(weight)
        self.token_budget = token_budget
        self.inflight_tokens = 0
        self.admitted = 0
        self.completed = 0
        self.ok = 0
        self.qos_sheds = 0


class FleetRouter:
    """Spread models across replicas; route every predict by health.

    ``replica_factory`` builds one replica server (default: ModelServer).
    ``failover_budget`` bounds how many times one client request may be
    re-routed after an UNAVAILABLE/dead replica.  The per-(model, replica)
    breaker knobs mirror ServableModel's.

    Locking: ``_lock`` guards every piece of routing state (replica table,
    specs, placement, breakers, round-robin cursors, the closed flag).  No
    replica server call ever runs under ``_lock`` — predicts, loads and
    warmups are slow and must not serialize routing.  ``_rebalance_mutex``
    serializes rebalance passes (join + death-triggered) and always nests
    OUTSIDE ``_lock``.
    """

    def __init__(self, replicas=0, replica_factory=None, failover_budget=2,
                 breaker_threshold=3, breaker_backoff_ms=50.0,
                 breaker_max_backoff_ms=2000.0):
        if failover_budget < 0:
            raise ValueError("failover_budget must be >= 0")
        self._factory = replica_factory or ModelServer
        self._failover_budget = int(failover_budget)
        self._breaker_threshold = breaker_threshold
        self._breaker_backoff_s = breaker_backoff_ms / 1e3
        self._breaker_max_backoff_s = breaker_max_backoff_ms / 1e3
        self._lock = threading.Lock()
        self._rebalance_mutex = threading.Lock()
        self._replicas = {}     # rid -> _Replica
        self._specs = {}        # name -> _ModelSpec
        self._placement = {}    # name -> [rid, ...] (routable copies)
        self._breakers = {}     # (name, rid) -> CircuitBreaker
        self._rr = {}           # name -> round-robin cursor
        self._next_rid = 0
        self._closed = False
        # -- rolling deployment state (serving/deploy.py; all under _lock)
        # fleet name -> server-side model name: a swapped-in model copy
        # loads under "name@g<gen>" so old and new coexist on one server
        # during the swap; routing reads through this alias
        self._aliases = {}
        # copies flipped out of routing but still finishing their pinned
        # streams / in-flight predicts: dicts with kind/name/rid/wgen and
        # an "eng" (engine entries) or "sname" (model entries)
        self._retiring = []
        self._deploy = {"generation": None, "previous": None,
                        "staging": None, "revert": None,
                        "last_rollback": None}
        self.stats_sink = FleetStats()
        # -- stateful decode tier (all under _lock, same discipline) -----
        self._dspecs = {}       # name -> _EngineSpec
        self._dplacement = {}   # name -> [rid, ...] (routable engines)
        self._dengines = {}     # (name, rid) -> DecodeEngine
        self._dbreakers = {}    # (name, rid) -> CircuitBreaker
        self._streams = {}      # DecodeStream -> _StreamRec (affinity pins)
        self._departed = set()  # streams handed off before their pin landed
        self._tenants = {}      # tenant name -> _Tenant
        self._scaling = {"high": 0.85, "low": 0.15,
                         "scale_out": None, "scale_in": None}
        self.decode_stats = DecodeFleetStats()
        # lease generations fence replica incarnations across drains and
        # kills; its own RLock is never taken under _lock (registrations
        # happen outside, rows cache the granted generation)
        self._leases = MembershipTable(lease_ttl_s=3600.0)
        for _ in range(replicas):
            self.add_replica()

    # -- replica membership ---------------------------------------------
    def add_replica(self, server=None):
        """Join one replica (building it via the factory if not given),
        then rebalance: every under-replicated model is loaded AND warmed
        on it before its placement commits.  Returns the replica id."""
        server = server if server is not None else self._factory()
        with self._lock:
            if self._closed:
                raise MXNetError("fleet is stopped; create a new FleetRouter")
            rid = "r%d" % self._next_rid
            self._next_rid += 1
        gen = self._leases.register(rid).generation
        with self._lock:
            if self._closed:
                raise MXNetError("fleet is stopped; create a new FleetRouter")
            rep = _Replica(rid, server)
            rep.gen = gen
            self._replicas[rid] = rep
        self._rebalance()
        return rid

    def drain(self, rid):
        """Stop admitting requests to ``rid``; in-flight predicts finish
        (the replica's server keeps running) and every live decode stream
        is **handed off**: the replica's engines quiesce, each stream's
        prefix + KV pages are exported, the lease generation bumps (so
        the drained incarnation is fenced out of emitting), and each
        stream resumes on a survivor — or terminates UNAVAILABLE with its
        prefix when no survivor can adopt it.  Idempotent."""
        with self._lock:
            rep = _lookup_replica(self._replicas, rid)
            if rep.state == DEAD:
                raise MXNetError("replica %s is dead" % rid)
            rep.state = DRAINING
            engines = [(name, eng) for (name, r), eng
                       in self._dengines.items() if r == rid]
            # retiring copies on this replica still hold pinned streams of
            # their own generation; they drain through the same protocol
            # (their snapshots only land on same-generation survivors)
            engines += [(e["name"], e["eng"]) for e in self._retiring
                        if e["kind"] == "engine" and e["rid"] == rid]
        if engines:
            self._handoff_decode(rid, engines)

    def enable(self, rid):
        """Undo ``drain``: restore routing to ``rid`` and resume its
        quiesced decode engines (a fresh lease generation was already
        granted at drain time, so re-enabled engines emit with current
        fencing tokens)."""
        with self._lock:
            rep = _lookup_replica(self._replicas, rid)
            if rep.state == DEAD:
                raise MXNetError("replica %s is dead" % rid)
            rep.state = LIVE
            engines = [eng for (name, r), eng in self._dengines.items()
                       if r == rid]
        for eng in engines:
            eng.resume()

    def kill_replica(self, rid):
        """Abrupt replica death (the test/chaos hook): mark DEAD, drop it
        from every placement, stop its server, rebalance in the
        background.  Returns False if it was already dead/unknown."""
        return self._replica_died(rid)

    def remove_replica(self, rid, timeout_s=10.0):
        """Graceful decommission: drain, wait for in-flight requests to
        finish (bounded), then retire the replica and rebalance."""
        self.drain(rid)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if _lookup_replica(self._replicas, rid).inflight == 0:
                    break
            time.sleep(0.005)
        self._replica_died(rid, expected=True)

    def inflight(self, rid):
        with self._lock:
            return _lookup_replica(self._replicas, rid).inflight

    def replicas(self):
        """rid -> state for every replica ever joined (dead ones linger
        for observability)."""
        with self._lock:
            return {rid: rep.state for rid, rep in self._replicas.items()}

    def server(self, rid):
        """The underlying replica server (tests / direct maintenance)."""
        with self._lock:
            return _lookup_replica(self._replicas, rid).server

    # -- model management ------------------------------------------------
    def load_model(self, name, block, input_shapes, replicas=2, **kwargs):
        """Load ``block`` on the ``replicas`` least-loaded live replicas
        (capped at the live count; at least one required).  Each copy is
        warmed before its placement commits, so the model never takes
        traffic on a cold replica.  ``kwargs`` pass through to
        ``ModelServer.load_model`` and are retained for rebalancing."""
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        with self._lock:
            if self._closed:
                raise MXNetError("fleet is stopped; create a new FleetRouter")
            if name in self._specs:
                raise MXNetError("model %r is already loaded in the fleet"
                                 % name)
            if not any(r.state == LIVE for r in self._replicas.values()):
                raise MXNetError("no live replicas; add_replica() first")
            # reserve the name so a racing duplicate load fails fast;
            # placement stays empty until each copy is warm
            self._specs[name] = _ModelSpec(name, block, input_shapes,
                                           int(replicas), dict(kwargs))
            self._placement[name] = []
            self._rr[name] = 0
        try:
            self._rebalance()
        except Exception:
            self.unload_model(name)
            raise
        with self._lock:
            placed = bool(self._placement.get(name))
        if not placed:
            self.unload_model(name)
            raise MXNetError("could not place model %r on any live replica"
                             % name)

    def unload_model(self, name):
        with self._lock:
            if name not in self._specs:
                raise MXNetError("no model %r in the fleet; loaded: %s"
                                 % (name, sorted(self._specs) or "none"))
            del self._specs[name]
            sname = self._aliases.pop(name, name)
            rids = self._placement.pop(name, [])
            self._rr.pop(name, None)
            servers = []
            for rid in rids:
                self._breakers.pop((name, rid), None)
                rep = self._replicas.get(rid)
                if rep is not None and rep.state != DEAD:
                    servers.append(rep.server)
        for server in servers:
            try:
                server.unload(sname)
            except MXNetError:
                pass   # replica raced into teardown; nothing to unload

    def models(self):
        with self._lock:
            return sorted(self._specs)

    # -- stateful decode tier ---------------------------------------------
    def load_decode(self, name, factory, replicas=1, tp=None):
        """Place decode engines for ``name`` on the ``replicas``
        least-loaded live replicas.  ``factory(name)`` must build one
        warmed :class:`~mxnet_tpu_torch.serving.decode.DecodeEngine` (identical
        params per call — the fleet hands streams between copies and the
        merged output must be bitwise-consistent).  Each engine attaches
        to its replica's server, so a replica death tears its engines
        down with it.

        ``tp`` declares the engine's tensor-parallel degree; the port has
        no tensor-parallel engine yet, so only ``None`` and 1 load (a
        larger degree raises ``NotImplementedError``).  The built
        engine's ``tp_degree`` must match the declaration — mismatch
        fails the load with an MXNetError naming both."""
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if tp is not None and int(tp) < 1:
            raise ValueError("tp must be >= 1 (or None for unsharded)")
        if tp is not None and int(tp) > 1:
            raise NotImplementedError(
                "load_decode(tp=%d) needs a tensor-parallel engine "
                "(ShardedDecodeModel in serving/decode/sharding.py), which "
                "is not ported yet; load with tp=None or tp=1" % int(tp))
        with self._lock:
            if self._closed:
                raise MXNetError("fleet is stopped; create a new FleetRouter")
            if name in self._dspecs or name in self._specs:
                raise MXNetError("%r is already loaded in the fleet" % name)
            if not any(r.state == LIVE for r in self._replicas.values()):
                raise MXNetError("no live replicas; add_replica() first")
            self._dspecs[name] = _EngineSpec(
                name, factory, int(replicas),
                tp=None if tp is None else int(tp))
            self._dplacement[name] = []
        try:
            self._rebalance()
        except Exception:
            self.unload_decode(name)
            raise
        with self._lock:
            placed = bool(self._dplacement.get(name))
        if not placed:
            self.unload_decode(name)
            raise MXNetError("could not place decode engine %r on any live "
                             "replica" % name)

    def unload_decode(self, name):
        with self._lock:
            if name not in self._dspecs:
                raise MXNetError("no decode engine %r in the fleet; "
                                 "loaded: %s"
                                 % (name, sorted(self._dspecs) or "none"))
            del self._dspecs[name]
            rids = self._dplacement.pop(name, [])
            engines = []
            for rid in rids:
                self._dbreakers.pop((name, rid), None)
                eng = self._dengines.pop((name, rid), None)
                rep = self._replicas.get(rid)
                if eng is not None and rep is not None \
                        and rep.state != DEAD:
                    engines.append((rep.server, eng))
        for server, eng in engines:
            try:
                # by the ENGINE's name: a swapped-in copy attaches under
                # "name@g<gen>", not the fleet name
                server.detach_engine(eng.name)
            except MXNetError:
                pass
            eng.stop()

    def decode_models(self):
        with self._lock:
            return sorted(self._dspecs)

    def engine(self, name, rid):
        """The placed engine object (tests / direct maintenance)."""
        with self._lock:
            eng = self._dengines.get((name, rid))
        if eng is None:
            raise MXNetError("no engine %r on replica %s" % (name, rid))
        return eng

    # mxflow: hot (stream routing path)
    def submit_stream(self, name, prompt, max_new_tokens=None,
                      timeout_ms=None, tenant=None, on_token=None,
                      temperature=0.0, top_k=0, top_p=1.0, seed=None):
        """Admit one generation stream into the fleet; always returns a
        DecodeStream (rejections come back already terminal, same status
        discipline as ``DecodeEngine.submit``).

        Admission is two-gated: the **tenant QoS gate** first (token
        budget + weighted-fair share — an over-budget tenant sheds
        OVERLOADED while others flow), then **KV-aware placement**: the
        stream lands on the LIVE replica whose engine scores best on
        free KV blocks / queue headroom / throughput, with bounded
        failover past UNAVAILABLE engines.  Once admitted, the stream is
        pinned to its placement (session affinity) and every emission is
        fenced by ``(rid, lease_generation)``."""
        from .decode.engine import DecodeStream
        t_deadline = (time.monotonic() + timeout_ms / 1e3
                      if timeout_ms is not None else None)
        tenant = tenant if tenant is not None else "default"
        try:
            plen = len(prompt)
        except TypeError:
            plen = 1
        with self._lock:
            spec = self._dspecs.get(name)
            spec_max_new = spec.max_new if spec is not None else 0
        if spec is None:
            raise MXNetError("no decode engine %r in the fleet; loaded: %s"
                             % (name, sorted(self.decode_models()) or "none"))
        need = int(plen) + int(max_new_tokens if max_new_tokens is not None
                               else spec_max_new)

        def _reject(status, counter, error):
            counter()
            stream = DecodeStream(None, need, t_deadline)
            stream.complete(status, error=error)
            return stream

        # -- QoS gate: capacity signals outside _lock, verdict under it --
        free_tokens, cap_tokens = self._decode_headroom(name)
        with self._lock:
            ten = self._tenants.get(tenant)
            if ten is None:
                ten = _Tenant(tenant)
                self._tenants[tenant] = ten
            total_w = sum(t.weight for t in self._tenants.values())
            fair = (cap_tokens * ten.weight / total_w if total_w > 0
                    else cap_tokens)
            if ten.token_budget is not None \
                    and ten.inflight_tokens + need > ten.token_budget:
                ten.qos_sheds += 1
                verdict = ("tenant %r over token budget (%d in flight + %d "
                           "needed > %d)" % (tenant, ten.inflight_tokens,
                                             need, ten.token_budget))
            elif ten.inflight_tokens + need > fair and free_tokens < need:
                ten.qos_sheds += 1
                verdict = ("tenant %r over its weighted share (%.0f tokens) "
                           "under contention" % (tenant, fair))
            else:
                verdict = None
                ten.inflight_tokens += need
        if verdict is not None:
            return _reject(OVERLOADED, self.decode_stats.on_shed, verdict)

        # -- KV-aware placement with bounded failover --------------------
        def _release_tokens():
            with self._lock:
                t = self._tenants.get(tenant)
                if t is not None:
                    t.inflight_tokens = max(0, t.inflight_tokens - need)

        tried = set()
        stream = None
        reason = "no attempts"
        for attempt in range(self._failover_budget + 1):
            sel, reason = self._select_decode(name, tried)
            if sel is None:
                break
            rep, eng, gen, breaker = sel
            owner = (rep.rid, gen)
            try:
                faults.fault_point("fleet.replica", replica=rep.rid,
                                   model=name)
            except faults.SimulatedCrash:
                # same contract as _route: the crash is the REPLICA's
                # death and this router survives it
                self._replica_died(rep.rid)
                tried.add(rep.rid)
                self.decode_stats.on_failover()
                continue
            s = eng.submit(prompt, max_new_tokens=max_new_tokens,
                           timeout_ms=timeout_ms, on_token=on_token,
                           owner=owner, temperature=temperature,
                           top_k=top_k, top_p=top_p, seed=seed)
            if s.admitted:
                breaker.on_success()
                stream = s
                break
            status = s.snapshot()[0]
            if status == INVALID_INPUT:
                _release_tokens()
                self.decode_stats.on_invalid()
                return s
            if status == UNAVAILABLE:
                breaker.on_failure()
            tried.add(rep.rid)           # OVERLOADED: try a freer replica
            self.decode_stats.on_failover()
        if stream is None:
            _release_tokens()
            return _reject(
                UNAVAILABLE, self.decode_stats.on_unavailable_rejected,
                "no routable decode replica for %r (%s)" % (name, reason))
        # session affinity: pin the stream to wherever it actually lives
        # NOW (a drain may already have re-owned it mid-admission)
        ow = stream.owner()
        rid, gen = ow if (isinstance(ow, tuple) and len(ow) == 2) \
            else (rep.rid, gen)
        with self._lock:
            # the generation pin comes from the ENGINE that admitted: a
            # swap committing between selection and this pin leaves the
            # old engine retiring but still the stream's home, so its tag
            # (not the spec's current one) is the truth
            rec = _StreamRec(name, rid, gen, tenant, need,
                             wgen=eng.generation)
            if stream in self._departed:
                # handed off to another tier before this pin landed: the
                # rec still settles the tenant + terminal accounting, but
                # it must never match a local replica id again
                self._departed.discard(stream)
                rec.rid = rec.gen = None
            self._streams[stream] = rec
            ten = self._tenants.get(tenant)
            if ten is not None:
                ten.admitted += 1
        self.decode_stats.on_admitted()
        # terminal hook AFTER the rec exists: fires immediately if the
        # stream already completed, so the rec can never leak
        stream.on_terminal(self._stream_done)
        return stream

    def _decode_headroom(self, name):
        """(free_tokens, capacity_tokens) across the model's LIVE
        placements — engine signal reads, never under ``_lock``."""
        with self._lock:
            engines = [self._dengines[(name, rid)]
                       for rid in self._dplacement.get(name, ())
                       if (name, rid) in self._dengines
                       and self._replicas[rid].state == LIVE]
        free = cap = 0
        for eng in engines:
            sig = eng.routing_signals()
            free += sig["kv_blocks_free"] * sig["kv_block_size"]
            cap += sig["kv_capacity"] * sig["kv_block_size"]
        return free, cap

    def _select_decode(self, name, tried):
        """Pick (replica, engine, generation, breaker) for one placement
        attempt, or (None, reason).  Candidates are LIVE placements not
        yet tried; the winner maximizes a weighted score over the live
        engine signals — free KV blocks dominate (2x), queue headroom
        next (1x), recent throughput breaks ties (0.25x) — so a new
        stream lands where its KV reservation and queue wait are
        cheapest."""
        with self._lock:
            if self._closed:
                return None, "fleet stopped"
            if name not in self._dspecs:
                raise MXNetError("no decode engine %r in the fleet; "
                                 "loaded: %s"
                                 % (name, sorted(self._dspecs) or "none"))
            placed = list(self._dplacement.get(name, ()))
            if not placed:
                return None, "no replicas host it"
            cands = []
            n_draining = 0
            for rid in placed:
                rep = self._replicas[rid]
                if rep.state == DRAINING:
                    n_draining += 1
                if rid in tried or rep.state != LIVE:
                    continue
                cands.append((rep, self._dengines[(name, rid)], rep.gen,
                              self._dbreakers[(name, rid)]))
        if not cands:
            if n_draining:
                return None, "draining"
            return None, "all replicas tried or dead"
        scored = []
        for rep, eng, gen, breaker in cands:
            # signal reads outside _lock (engine conds are slow-path locks)
            sig = eng.routing_signals()
            if sig["draining"]:
                continue
            scored.append((rep, eng, gen, breaker, sig))
        if not scored:
            return None, "all engines draining"
        max_tps = max(s[4]["tokens_per_s"] for s in scored)

        def score(item):
            sig = item[4]
            kv_free = sig["kv_blocks_free"] / max(1, sig["kv_capacity"])
            queue_room = 1.0 - sig["queue_depth"] / max(1, sig["max_queue"])
            tps = sig["tokens_per_s"] / max_tps if max_tps > 0 else 0.0
            return 2.0 * kv_free + 1.0 * queue_room + 0.25 * tps

        # deterministic order: best score first, rid breaks ties
        scored.sort(key=lambda it: (-score(it), it[0].rid))
        for rep, eng, gen, breaker, _ in scored:
            # admit() outside _lock, same as the predict path
            if breaker.admit() != REJECT:
                return (rep, eng, gen, breaker), None
        return None, "all breakers open"

    def _stream_done(self, stream):
        """Terminal hook for every router-admitted stream: runs off every
        other lock (complete() fires it after releasing the stream cond),
        settles the tenant's in-flight tokens, and counts the terminal
        status exactly once — across however many engines the stream
        visited."""
        status, tokens, ttft, latency, _ = stream.snapshot()
        with self._lock:
            self._departed.discard(stream)
            rec = self._streams.pop(stream, None)
            if rec is None:
                return
            ten = self._tenants.get(rec.tenant)
            if ten is not None:
                ten.inflight_tokens = max(
                    0, ten.inflight_tokens - rec.need_tokens)
                ten.completed += 1
                if status == OK:
                    ten.ok += 1
        self.decode_stats.on_result(status, latency_ms=latency,
                                    ttft_ms=ttft, tokens=len(tokens))

    def _fence_terminate(self, stream, why):
        """Terminate a stream nothing owns anymore: install a fresh
        private fence token (so no engine incarnation can emit past this
        point) and complete UNAVAILABLE with the prefix intact.  Never
        called under ``_lock`` — the terminal hook takes it."""
        token = object()
        stream.set_owner(token)
        if stream.complete(UNAVAILABLE, error=why, owner=token):
            self.decode_stats.on_fenced()

    def _handoff_decode(self, rid, engines):
        """Drain-side stream migration for every engine on ``rid``.

        Protocol (docs/ROBUSTNESS.md "Stream handoff"): (1) **fence** —
        bump the replica's lease generation, so the drained incarnation's
        ``(rid, old_gen)`` tokens go stale the moment anything is
        re-owned; (2) **snapshot** — quiesce each engine at a step
        boundary and export every live stream's prefix + K/V pages;
        (3) **resume** — import each snapshot on the best survivor,
        re-owning the stream to ``(rid2, gen2)`` first.  A wedged engine
        (quiesce timeout) or an exhausted survivor search degrades to a
        fenced UNAVAILABLE terminal — bounded, never a hang."""
        new_gen = self._leases.register(rid).generation
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is not None:
                rep.gen = new_gen
        for name, eng in engines:
            if not eng.quiesce(timeout_s=5.0):
                # wedged mid-step: nothing exportable; fence its streams
                with self._lock:
                    stuck = [s for s, rec in self._streams.items()
                             if rec.rid == rid and rec.name == name]
                for stream in stuck:
                    self._fence_terminate(
                        stream, "replica %s wedged during drain" % rid)
                continue
            for stream, snap in eng.export_streams():
                self._resume_on_survivor(name, stream, snap, exclude=rid)

    def mark_departed(self, stream):
        """Detach a stream from its replica pin WITHOUT dropping its rec:
        the disaggregated router calls this the moment a prefill engine
        hands the stream to the decode tier.  The rec keeps settling the
        tenant tokens and the terminal count (cross-tier conservation
        stays on THIS router), but ``rid``/``gen`` go None so a later
        death or wedged drain of the prefill replica can never fence a
        stream that now lives on the other tier.  If the handoff outraces
        ``submit_stream``'s pin, the stream is parked in ``_departed``
        and the pin lands already-detached."""
        with self._lock:
            rec = self._streams.get(stream)
            if rec is not None:
                rec.rid = rec.gen = None
            else:
                self._departed.add(stream)

    def adopt_stream(self, name, stream, snap, exclude=None):
        """Adopt a stream exported by ANOTHER router (the cross-tier
        entry: serving/disagg/ lands prefill-tier snapshots here).  Same
        protocol as a drain resume — generation check, re-own, import on
        the best-scoring replica with bounded failover.  Returns True on
        adoption (counted in ``decode_stats.handoffs``); False when no
        replica could take it, in which case the stream was already
        fence-terminated UNAVAILABLE with its prefix intact."""
        with self._lock:
            if name not in self._dspecs:
                raise MXNetError("no decode engine %r in the fleet; "
                                 "loaded: %s"
                                 % (name, sorted(self._dspecs) or "none"))
        return self._resume_on_survivor(name, stream, snap, exclude=exclude)

    def _resume_on_survivor(self, name, stream, snap, exclude):
        """Land one exported stream on the best surviving replica; on
        exhaustion, fence-terminate it (UNAVAILABLE, prefix intact).

        Generation routing: a snapshot carries the weight generation of
        the engine that exported it, and it may only resume on an engine
        of the SAME generation (invariant 13; import_stream enforces it
        bitwise too).  A snapshot from the fleet's current generation
        takes the normal scored path; one from a retiring generation can
        only land on a retiring same-generation copy (the already-cut-over
        survivor of the rolling swap)."""
        if stream.snapshot()[0] is not None:
            # terminal while in flight (a concurrent kill fenced it):
            # importing it would strand a stream no engine can complete
            return False
        wgen = snap.get("generation")
        with self._lock:
            spec = self._dspecs.get(name)
            current = spec.wgen if spec is not None else None
        if wgen != current:
            return self._resume_on_retiring(name, stream, snap, wgen,
                                            exclude)
        tried = {exclude}
        for _ in range(self._failover_budget + 1):
            sel, _reason = self._select_decode(name, tried)
            if sel is None:
                break
            rep2, eng2, gen2, _breaker = sel
            try:
                # the fencing handshake: the target's generation must be
                # current (a stale/zombie incarnation fails here), and
                # the stream is re-owned BEFORE the import so the old
                # engine's in-flight emissions are refused from now on
                self._leases.check_generation(rep2.rid, gen2)
            except MXNetError:
                tried.add(rep2.rid)
                continue
            owner2 = (rep2.rid, gen2)
            stream.set_owner(owner2)
            try:
                eng2.import_stream(snap, stream=stream, owner=owner2)
            except MXNetError:
                tried.add(rep2.rid)   # no headroom / draining: next one
                continue
            with self._lock:
                rec = self._streams.get(stream)
                if rec is not None:
                    rec.rid = rep2.rid
                    rec.gen = gen2
            self.decode_stats.on_handoff()
            return True
        self._fence_terminate(
            stream, "drained replica's stream found no survivor with KV "
                    "headroom; re-admit with the emitted prefix as prompt")
        return False

    def _resume_on_retiring(self, name, stream, snap, wgen, exclude):
        """Land a retiring-generation snapshot on a retiring
        same-generation copy; fence-terminate when none survives."""
        with self._lock:
            cands = []
            for entry in self._retiring:
                if (entry["kind"] == "engine" and entry["name"] == name
                        and entry["wgen"] == wgen
                        and entry["rid"] != exclude):
                    rep = self._replicas.get(entry["rid"])
                    if rep is not None and rep.state == LIVE:
                        cands.append((rep, entry["eng"], rep.gen))
        for rep2, eng2, gen2 in cands:
            try:
                self._leases.check_generation(rep2.rid, gen2)
            except MXNetError:
                continue
            owner2 = (rep2.rid, gen2)
            stream.set_owner(owner2)
            try:
                eng2.import_stream(snap, stream=stream, owner=owner2)
            except MXNetError:
                continue      # no headroom / mid-retire: next candidate
            with self._lock:
                rec = self._streams.get(stream)
                if rec is not None:
                    rec.rid = rep2.rid
                    rec.gen = gen2
            self.decode_stats.on_handoff()
            return True
        self._fence_terminate(
            stream, "stream's weight generation %r has no surviving copy; "
                    "re-admit with the emitted prefix as prompt" % (wgen,))
        return False

    # -- multi-tenant QoS -------------------------------------------------
    def set_tenant(self, name, weight=1.0, token_budget=None):
        """Configure one tenant: ``weight`` is its share of the fleet's
        KV token capacity under contention; ``token_budget`` (tokens in
        flight, prompt + budgeted generation) is an absolute cap, None =
        uncapped.  Unknown tenants auto-create at weight 1.0 on first
        submission."""
        if weight <= 0:
            raise ValueError("tenant weight must be > 0")
        with self._lock:
            ten = self._tenants.get(name)
            if ten is None:
                self._tenants[name] = _Tenant(name, weight, token_budget)
            else:
                ten.weight = float(weight)
                ten.token_budget = token_budget

    def tenant_snapshot(self):
        with self._lock:
            return {
                t.name: {
                    "weight": t.weight,
                    "token_budget": t.token_budget,
                    "inflight_tokens": t.inflight_tokens,
                    "admitted": t.admitted,
                    "completed": t.completed,
                    "ok": t.ok,
                    "qos_sheds": t.qos_sheds,
                } for t in self._tenants.values()
            }

    def scale_decode(self, name, replicas):
        """Retarget a decode engine's replica count and converge toward
        it: scale-out builds + warms a fresh engine on a spare replica
        BEFORE its placement commits (the warm-before-cutover rule, via
        ``_rebalance``), so a joining copy never serves cold.  Lowering
        the target removes nothing by itself — scale-in is ``drain(rid)``
        (streams hand off) followed by ``remove_replica(rid)``, with the
        lowered target keeping the rebalancer from re-placing onto the
        survivors.  The autoscaler (serving/disagg/autoscaler.py) drives
        both directions."""
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        with self._lock:
            spec = self._dspecs.get(name)
            if spec is None:
                raise MXNetError("no decode engine %r in the fleet; "
                                 "loaded: %s"
                                 % (name, sorted(self._dspecs) or "none"))
            spec.replicas = int(replicas)
        self._rebalance()

    # -- scaling policy hooks ----------------------------------------------
    def set_scaling_policy(self, scale_out=None, scale_in=None,
                           high=0.85, low=0.15):
        """Install scale-out/scale-in callbacks (``cb(router, advice)``)
        and the KV-utilization / queue-fill thresholds that trigger
        them."""
        if not 0.0 <= low < high <= 1.0:
            raise ValueError("need 0 <= low < high <= 1")
        with self._lock:
            self._scaling = {"high": float(high), "low": float(low),
                             "scale_out": scale_out, "scale_in": scale_in}

    def scaling_advice(self):
        """Derive scale-out/hold/scale-in advice from the live breaker +
        engine signals: sustained KV pressure or queue depth (or an
        unhealthy breaker) says scale out; a near-idle fleet says scale
        in.  The advice also carries the mesh footprint — a tp=k engine
        placement consumes k devices — so policies can see when scale-out
        would overcommit the device budget.

        ``advice["engines"]`` breaks the same signals down per engine
        NAME (replica count, per-name KV utilization / queue fill /
        device footprint, and which thresholds that name tripped) — the
        disaggregated router surfaces these as its per-tier reasons, and
        a policy can scale one engine while holding another.

        ``devices_total`` is the number of CUDA devices this process sees,
        or 1 (the host) without CUDA: replicas that share a card share
        its one device in the budget."""
        devices_total = _device_budget()
        with self._lock:
            engines = list(self._dengines.items())
            breakers = list(self._dbreakers.values())
            high = self._scaling["high"]
            low = self._scaling["low"]
        if not engines:
            return {"action": "hold", "kv_utilization": 0.0,
                    "queue_fill": 0.0, "unhealthy_breakers": 0,
                    "devices_in_use": 0, "devices_total": devices_total,
                    "kv_bytes_free": 0, "kv_bytes_capacity": 0,
                    "engines": {},
                    "reasons": ["no decode engines placed"]}
        utils, fills = [], []
        devices_in_use = 0
        kv_bytes_free = kv_bytes_capacity = 0
        per_name = {}
        for (name, _rid), eng in engines:
            sig = eng.routing_signals()
            cap = max(1, sig["kv_capacity"])
            util = 1.0 - sig["kv_blocks_free"] / cap
            fill = sig["queue_depth"] / max(1, sig["max_queue"])
            devs = max(1, int(sig.get("tp_degree", 1)))
            b_free = int(sig.get("kv_bytes_free", 0))
            b_cap = int(sig.get("kv_bytes_capacity", 0))
            utils.append(util)
            fills.append(fill)
            devices_in_use += devs
            kv_bytes_free += b_free
            kv_bytes_capacity += b_cap
            row = per_name.setdefault(
                name, {"replicas": 0, "devices_in_use": 0,
                       "kv_bytes_free": 0, "kv_bytes_capacity": 0,
                       "_utils": [], "_fills": []})
            row["replicas"] += 1
            row["devices_in_use"] += devs
            row["kv_bytes_free"] += b_free
            row["kv_bytes_capacity"] += b_cap
            row["_utils"].append(util)
            row["_fills"].append(fill)
        breakdown = {}
        for name, row in sorted(per_name.items()):
            n_util = sum(row["_utils"]) / len(row["_utils"])
            n_fill = max(row["_fills"])
            n_reasons = []
            if n_util >= high:
                n_reasons.append("kv utilization %.2f >= %.2f"
                                 % (n_util, high))
            if n_fill >= high:
                n_reasons.append("queue fill %.2f >= %.2f" % (n_fill, high))
            breakdown[name] = {
                "replicas": row["replicas"],
                "devices_in_use": row["devices_in_use"],
                "kv_utilization": n_util,
                "queue_fill": n_fill,
                "kv_bytes_free": row["kv_bytes_free"],
                "kv_bytes_capacity": row["kv_bytes_capacity"],
                "reasons": n_reasons,
            }
        kv_util = sum(utils) / len(utils)
        queue_fill = max(fills)
        unhealthy = sum(1 for b in breakers if b.health() != HEALTHY)
        reasons = []
        if kv_util >= high:
            reasons.append("kv utilization %.2f >= %.2f" % (kv_util, high))
        if queue_fill >= high:
            reasons.append("queue fill %.2f >= %.2f" % (queue_fill, high))
        if unhealthy:
            reasons.append("%d unhealthy engine breaker(s)" % unhealthy)
        if reasons:
            action = "scale_out"
        elif kv_util <= low and queue_fill <= low and not unhealthy:
            action = "scale_in"
            reasons = ["kv utilization %.2f and queue fill %.2f <= %.2f"
                       % (kv_util, queue_fill, low)]
        else:
            action = "hold"
            reasons = ["within thresholds"]
        if action == "scale_out" and devices_in_use >= devices_total:
            reasons.append("device budget exhausted: %d/%d devices in use"
                           % (devices_in_use, devices_total))
        return {"action": action, "kv_utilization": kv_util,
                "queue_fill": queue_fill, "unhealthy_breakers": unhealthy,
                "devices_in_use": devices_in_use,
                "devices_total": devices_total,
                # bytes-based headroom summed from the engines' HBM
                # accountant signals (block geometry x unreserved blocks)
                "kv_bytes_free": kv_bytes_free,
                "kv_bytes_capacity": kv_bytes_capacity,
                "engines": breakdown,
                "reasons": reasons}

    def poll_scaling(self):
        """Evaluate ``scaling_advice()`` and invoke the matching policy
        hook (if installed); returns the advice."""
        advice = self.scaling_advice()
        with self._lock:
            cb = self._scaling.get(advice["action"])
        if cb is not None:
            cb(self, advice)
        return advice

    # -- inference -------------------------------------------------------
    def predict(self, name, data, timeout_ms=None):
        """Blocking fleet predict; always returns an InferenceResult.

        Routes to a healthy replica; an UNAVAILABLE result, an injected
        link fault, or the replica dying mid-request triggers failover to
        the next routable replica, at most ``failover_budget`` times.
        Exactly one terminal status is counted per client call."""
        t0 = time.monotonic()
        res = self._route(name, data, timeout_ms)
        ms = (time.monotonic() - t0) * 1e3
        if res.latency_ms is None:
            res.latency_ms = ms
        self.stats_sink.on_result(res.status, ms)
        return res

    def _route(self, name, data, timeout_ms):
        tried = set()
        budget = self._failover_budget
        for attempt in range(budget + 1):
            sel, reason = self._select(name, tried)
            if sel is None:
                return InferenceResult(
                    UNAVAILABLE,
                    error="no routable replica for %r (%s)" % (name, reason))
            rep, breaker, sname = sel
            self._begin(rep)
            try:
                faults.fault_point("fleet.replica", replica=rep.rid,
                                   model=name)
                res = rep.server.predict(sname, data, timeout_ms=timeout_ms)
            except faults.SimulatedCrash:
                # the ONE place production code catches SimulatedCrash: at
                # the fleet.replica site the crash is the REPLICA's death
                # and this router is the surviving process (faults.py)
                self._replica_died(rep.rid)
                tried.add(rep.rid)
                if attempt < budget:
                    self.stats_sink.on_failover()
                    continue
                return InferenceResult(
                    UNAVAILABLE,
                    error="replica %s died mid-request; failover budget "
                          "exhausted" % rep.rid)
            except faults.InjectedFault as exc:
                # transient/fatal link fault between router and replica:
                # the replica may be fine, but THIS path isn't — count a
                # breaker failure and fail over
                breaker.on_failure()
                tried.add(rep.rid)
                if attempt < budget:
                    self.stats_sink.on_failover()
                    continue
                return InferenceResult(
                    UNAVAILABLE,
                    error="replica %s unreachable (%s); failover budget "
                          "exhausted" % (rep.rid, exc))
            finally:
                self._end(rep)
            if res.status != UNAVAILABLE:
                # the replica answered — reachable from the router's seat.
                # (ERROR/OVERLOADED are the replica's own concern; its
                # per-model breaker and queue bound handle them.)
                breaker.on_success()
                return res
            breaker.on_failure()
            tried.add(rep.rid)
            if attempt < budget:
                self.stats_sink.on_failover()
                continue
            return res
        raise AssertionError("unreachable")   # loop always returns

    def _select(self, name, tried):
        """Pick (replica, breaker, server-side name) for one attempt, or
        (None, reason).  The server-side name is the deployment alias —
        the fleet name itself until a swap commits, "name@g<gen>" after.

        Round-robin over the model's placement, skipping already-tried,
        non-LIVE, and breaker-REJECT replicas.  Unknown model raises."""
        with self._lock:
            if self._closed:
                return None, "fleet stopped"
            if name not in self._specs:
                raise MXNetError("no model %r in the fleet; loaded: %s"
                                 % (name, sorted(self._specs) or "none"))
            sname = self._aliases.get(name, name)
            placed = list(self._placement.get(name, ()))
            if not placed:
                return None, "no replicas host it"
            cursor = self._rr[name]
            self._rr[name] = cursor + 1
            start = cursor % len(placed)
            order = placed[start:] + placed[:start]
            cands = []
            n_draining = 0
            for rid in order:
                rep = self._replicas[rid]
                if rep.state == DRAINING:
                    n_draining += 1
                if rid in tried or rep.state != LIVE:
                    continue
                cands.append((rep, self._breakers[(name, rid)]))
        if not cands:
            if n_draining:
                return None, "draining"
            return None, "all replicas tried or dead"
        for rep, breaker in cands:
            # admit() outside _lock: the breaker has its own lock, and a
            # REJECT here must not stall other routing threads
            if breaker.admit() != REJECT:
                return (rep, breaker, sname), None
        return None, "all breakers open"

    def _begin(self, rep):
        with self._lock:
            rep.inflight += 1

    def _end(self, rep):
        with self._lock:
            rep.inflight -= 1

    # -- replica death + rebalancing --------------------------------------
    def _replica_died(self, rid, expected=False):
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rep.state == DEAD:
                return False
            rep.state = DEAD
            # an in-progress swap can no longer cover this replica: the
            # staged copies on it die with the server below, and commit
            # must not flip a partial fleet — mark the staging aborted so
            # commit_swap refuses and the controller aborts back to the
            # old generation (evaluated BEFORE placements are pruned, so
            # "did the dead replica matter to the swap" sees the truth)
            st = self._deploy["staging"]
            if st is not None and st["aborted"] is None:
                involved = rid in st["rids"] or any(
                    rid in self._placement.get(n, ())
                    or rid in self._dplacement.get(n, ())
                    for n in st["names"])
                if involved:
                    st["aborted"] = "replica %s died mid-swap" % rid
                for key in [k for k in st["engines"] if k[1] == rid]:
                    del st["engines"][key]
                for key in [k for k in st["models"] if k[1] == rid]:
                    del st["models"][key]
            # retiring copies on the dead replica are gone with it; their
            # streams are swept with the affected set below
            self._retiring = [e for e in self._retiring
                              if e["rid"] != rid]
            for name, rids in self._placement.items():
                if rid in rids:
                    rids.remove(rid)
                    self._breakers.pop((name, rid), None)
            for name, rids in self._dplacement.items():
                if rid in rids:
                    rids.remove(rid)
            dkeys = [(name, r) for (name, r) in self._dengines if r == rid]
            for key in dkeys:
                self._dengines.pop(key, None)
                self._dbreakers.pop(key, None)
            affected = [s for s, rec in self._streams.items()
                        if rec.rid == rid]
            closed = self._closed
        if not expected:
            self.stats_sink.on_replica_death()
        # fence the dead incarnation: any zombie still holding the old
        # generation fails check_generation on future import attempts
        self._leases.register(rid)
        try:
            rep.server.stop()
        except Exception:
            pass   # it "crashed"; best-effort teardown of the local object
        # the server stop above drained the attached engines: their live
        # streams completed UNAVAILABLE with matching fencing tokens (no
        # snapshot exists in a crash — the prefix is the client's to
        # re-admit).  Sweep any router-registered stream that still isn't
        # terminal (e.g. lost a submit-vs-crash race) with a fence token,
        # so no stream on a dead replica can ever hang.
        for stream in affected:
            if stream.snapshot()[0] is None:
                self._fence_terminate(
                    stream, "replica %s died; re-admit with the emitted "
                            "prefix as prompt" % rid)
        if not closed:
            # rebalance off the request path: the failing request has
            # already failed over to a warm copy; restoring the replication
            # factor (re-warm included) is background work
            threading.Thread(target=self._rebalance,
                             name="fleet-rebalance", daemon=True).start()
        return True

    def _rebalance(self):
        """Restore every model to min(target, live replicas) copies.

        One (model, replica) deficit at a time: pick the least-loaded live
        candidate under ``_lock``, load + warm OUTSIDE the lock, then
        commit the placement — the re-warm-before-cutover rule."""
        with self._rebalance_mutex:
            failed = set()   # (name, rid) that refused the load this pass
            while True:
                task = None
                with self._lock:
                    if self._closed:
                        return
                    live = [r for r in self._replicas.values()
                            if r.state == LIVE]
                    hosted = {r.rid: 0 for r in live}
                    for placement in (self._placement, self._dplacement):
                        for rids in placement.values():
                            for rid in rids:
                                if rid in hosted:
                                    hosted[rid] += 1
                    for name in sorted(self._specs):
                        spec = self._specs[name]
                        placed = self._placement[name]
                        live_placed = [rid for rid in placed
                                       if self._replicas[rid].state == LIVE]
                        want = min(spec.replicas, len(live))
                        if len(live_placed) >= want:
                            continue
                        cands = [r for r in live
                                 if r.rid not in placed
                                 and (name, r.rid) not in failed]
                        if not cands:
                            continue
                        cands.sort(key=lambda r: (hosted[r.rid], r.rid))
                        # alias + weight generation captured with the
                        # task: if a deployment commits while this copy
                        # warms, the commit-time re-check below rolls the
                        # superseded copy back instead of routing it
                        task = (name, spec, cands[0],
                                self._aliases.get(name, name), spec.wgen)
                        break
                    dtask = None
                    if task is None:
                        # decode-engine deficits: same one-per-pass rule,
                        # least-loaded counts BOTH tiers' placements
                        for name in sorted(self._dspecs):
                            spec = self._dspecs[name]
                            placed = self._dplacement[name]
                            live_placed = [
                                rid for rid in placed
                                if self._replicas[rid].state == LIVE]
                            want = min(spec.replicas, len(live))
                            if len(live_placed) >= want:
                                continue
                            cands = [r for r in live
                                     if r.rid not in placed
                                     and (name, r.rid) not in failed]
                            if not cands:
                                continue
                            cands.sort(key=lambda r: (hosted[r.rid], r.rid))
                            dtask = (name, spec, cands[0], spec.wgen)
                            break
                    if task is None and dtask is None:
                        return
                if task is not None:
                    name, spec, rep, sname, wgen0 = task
                    try:
                        # load + full bucket-menu warmup on the new replica,
                        # BEFORE the placement commit below makes it routable
                        rep.server.load_model(sname, spec.block,
                                              spec.input_shapes, **spec.kwargs)
                    except MXNetError:
                        failed.add((name, rep.rid))
                        continue
                    committed = False
                    with self._lock:
                        if (not self._closed and rep.state == LIVE
                                and self._specs.get(name) is spec
                                and spec.wgen == wgen0
                                and self._aliases.get(name, name) == sname
                                and rep.rid not in self._placement[name]):
                            self._placement[name].append(rep.rid)
                            self._breakers[(name, rep.rid)] = CircuitBreaker(
                                failure_threshold=self._breaker_threshold,
                                backoff_s=self._breaker_backoff_s,
                                max_backoff_s=self._breaker_max_backoff_s)
                            committed = True
                    if committed:
                        self.stats_sink.on_rebalance()
                    else:
                        # lost the race (replica died / model unloaded /
                        # generation superseded / fleet stopped while
                        # warming): roll the orphan back
                        try:
                            rep.server.unload(sname)
                        except MXNetError:
                            pass
                    continue
                # decode deficit: build + warm a fresh engine OUTSIDE the
                # lock (factory runs prefill/decode warmup), attach it to
                # the replica's server so replica teardown drains it, then
                # commit the placement
                name, spec, rep, wgen0 = dtask
                try:
                    eng = spec.factory(name)
                except MXNetError:
                    failed.add((name, rep.rid))
                    continue
                built_tp = int(getattr(eng, "tp_degree", 1))
                if spec.tp is not None and built_tp != spec.tp:
                    # a misdeclared degree corrupts the fleet's device
                    # accounting, so fail the load loudly (the factory is
                    # deterministic: the first, synchronous placement in
                    # load_decode() hits this before any background pass)
                    eng.stop()
                    raise MXNetError(
                        "decode engine %r was loaded with tp=%d but its "
                        "factory built an engine with tp_degree=%d; wrap "
                        "the factory's model in ShardedDecodeModel(tp=%d) "
                        "or fix the load_decode(tp=...) declaration"
                        % (name, spec.tp, built_tp, spec.tp))
                try:
                    rep.server.attach_engine(eng)
                except MXNetError:
                    eng.stop()
                    failed.add((name, rep.rid))
                    continue
                committed = False
                with self._lock:
                    if (not self._closed and rep.state == LIVE
                            and self._dspecs.get(name) is spec
                            and spec.wgen == wgen0
                            and rep.rid not in self._dplacement[name]):
                        self._dplacement[name].append(rep.rid)
                        self._dengines[(name, rep.rid)] = eng
                        self._dbreakers[(name, rep.rid)] = CircuitBreaker(
                            failure_threshold=self._breaker_threshold,
                            backoff_s=self._breaker_backoff_s,
                            max_backoff_s=self._breaker_max_backoff_s)
                        spec.max_new = eng.max_new_tokens
                        committed = True
                if committed:
                    self.stats_sink.on_rebalance()
                else:
                    try:
                        rep.server.detach_engine(eng.name)
                    except MXNetError:
                        pass
                    eng.stop()

    def wait_converged(self, timeout_s=10.0, reason_on_timeout=False):
        """Block until every model has min(target, live) routable copies
        (rebalancing settled).  Returns True on convergence; on timeout,
        returns False — or, with ``reason_on_timeout=True``, raises an
        MXNetError naming every (model, replica-deficit) still open, so a
        wedged rebalance (e.g. a factory that never finishes warming)
        surfaces as a diagnosis instead of parking the caller forever."""
        deadline = time.monotonic() + timeout_s
        while True:
            deficits = []
            with self._lock:
                n_live = sum(1 for r in self._replicas.values()
                             if r.state == LIVE)
                for tier, placement in (("model", self._placement),
                                        ("decode", self._dplacement)):
                    specs = self._specs if tier == "model" else self._dspecs
                    for name, spec in sorted(specs.items()):
                        live_placed = [rid for rid in placement[name]
                                       if self._replicas[rid].state == LIVE]
                        want = min(spec.replicas, n_live)
                        if len(live_placed) < want:
                            deficits.append(
                                "%s %r: %d/%d routable copies (placed on %s)"
                                % (tier, name, len(live_placed), want,
                                   live_placed or "nothing"))
            if not deficits:
                return True
            if time.monotonic() >= deadline:
                if reason_on_timeout:
                    raise MXNetError(
                        "fleet did not converge within %.1fs; open "
                        "deficits: %s" % (timeout_s, "; ".join(deficits)))
                return False
            time.sleep(0.005)

    # -- rolling weight swap (serving/deploy.py drives these) --------------
    #
    # The four-phase generation swap (docs/ROBUSTNESS.md "Rolling
    # deployment"): begin -> stage (build + warm every new copy OUTSIDE
    # _lock, old copies still serving) -> fence (lease-generation bump on
    # every staged replica) -> commit (one atomic routing flip under
    # _lock: no server or engine call, no fault point, nothing half-done)
    # -> retire (old copies finish their pinned streams, consolidating
    # onto one same-generation sink, then tear down).  abort_swap undoes a
    # pre-commit swap; rollback_swap inverts a committed one while the
    # revert record (cleared by retire_swap) still holds the old copies.

    def begin_swap(self, generation):
        """Open a staging area for weight generation ``generation``.
        Exactly one swap at a time: raises while another is staging or a
        committed one has not been retired yet."""
        with self._lock:
            if self._closed:
                raise MXNetError("fleet is stopped; create a new FleetRouter")
            if self._deploy["staging"] is not None:
                raise MXNetError(
                    "a swap to generation %r is already staging; abort or "
                    "commit it first"
                    % (self._deploy["staging"]["generation"],))
            if self._deploy["revert"] is not None or self._retiring:
                raise MXNetError(
                    "the previous swap has not been retired; call "
                    "retire_swap() (or rollback_swap()) first")
            self._deploy["staging"] = {
                "generation": generation, "names": set(),
                "engines": {},     # (name, rid) -> warmed DecodeEngine
                "models": {},      # (name, rid) -> server-side model name
                "efactories": {},  # name -> generation engine factory
                "mblocks": {},     # name -> generation block
                "rids": set(), "fenced": False, "aborted": None,
            }

    @staticmethod
    def _staging_ok(st):
        """Validate a staging dict (read by the caller under ``_lock``)."""
        if st is None:
            raise MXNetError("no swap staged; call begin_swap() first")
        if st["aborted"] is not None:
            raise MXNetError("swap to generation %r aborted: %s"
                             % (st["generation"], st["aborted"]))
        return st

    def stage_decode(self, name, rid, factory):
        """Build + warm one new-generation engine for placement
        ``(name, rid)``.  ``factory(srv_name)`` must return a warmed
        DecodeEngine; it runs OUTSIDE ``_lock`` (warmup compiles are
        slow) while the old copy keeps serving.  The engine attaches to
        the replica's server under ``"name@g<generation>"`` so both
        generations coexist until commit."""
        with self._lock:
            st = self._staging_ok(self._deploy["staging"])
            g = st["generation"]
            spec = self._dspecs.get(name)
            if spec is None:
                raise MXNetError("no decode engine %r in the fleet; "
                                 "loaded: %s"
                                 % (name, sorted(self._dspecs) or "none"))
            rep = self._replicas.get(rid)
            if rep is None or rep.state != LIVE \
                    or rid not in self._dplacement.get(name, ()):
                raise MXNetError("(%r, %s) is not a LIVE placement"
                                 % (name, rid))
            if (name, rid) in st["engines"]:
                raise MXNetError("(%r, %s) is already staged" % (name, rid))
        srv_name = "%s@g%s" % (name, g)
        eng = factory(srv_name)
        if getattr(eng, "generation", None) is None:
            eng.generation = g
        built_tp = int(getattr(eng, "tp_degree", 1))
        if spec.tp is not None and built_tp != spec.tp:
            eng.stop()
            raise MXNetError(
                "staged engine %r has tp_degree=%d but the fleet spec "
                "declares tp=%d" % (srv_name, built_tp, spec.tp))
        try:
            rep.server.attach_engine(eng)
        except MXNetError:
            eng.stop()
            raise
        with self._lock:
            ok = (self._deploy["staging"] is st and st["aborted"] is None
                  and not self._closed and rep.state == LIVE
                  and self._dspecs.get(name) is spec)
            if ok:
                st["engines"][(name, rid)] = eng
                st["efactories"][name] = factory
                st["names"].add(name)
                st["rids"].add(rid)
        if not ok:
            # lost a death/abort race while warming: tear the orphan down
            try:
                rep.server.detach_engine(eng.name)
            except MXNetError:
                pass
            eng.stop()
            raise MXNetError("swap staging ended while warming %r on %s"
                             % (name, rid))
        return eng

    def stage_model(self, name, rid, block):
        """Load + warm one new-generation model copy for placement
        ``(name, rid)`` under the alias ``"name@g<generation>"`` (spec
        kwargs are inherited; the generation rides in as the copy's
        tag).  Runs outside ``_lock``, old copy still serving."""
        with self._lock:
            st = self._staging_ok(self._deploy["staging"])
            g = st["generation"]
            spec = self._specs.get(name)
            if spec is None:
                raise MXNetError("no model %r in the fleet; loaded: %s"
                                 % (name, sorted(self._specs) or "none"))
            rep = self._replicas.get(rid)
            if rep is None or rep.state != LIVE \
                    or rid not in self._placement.get(name, ()):
                raise MXNetError("(%r, %s) is not a LIVE placement"
                                 % (name, rid))
            if (name, rid) in st["models"]:
                raise MXNetError("(%r, %s) is already staged" % (name, rid))
            kwargs = dict(spec.kwargs)
        kwargs["generation"] = g
        sname = "%s@g%s" % (name, g)
        rep.server.load_model(sname, block, spec.input_shapes, **kwargs)
        with self._lock:
            ok = (self._deploy["staging"] is st and st["aborted"] is None
                  and not self._closed and rep.state == LIVE
                  and self._specs.get(name) is spec)
            if ok:
                st["models"][(name, rid)] = sname
                st["mblocks"][name] = block
                st["names"].add(name)
                st["rids"].add(rid)
        if not ok:
            try:
                rep.server.unload(sname)
            except MXNetError:
                pass
            raise MXNetError("swap staging ended while warming %r on %s"
                             % (name, rid))

    def fence_swap(self):
        """Fence every staged replica's old incarnation: bump its lease
        generation (MembershipTable) and cache the new one on the
        replica row.  In-flight streams keep their per-stream owner
        tokens and keep emitting on the old copies; what dies is the old
        generation's power to RE-own or import anything from here on."""
        with self._lock:
            st = self._staging_ok(self._deploy["staging"])
            if not st["engines"] and not st["models"]:
                raise MXNetError("nothing staged; stage_decode()/"
                                 "stage_model() before fence_swap()")
            rids = sorted(st["rids"])
        for rid in rids:
            new_gen = self._leases.register(rid).generation
            with self._lock:
                rep = self._replicas.get(rid)
                if rep is not None and rep.state != DEAD:
                    rep.gen = new_gen
        with self._lock:
            st2 = self._deploy["staging"]
            if st2 is st:
                st["fenced"] = True

    def commit_swap(self):
        """The atomic routing flip.  Entirely under ``_lock`` with no
        server/engine call and no fault point inside: a kill before it
        leaves the fleet fully on the old generation, a kill after it
        fully on the new one — there is no in-between to observe.

        Requires a fenced, unaborted staging whose copies cover EVERY
        live routable placement of every swapped name (a mid-swap
        replica death breaks coverage and fails the commit).  Old copies
        move to the retiring list; the revert record for
        ``rollback_swap`` is built from the same entries."""
        with self._lock:
            st = self._staging_ok(self._deploy["staging"])
            if not st["fenced"]:
                raise MXNetError("fence_swap() must run before "
                                 "commit_swap()")
            g = st["generation"]
            missing = []
            for name in sorted(st["names"]):
                if name in self._dspecs:
                    for rid in self._dplacement.get(name, ()):
                        if self._replicas[rid].state != DEAD \
                                and (name, rid) not in st["engines"]:
                            missing.append("engine (%s, %s)" % (name, rid))
                if name in self._specs:
                    for rid in self._placement.get(name, ()):
                        if self._replicas[rid].state != DEAD \
                                and (name, rid) not in st["models"]:
                            missing.append("model (%s, %s)" % (name, rid))
            if missing:
                raise MXNetError(
                    "cannot commit generation %r: unstaged live "
                    "placements: %s" % (g, ", ".join(missing)))
            retired = []
            revert = {"generation": self._deploy["generation"],
                      "previous": self._deploy["previous"],
                      "engines": {}, "models": {}, "retired": retired}
            for name in sorted({n for (n, _r) in st["engines"]}):
                spec = self._dspecs[name]
                revert["engines"][name] = {
                    "factory": spec.factory, "wgen": spec.wgen,
                    "max_new": spec.max_new}
                for rid in list(self._dplacement.get(name, ())):
                    key = (name, rid)
                    new_eng = st["engines"].get(key)
                    if new_eng is None:
                        continue   # dead rid already pruned from placement
                    entry = {"kind": "engine", "name": name, "rid": rid,
                             "wgen": spec.wgen,
                             "eng": self._dengines.get(key)}
                    self._retiring.append(entry)
                    retired.append(entry)
                    self._dengines[key] = new_eng
                    breaker = self._dbreakers.get(key)
                    if breaker is not None:
                        breaker.reset()
                    spec.max_new = new_eng.max_new_tokens
                spec.factory = st["efactories"][name]
                spec.wgen = g
            for name in sorted({n for (n, _r) in st["models"]}):
                spec = self._specs[name]
                old_sname = self._aliases.get(name, name)
                revert["models"][name] = {
                    "sname": old_sname, "block": spec.block,
                    "kwargs": spec.kwargs, "wgen": spec.wgen}
                new_sname = "%s@g%s" % (name, g)
                for rid in list(self._placement.get(name, ())):
                    if (name, rid) not in st["models"]:
                        continue
                    entry = {"kind": "model", "name": name, "rid": rid,
                             "wgen": spec.wgen, "sname": old_sname}
                    self._retiring.append(entry)
                    retired.append(entry)
                    breaker = self._breakers.get((name, rid))
                    if breaker is not None:
                        breaker.reset()
                self._aliases[name] = new_sname
                spec.block = st["mblocks"][name]
                kwargs = dict(spec.kwargs)
                kwargs["generation"] = g
                spec.kwargs = kwargs
                spec.wgen = g
            self._deploy["previous"] = self._deploy["generation"]
            self._deploy["generation"] = g
            self._deploy["revert"] = revert
            self._deploy["staging"] = None

    def rollback_swap(self, reason="health gate"):
        """Invert a committed, not-yet-retired swap: the routing flip runs
        backwards under ``_lock`` (old copies come straight back out of
        the retiring list — they were never torn down), the bad
        generation's copies go INTO the retiring list to finish whatever
        streams they admitted, and placements that only ever existed on
        the bad generation (a post-commit rebalance) are dropped for the
        background rebalancer to rebuild from the restored spec."""
        with self._lock:
            revert = self._deploy["revert"]
            if revert is None:
                raise MXNetError("nothing to roll back (no committed, "
                                 "unretired swap)")
            bad_gen = self._deploy["generation"]
            alive = {id(e) for e in self._retiring}
            live_old = {(e["kind"], e["name"], e["rid"]): e
                        for e in revert["retired"] if id(e) in alive}
            for name, saved in revert["engines"].items():
                spec = self._dspecs.get(name)
                if spec is None:
                    continue
                keep = []
                for rid in list(self._dplacement.get(name, ())):
                    key = (name, rid)
                    bad_eng = self._dengines.get(key)
                    if bad_eng is not None:
                        self._retiring.append(
                            {"kind": "engine", "name": name, "rid": rid,
                             "wgen": spec.wgen, "eng": bad_eng})
                    old = live_old.get(("engine", name, rid))
                    if old is not None:
                        self._retiring = [e for e in self._retiring
                                          if e is not old]
                        self._dengines[key] = old["eng"]
                        breaker = self._dbreakers.get(key)
                        if breaker is not None:
                            breaker.reset()
                        keep.append(rid)
                    else:
                        self._dengines.pop(key, None)
                        self._dbreakers.pop(key, None)
                self._dplacement[name] = keep
                spec.factory = saved["factory"]
                spec.wgen = saved["wgen"]
                spec.max_new = saved["max_new"]
            for name, saved in revert["models"].items():
                spec = self._specs.get(name)
                if spec is None:
                    continue
                bad_sname = self._aliases.get(name, name)
                keep = []
                for rid in list(self._placement.get(name, ())):
                    self._retiring.append(
                        {"kind": "model", "name": name, "rid": rid,
                         "wgen": spec.wgen, "sname": bad_sname})
                    old = live_old.get(("model", name, rid))
                    if old is not None:
                        self._retiring = [e for e in self._retiring
                                          if e is not old]
                        breaker = self._breakers.get((name, rid))
                        if breaker is not None:
                            breaker.reset()
                        keep.append(rid)
                    else:
                        self._breakers.pop((name, rid), None)
                self._placement[name] = keep
                if saved["sname"] == name:
                    self._aliases.pop(name, None)
                else:
                    self._aliases[name] = saved["sname"]
                spec.block = saved["block"]
                spec.kwargs = saved["kwargs"]
                spec.wgen = saved["wgen"]
            self._deploy["generation"] = revert["generation"]
            self._deploy["previous"] = revert["previous"]
            self._deploy["last_rollback"] = {"generation": bad_gen,
                                             "reason": reason}
            self._deploy["revert"] = None
            closed = self._closed
        if not closed:
            # rebuild any placement the rollback dropped, off this thread
            threading.Thread(target=self._rebalance,
                             name="fleet-rebalance", daemon=True).start()

    def abort_swap(self, reason=None):
        """Discard a pre-commit staging: staged copies detach/unload and
        stop; routing never changed, so the fleet simply continues on the
        old generation.  Idempotent (no staging = no-op)."""
        with self._lock:
            st = self._deploy["staging"]
            self._deploy["staging"] = None
            work = []
            if st is not None:
                for (name, rid), eng in st["engines"].items():
                    rep = self._replicas.get(rid)
                    if rep is not None and rep.state != DEAD:
                        work.append(("engine", rep.server, eng))
                for (name, rid), sname in st["models"].items():
                    rep = self._replicas.get(rid)
                    if rep is not None and rep.state != DEAD:
                        work.append(("model", rep.server, sname))
        for kind, server, obj in work:
            if kind == "engine":
                try:
                    server.detach_engine(obj.name)
                except MXNetError:
                    pass
                obj.stop()
            else:
                try:
                    server.unload(obj)
                except MXNetError:
                    pass
        return st is not None

    def retire_swap(self, timeout_s=10.0):
        """Finish and tear down every retiring copy; clears the revert
        record (the swap's point of no return — rollback_swap is
        impossible after this returns).

        Retiring engines of one (name, generation) group consolidate
        before teardown: all but one quiesce and fenced-handoff their
        still-running streams onto the group's surviving sink (the
        already-cut-over survivor), which then finishes them — bounded by
        ``timeout_s``, after which leftovers fence-terminate UNAVAILABLE
        with their prefix intact.  Retiring model copies unload once
        their replica's in-flight predicts clear (bounded the same
        way)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            entries = list(self._retiring)
        groups = {}
        model_entries = []
        for e in entries:
            if e["kind"] == "engine":
                groups.setdefault((e["name"], e["wgen"]), []).append(e)
            else:
                model_entries.append(e)
        handed = fenced = 0

        def _teardown(entry):
            with self._lock:
                present = any(x is entry for x in self._retiring)
                self._retiring = [x for x in self._retiring
                                  if x is not entry]
                rep = self._replicas.get(entry["rid"])
                server = (rep.server if rep is not None
                          and rep.state != DEAD else None)
            if not present or server is None:
                return
            eng = entry["eng"]
            try:
                server.detach_engine(eng.name)
            except MXNetError:
                pass
            eng.stop()

        def _fence_left(name, wgen, rid=None):
            n = 0
            with self._lock:
                stuck = [s for s, rec in self._streams.items()
                         if rec.name == name and rec.wgen == wgen
                         and (rid is None or rec.rid == rid)]
            for stream in stuck:
                self._fence_terminate(
                    stream, "weight generation %r retired before the "
                            "stream finished; re-admit with the emitted "
                            "prefix as prompt" % (wgen,))
                n += 1
            return n

        for (name, wgen), group in sorted(
                groups.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
            with self._lock:
                alive = {id(e) for e in self._retiring}
                live = [e for e in group if id(e) in alive
                        and (rep := self._replicas.get(e["rid"]))
                        is not None and rep.state == LIVE]
            sink = live[-1] if live else None
            for e in group:
                if e is sink:
                    continue
                with self._lock:
                    if not any(x is e for x in self._retiring):
                        continue   # swept by a concurrent replica death
                eng = e["eng"]
                if sink is not None and eng.quiesce(timeout_s=5.0):
                    for stream, snap in eng.export_streams():
                        if self._resume_on_retiring(name, stream, snap,
                                                    wgen, exclude=e["rid"]):
                            handed += 1
                        else:
                            fenced += 1
                else:
                    fenced += _fence_left(name, wgen, rid=e["rid"])
                _teardown(e)
            if sink is None:
                fenced += _fence_left(name, wgen)
                continue
            while time.monotonic() < deadline:
                with self._lock:
                    left = any(rec.name == name and rec.wgen == wgen
                               for rec in self._streams.values())
                if not left:
                    break
                time.sleep(0.01)
            fenced += _fence_left(name, wgen)
            _teardown(sink)
        for e in model_entries:
            with self._lock:
                present = any(x is e for x in self._retiring)
                self._retiring = [x for x in self._retiring if x is not e]
                rep = self._replicas.get(e["rid"])
                server = (rep.server if rep is not None
                          and rep.state != DEAD else None)
            if not present or server is None:
                continue
            while time.monotonic() < deadline:
                with self._lock:
                    inflight = rep.inflight
                if inflight == 0:
                    break
                time.sleep(0.005)
            try:
                server.unload(e["sname"])
            except MXNetError:
                pass
        with self._lock:
            self._deploy["revert"] = None
        return {"handoffs": handed, "fenced": fenced,
                "retired": len(entries)}

    # -- observability ----------------------------------------------------
    def health(self, name=None):
        """HEALTHY / DEGRADED / UNAVAILABLE for one model or decode
        engine (or the worst across the fleet).  A name with zero
        routable replicas is UNAVAILABLE; under target, a non-LIVE
        placement, or any breaker off HEALTHY is DEGRADED.  Decode names
        fall through to the attached engines on every placement, so a
        replica whose engine breaker opened degrades the fleet answer
        even before the router's own breaker notices."""
        with self._lock:
            if name is not None and name not in self._specs \
                    and name not in self._dspecs:
                raise MXNetError(
                    "no model %r in the fleet; loaded: %s"
                    % (name, sorted(set(self._specs) | set(self._dspecs))
                       or "none"))
            names = ([name] if name is not None
                     else sorted(set(self._specs) | set(self._dspecs)))
            n_live = sum(1 for r in self._replicas.values()
                         if r.state == LIVE)
            rows = []
            for n in names:
                if n in self._specs:
                    placed = list(self._placement[n])
                    target = self._specs[n].replicas
                    probes = [self._breakers[(n, rid)] for rid in placed
                              if self._replicas[rid].state == LIVE]
                else:
                    placed = list(self._dplacement[n])
                    target = self._dspecs[n].replicas
                    # breaker AND engine per live placement: the engine's
                    # own health (its internal execute breaker) rolls up
                    probes = []
                    for rid in placed:
                        if self._replicas[rid].state != LIVE:
                            continue
                        probes.append(self._dbreakers[(n, rid)])
                        probes.append(self._dengines[(n, rid)])
                states = [self._replicas[rid].state for rid in placed]
                rows.append((target, states, probes))
        worst = HEALTHY
        for target, states, probes in rows:
            n_routable = sum(1 for s in states if s == LIVE)
            if n_routable == 0:
                h = UNAVAILABLE_HEALTH
            else:
                # .health() calls outside _lock (breakers and engines
                # take their own locks)
                levels = [p.health() for p in probes]
                if (worst_health(levels) != HEALTHY
                        or n_routable < min(target, max(n_live, 1))
                        or any(s != LIVE for s in states)):
                    h = DEGRADED
                else:
                    h = HEALTHY
            worst = worst_health((worst, h))
        return worst

    def stats(self):
        """Fleet counters + per-replica and per-model routing state."""
        with self._lock:
            reps = {rid: {"state": rep.state, "inflight": rep.inflight,
                          "models": sorted(n for n, rids
                                           in self._placement.items()
                                           if rid in rids),
                          "engines": sorted(n for n, rids
                                            in self._dplacement.items()
                                            if rid in rids)}
                    for rid, rep in self._replicas.items()}
            models = {}
            for name, spec in self._specs.items():
                placed = list(self._placement[name])
                models[name] = {
                    "target": spec.replicas,
                    "placement": placed,
                    "breakers": {rid: self._breakers[(name, rid)]
                                 for rid in placed
                                 if (name, rid) in self._breakers},
                }
            dmodels = {}
            for name, spec in self._dspecs.items():
                placed = list(self._dplacement[name])
                dmodels[name] = {
                    "target": spec.replicas,
                    "placement": placed,
                    "breakers": {rid: self._dbreakers[(name, rid)]
                                 for rid in placed
                                 if (name, rid) in self._dbreakers},
                }
            dengines = dict(self._dengines)
        for snaps in (models, dmodels):
            for snap in snaps.values():
                snap["breakers"] = {rid: b.snapshot()
                                    for rid, b in snap["breakers"].items()}
        out = self.stats_sink.snapshot()
        out["replicas"] = reps
        out["models"] = models
        out["decode_models"] = dmodels
        # per-engine fall-through: the full DecodeEngine snapshot of every
        # placement, fleet-wide (engine calls outside _lock)
        engines_out = {}
        for (name, rid), eng in sorted(dengines.items()):
            engines_out.setdefault(name, {})[rid] = eng.stats_snapshot()
        out["engines"] = engines_out
        out["decode"] = self.decode_stats.snapshot()
        # fleet-wide prefix-cache / speculation rollup (headroom math
        # already counts shared pages once via each engine's
        # available_unreserved signal)
        roll = {"prefix_hits": 0, "prefix_blocks_shared": 0,
                "cow_forks": 0, "spec_proposed": 0, "spec_accepted": 0}
        for per_model in engines_out.values():
            for snap in per_model.values():
                for key in roll:
                    roll[key] += snap.get(key, 0)
        out["decode"]["prefix_spec"] = roll
        out["tenants"] = self.tenant_snapshot()
        with self._lock:
            st = self._deploy["staging"]
            out["deploy"] = {
                "generation": self._deploy["generation"],
                "previous": self._deploy["previous"],
                "in_progress": None if st is None else {
                    "generation": st["generation"],
                    "staged_engines": sorted(
                        "%s@%s" % k for k in st["engines"]),
                    "staged_models": sorted(
                        "%s@%s" % k for k in st["models"]),
                    "fenced": st["fenced"],
                    "aborted": st["aborted"],
                },
                "retiring": len(self._retiring),
                "aliases": {n: a for n, a in self._aliases.items()
                            if a != n},
                "last_rollback": self._deploy["last_rollback"],
            }
        return out

    # -- lifecycle ---------------------------------------------------------
    def stop(self):
        """Stop every replica server; idempotent."""
        with self._lock:
            self._closed = True
            servers = [rep.server for rep in self._replicas.values()
                       if rep.state != DEAD]
        for server in servers:
            try:
                server.stop()
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

def _device_budget():
    """The devices a fleet in this process can place engines on."""
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _lookup_replica(replicas, rid):
    """Row lookup over an already-locked replica table."""
    try:
        return replicas[rid]
    except KeyError:
        raise MXNetError("no replica %r; known: %s"
                         % (rid, sorted(replicas) or "none"))
