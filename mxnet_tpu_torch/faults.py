"""Seeded fault injection (counterpart of ``mxnet_tpu/faults.py``).

Named injection sites (``KNOWN_SITES``) sit at the runtime's I/O and
execution boundaries; code calls ``fault_point(site, **info)``, which does
nothing unless a :class:`FaultPlan` is active.  A plan is a seeded set of
rules: which sites fail, how (transient, fatal, torn write, process
crash), with what probability and how many times, so that every chaos run
replays from its seed.  The same plan fires at the same hits in both
packages: ``consult`` draws from ``random.Random(seed)`` in the same order.

Fault kinds
-----------
``transient``
    Raises :class:`TransientFault`, the retryable class: a site wrapped in
    :func:`mxnet_tpu_torch.util.retry` absorbs it unless it fires more
    times than the retry budget.
``fatal``
    Raises :class:`FatalFault`: not retryable; surfaces as an ERROR at the
    call site and trips the serving circuit breaker.
``crash``
    Raises :class:`SimulatedCrash`, a ``BaseException`` that no recovery
    code can swallow by accident: it models ``kill -9`` mid-operation.
``truncate``
    Torn write for file sites: truncates ``info["fileobj"]`` at a seeded
    byte offset, then crashes.  Sites that pass no file crash plainly.

Usage::

    plan = faults.FaultPlan(seed=7)
    plan.add("serving.predict", kind="transient", p=0.3, times=5)
    with faults.plan(plan):
        ...  # every thread sees the plan; counters in plan.hits / plan.fired

The port wires ``serving.predict`` (``ServableModel`` and the decode
engine, before each execution), ``checkpoint.*`` (``util.write_atomic``),
``fleet.replica`` (``serving/fleet.py``) and ``deploy.*``
(``serving/deploy.py``); the other sites are kept in the catalog so that
plans written for the JAX package load unchanged.
"""
from __future__ import annotations

import contextlib
import random
import threading

from .base import MXNetError

__all__ = ["InjectedFault", "TransientFault", "FatalFault", "SimulatedCrash",
           "FaultPlan", "FaultRule", "plan", "active_plan", "fault_point",
           "is_retryable", "KNOWN_SITES"]

# the fault-site catalog (docs/ROBUSTNESS.md keeps the prose version).
# fault_point() rejects unknown names so a typo at an injection site fails
# loudly in the chaos suite instead of silently never firing.
KNOWN_SITES = frozenset({
    # checkpoint file writes (util.write_atomic: every atomic write —
    # .params / -symbol.json / .states / -manifest.json — passes these)
    "checkpoint.write",       # after each chunk lands in the tmp file
    "checkpoint.replace",     # tmp fully written+fsynced, BEFORE os.replace
    "checkpoint.replaced",    # after os.replace, before the caller returns
    # input pipeline
    "dataloader.worker",      # start of a pool worker's batch load
    "device_feed.put",        # start of DeviceFeed's device staging
    # gradient aggregation
    "kvstore.push",
    "kvstore.pull",
    # serving
    "serving.predict",        # before a served model or decode step runs
    # fleet routing (serving/fleet.py): before the router hands one attempt
    # to the chosen replica.  A "crash" here models the REPLICA's death as
    # observed by the router — the router is the surviving process, so it
    # (exceptionally) catches SimulatedCrash at this one site, marks the
    # replica DEAD, and fails the request over; see FleetRouter.predict.
    "fleet.replica",
    # rolling deployment (serving/deploy.py): the controller's swap
    # pipeline.  A "crash" at any of these models the CONTROLLER dying
    # mid-swap; the fleet must keep serving the old generation.
    "deploy.resolve",         # before loading the resolved checkpoint
    "deploy.warmup",          # before staging one (name, replica) copy
    "deploy.cutover",         # before fencing the old placements
    "deploy.commit",          # before the atomic routing flip
})


class InjectedFault(MXNetError):
    """Base class of every injected failure (except SimulatedCrash)."""


class TransientFault(InjectedFault):
    """A retryable injected failure (flaky transfer, worker blip)."""


class FatalFault(InjectedFault):
    """A non-retryable injected failure (persistent backend breakage)."""


class SimulatedCrash(BaseException):
    """Models process death (``kill -9``) at a fault point.

    Deliberately a ``BaseException``: recovery code written as
    ``except Exception`` must not be able to swallow a crash — after a real
    SIGKILL there is nobody left to run the handler.  Only the chaos harness
    (which plays the role of the *next* process) catches it — plus one
    documented exception: at the ``fleet.replica`` site the crash models a
    *replica's* death and the FleetRouter is the surviving observer, so the
    router catches it there and converts it into replica-death handling.
    """


class FaultRule:
    """One (site pattern, kind, probability, window) injection rule.

    ``site`` is an exact site name or a ``"prefix.*"`` glob.  The rule fires
    on hits ``after <= hit_index`` (per matching site, 0-based), each with
    probability ``p``, at most ``times`` times total (None = unlimited).
    """

    __slots__ = ("site", "kind", "p", "after", "times", "fired")

    _KINDS = ("transient", "fatal", "crash", "truncate")

    def __init__(self, site, kind="transient", p=1.0, after=0, times=None):
        if kind not in self._KINDS:
            raise ValueError("unknown fault kind %r (one of %s)"
                             % (kind, "/".join(self._KINDS)))
        if not (site.endswith(".*") or site in KNOWN_SITES):
            raise ValueError("unknown fault site %r; known: %s"
                             % (site, ", ".join(sorted(KNOWN_SITES))))
        self.site = site
        self.kind = kind
        self.p = float(p)
        self.after = int(after)
        self.times = times if times is None else int(times)
        self.fired = 0

    def matches(self, site):
        if self.site.endswith(".*"):
            return site.startswith(self.site[:-1])
        return site == self.site

    def __repr__(self):
        return ("FaultRule(site=%r, kind=%r, p=%g, after=%d, times=%r, "
                "fired=%d)" % (self.site, self.kind, self.p, self.after,
                               self.times, self.fired))


class FaultPlan:
    """A seeded, thread-safe set of fault rules plus hit/fire accounting.

    ``hits`` counts every ``fault_point`` pass per site while the plan is
    active (fired or not) — the crash sweeps use it to enumerate kill
    points; ``fired`` counts injections actually delivered.
    """

    def __init__(self, seed=0, rules=()):
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._rules = []
        self.hits = {}      # site -> fault_point passes (guarded by _lock)
        self.fired = {}     # site -> injections delivered (guarded by _lock)
        for r in rules:
            self.add(**r) if isinstance(r, dict) else self.add_rule(r)

    def add(self, site, kind="transient", p=1.0, after=0, times=None):
        """Append a rule (see :class:`FaultRule`); returns self for chaining."""
        return self.add_rule(FaultRule(site, kind=kind, p=p, after=after,
                                       times=times))

    def add_rule(self, rule):
        with self._lock:
            self._rules.append(rule)
        return self

    def hit_count(self, site_prefix=""):
        """Total ``fault_point`` passes for sites matching the prefix."""
        with self._lock:
            return sum(n for s, n in self.hits.items()
                       if s.startswith(site_prefix))

    def fired_count(self, site_prefix=""):
        with self._lock:
            return sum(n for s, n in self.fired.items()
                       if s.startswith(site_prefix))

    def consult(self, site):
        """Record a hit; return the kind to inject at this pass (or None).

        The first matching rule whose window and probability admit the hit
        wins; its ``fired`` counter and the plan's ``fired`` tally bump.
        """
        with self._lock:
            index = self.hits.get(site, 0)
            self.hits[site] = index + 1
            for rule in self._rules:
                if not rule.matches(site) or index < rule.after:
                    continue
                if rule.times is not None and rule.fired >= rule.times:
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                rule.fired += 1
                self.fired[site] = self.fired.get(site, 0) + 1
                return rule.kind
        return None

    def truncate_offset(self, written):
        """Seeded torn-write offset in [0, written) for a truncate fault."""
        with self._lock:
            return self._rng.randrange(max(1, written))


# the active plan is process-global: fault points run on worker threads
# (serving batchers, DeviceFeed producers, pool workers) that must see the
# plan the test thread installed.  Reads are a single atomic ref load;
# writes go through _ACTIVE_LOCK.
_ACTIVE_LOCK = threading.Lock()
_ACTIVE = None


def active_plan():
    """The currently installed FaultPlan, or None."""
    return _ACTIVE


@contextlib.contextmanager
def plan(fault_plan):
    """Install ``fault_plan`` for the scope (all threads); restores on exit."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, fault_plan
    try:
        yield fault_plan
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = prev


def fault_point(site, **info):
    """Declare a named injection site.  No-op without an active plan.

    ``info`` is site-specific context; file sites pass ``fileobj`` and
    ``written`` so truncate faults can tear the in-progress file at a
    seeded byte offset.
    """
    active = _ACTIVE
    if active is None:
        return
    if site not in KNOWN_SITES:
        raise ValueError("fault_point(%r): unregistered site; add it to "
                         "faults.KNOWN_SITES" % site)
    kind = active.consult(site)
    if kind is None:
        return
    if kind == "transient":
        raise TransientFault("injected transient fault at %s" % site)
    if kind == "fatal":
        raise FatalFault("injected fatal fault at %s" % site)
    if kind == "truncate":
        fobj = info.get("fileobj")
        written = int(info.get("written", 0))
        if fobj is not None and written > 0:
            off = active.truncate_offset(written)
            fobj.flush()
            fobj.truncate(off)
        raise SimulatedCrash("injected torn write + crash at %s" % site)
    raise SimulatedCrash("injected crash at %s" % site)


def is_retryable(exc):
    """Is this exception in the retry-absorbable class?

    Transient injected faults are; fatal faults, simulated crashes, and
    ordinary exceptions are not (callers opt real exception types into
    retry explicitly via ``util.retry(retryable=...)``).
    """
    return isinstance(exc, TransientFault)
