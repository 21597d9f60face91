"""Lease-based membership (counterpart of ``mxnet_tpu/kvstore_server.py``
:46-218: ``LeaseExpired``, ``UnknownWorker``, ``Lease`` and
``MembershipTable``).

Members ``register()`` for a TTL lease and ``heartbeat()`` to renew it; a
missed lease marks the member dead and fences its lease generation, so
late traffic from the old incarnation cannot land.  Every (re-)register
bumps the generation: the fencing token that tells a fresh incarnation
from a zombie.  The serving fleet (``serving/fleet.py``) keeps one table
of its replicas: a drain, a kill or a weight swap bumps a replica's
generation, and a stream is re-owned only through a current one.

``KVStoreServer`` (:219), the membership gateway in front of a kvstore,
waits for the port of ``kvstore.py`` (ROADMAP queue 1 #8).
"""
from __future__ import annotations

import threading
import time

from .base import MXNetError

__all__ = ["Lease", "LeaseExpired", "UnknownWorker", "MembershipTable"]


class LeaseExpired(MXNetError):
    """The worker's lease lapsed: heartbeats stopped for longer than the
    TTL, so the worker is presumed preempted and fenced.  Retryable — but
    only *after* the worker re-registers (new lease generation) and
    resumes from the last complete checkpoint (``fit(auto_resume=True)``);
    blindly retrying the same push would reintroduce the fenced update."""


class UnknownWorker(MXNetError):
    """Membership traffic from a worker id that never registered."""


class Lease:
    """One granted lease.  ``generation`` increments on every (re-)register
    of the same worker id — the fencing token that tells a fresh incarnation
    from a zombie of the preempted one."""

    __slots__ = ("worker_id", "generation", "expires_at")

    def __init__(self, worker_id, generation, expires_at):
        self.worker_id = worker_id
        self.generation = generation
        self.expires_at = expires_at

    def __repr__(self):
        return ("Lease(worker_id=%r, generation=%d, expires_at=%.3f)"
                % (self.worker_id, self.generation, self.expires_at))


class MembershipTable:
    """worker_id -> lease, with TTL expiry and generation fencing.

    Thread-safe: one lock guards every field (registrations arrive on
    worker threads, sweeps on the server loop).  The lock is reentrant
    because the public entry points hold it across the shared
    check/evict helpers.  The clock is injectable so expiry is testable
    without real sleeps."""

    def __init__(self, lease_ttl_s=10.0, clock=time.monotonic):
        if lease_ttl_s <= 0:
            raise ValueError("lease_ttl_s must be > 0")
        self._lock = threading.RLock()
        self._ttl = float(lease_ttl_s)
        self._clock = clock
        self._leases = {}        # worker_id -> Lease (live members)
        self._generations = {}   # worker_id -> last generation ever granted
        self._dead = {}          # worker_id -> generation at eviction
        self._evictions = 0      # lifetime expired-lease evictions

    # -- worker-facing ---------------------------------------------------
    def register(self, worker_id):
        """Grant (or re-grant) a lease; returns the :class:`Lease`.

        Registering is how a preempted worker rejoins: its dead entry is
        cleared and the generation bumps past every lease it ever held."""
        with self._lock:
            gen = self._generations.get(worker_id, 0) + 1
            self._generations[worker_id] = gen
            self._dead.pop(worker_id, None)
            lease = Lease(worker_id, gen, self._clock() + self._ttl)
            self._leases[worker_id] = lease
            return lease

    def heartbeat(self, worker_id):
        """Renew the lease; returns the new expiry.  Raises
        :class:`UnknownWorker` (never registered) or :class:`LeaseExpired`
        (missed the TTL — the worker is already fenced and must
        re-register)."""
        with self._lock:
            self._check_locked(worker_id)
            lease = self._leases[worker_id]
            lease.expires_at = self._clock() + self._ttl
            return lease.expires_at

    def check(self, worker_id):
        """Gate one membership-checked operation (push/pull): raises like
        ``heartbeat`` but does NOT renew — liveness is the heartbeat's
        job, not a side effect of traffic."""
        with self._lock:
            self._check_locked(worker_id)

    def _check_locked(self, worker_id):
        with self._lock:   # reentrant: callers already hold it
            lease = self._leases.get(worker_id)
            if lease is None:
                if worker_id in self._dead:
                    raise LeaseExpired(
                        "worker %r lease (generation %d) expired; "
                        "re-register and resume from the last complete "
                        "checkpoint" % (worker_id, self._dead[worker_id]))
                raise UnknownWorker("worker %r never registered; known: %s"
                                    % (worker_id,
                                       sorted(self._generations) or "none"))
            if self._clock() > lease.expires_at:
                self._evict_locked(worker_id, lease)
                raise LeaseExpired(
                    "worker %r lease (generation %d) expired; re-register "
                    "and resume from the last complete checkpoint"
                    % (worker_id, lease.generation))

    def generation(self, worker_id):
        """Latest generation ever granted to ``worker_id`` (live or dead).
        Raises :class:`UnknownWorker` if the id never registered."""
        with self._lock:
            gen = self._generations.get(worker_id)
            if gen is None:
                raise UnknownWorker("worker %r never registered; known: %s"
                                    % (worker_id,
                                       sorted(self._generations) or "none"))
            return gen

    def check_generation(self, worker_id, generation):
        """Fence one operation on a *generation* token: raises
        :class:`LeaseExpired` when ``generation`` is older than the latest
        granted for ``worker_id`` (a zombie incarnation presenting a stale
        fencing token), :class:`UnknownWorker` when the id never
        registered.  Compares generations ONLY — TTL liveness stays
        ``check()``'s job, so a drained-but-alive holder of the *current*
        generation still passes."""
        with self._lock:
            current = self.generation(worker_id)   # reentrant
            if generation < current:
                raise LeaseExpired(
                    "worker %r generation %d is stale (current %d); the "
                    "holder was fenced — re-register before emitting"
                    % (worker_id, generation, current))

    # -- server-facing ---------------------------------------------------
    def sweep(self):
        """Evict every expired lease; returns the evicted worker ids."""
        with self._lock:
            now = self._clock()
            expired = [wid for wid, lease in self._leases.items()
                       if now > lease.expires_at]
            for wid in expired:
                self._evict_locked(wid, self._leases[wid])
            return expired

    def _evict_locked(self, worker_id, lease):
        with self._lock:   # reentrant: callers already hold it
            del self._leases[worker_id]
            self._dead[worker_id] = lease.generation
            self._evictions += 1

    # -- observability ---------------------------------------------------
    def is_alive(self, worker_id):
        with self._lock:
            lease = self._leases.get(worker_id)
            return lease is not None and self._clock() <= lease.expires_at

    def alive(self):
        with self._lock:
            now = self._clock()
            return sorted(wid for wid, lease in self._leases.items()
                          if now <= lease.expires_at)

    def dead(self):
        with self._lock:
            return sorted(self._dead)

    def snapshot(self):
        with self._lock:
            now = self._clock()
            return {
                "alive": sorted(wid for wid, lease in self._leases.items()
                                if now <= lease.expires_at),
                "dead": sorted(self._dead),
                "generations": dict(self._generations),
                "evictions": self._evictions,
                "lease_ttl_s": self._ttl,
            }
