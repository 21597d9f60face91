"""Zero-downtime continuous deployment: generation-fenced live weight swap.

The :class:`DeploymentController` closes the train->serve loop the north
star leaves open: a trainer keeps publishing manifest-committed checkpoints
(``model.do_checkpoint`` + the PR-5 manifest), and a live
:class:`~mxnet_tpu_torch.serving.fleet.FleetRouter` picks each one up WITHOUT
dropping a stream, recompiling in steady state, or ever serving a torn mix
of weight generations.

The swap protocol (four phases, each a named fault point so a fault plan
can kill the controller anywhere)::

    resolve   latest_complete_checkpoint() names the target epoch; the
              manifest hash-check is the torn-checkpoint gate — a crashed
              or in-progress save is simply not a candidate.
    warmup    one new-generation copy per (name, replica) builds, loads
              and warms OUTSIDE the router lock while the old generation
              keeps serving.  Warmup captures every signature of the
              bucket menu, so the swap adds no capture in steady state
              (``cache_stats()``/``capture_stats()`` show it).
    cutover   fence_swap(): every staged replica's lease generation bumps
              (kvstore MembershipTable).  In-flight streams keep their
              per-stream owner tokens and keep emitting on the old
              copies; the old generation just lost the power to re-own
              or import anything new.
    commit    commit_swap(): ONE atomic routing flip under the router
              lock — no server/engine call, no fault point inside.  A
              kill anywhere before it leaves the fleet entirely on the
              old generation; after it, entirely on the new one.

After commit the controller canaries the fleet for ``canary_s``: health
off HEALTHY or an ``slo_probe`` complaint triggers ``rollback_swap`` (the
flip runs backwards; old copies were never torn down) and the bad
generation retires instead.  Otherwise ``retire_swap`` drains the old
copies — their still-running streams fenced-handoff onto one surviving
old-generation sink, so every stream finishes against the single weight
generation it started on (docs/CONCURRENCY.md invariant 13).

Controller deploys serialize on one lock: a generation published mid-swap
queues behind the running swap, it never interleaves.

    controller = deploy.DeploymentController(
        router, "/ckpt/run", engines={"chat": build_engine})
    controller.start()          # background watcher; or poll() manually

Counterpart of ``mxnet_tpu/serving/deploy.py``.  The checkpoints are the
manifest-committed ones that either package's ``model.save_checkpoint``
writes (the manifest is byte for byte the same), and the builders get the
generation's arrays as NDArrays on ``ctx`` (default the current context,
``cuda:0``; pass ``ctx="cpu"`` to deploy on the CPU).  On one card the new
generation's engines warm (capture their CUDA graphs) while the old ones
keep replaying theirs.
"""
from __future__ import annotations

import threading
import time

from .. import faults
from .. import profiler
from ..base import MXNetError
from ..model import latest_complete_checkpoint, load_checkpoint
from .health import HEALTHY

__all__ = ["DeploymentController"]


class DeploymentController:
    """Watches a checkpoint prefix and rolls each newly complete epoch
    across a live fleet with generation fencing and health-gated rollback.

    Parameters
    ----------
    router : FleetRouter
        The live fleet.  The controller only uses the public swap API
        (begin/stage/fence/commit/rollback/abort/retire).
    prefix : str
        Checkpoint prefix the trainer publishes under (the
        ``do_checkpoint`` prefix; completeness comes from the manifest).
    engines : dict, optional
        ``{fleet_name: build}`` for decode engines, where
        ``build(srv_name, arg_params, aux_params, generation)`` returns a
        WARMED :class:`~mxnet_tpu_torch.serving.decode.engine.DecodeEngine`
        named ``srv_name`` carrying the new generation's weights.
    models : dict, optional
        ``{fleet_name: build}`` for batch models, where
        ``build(arg_params, aux_params, generation)`` returns a block;
        the router loads + warms it under the fleet spec's kwargs.
    allow_unverified : bool
        Passed to :func:`latest_complete_checkpoint` — opt into legacy
        prefixes with no manifest (best-effort parse check only).
    ctx : device, optional
        Where the generation's arrays load (``model.load_checkpoint``);
        default the current context.
    canary_s : float
        Post-commit observation window before the swap is final.  Health
        off HEALTHY or a truthy ``slo_probe(router)`` return anywhere in
        the window rolls the fleet back to the previous generation.
    slo_probe : callable, optional
        ``slo_probe(router) -> falsy | reason-string``; called repeatedly
        during the canary window.
    """

    def __init__(self, router, prefix, engines=None, models=None,
                 allow_unverified=False, poll_interval_s=0.2,
                 canary_s=0.0, canary_interval_s=0.02, slo_probe=None,
                 retire_timeout_s=10.0, ctx=None):
        if not engines and not models:
            raise MXNetError("DeploymentController needs at least one "
                             "engine or model builder")
        self.router = router
        self.prefix = prefix
        self.allow_unverified = bool(allow_unverified)
        self.poll_interval_s = float(poll_interval_s)
        self.canary_s = float(canary_s)
        self.canary_interval_s = float(canary_interval_s)
        self.slo_probe = slo_probe
        self.retire_timeout_s = float(retire_timeout_s)
        self.ctx = ctx
        self._engine_builders = dict(engines or {})
        self._model_builders = dict(models or {})
        # one swap at a time: a generation published mid-swap waits here
        # (queued), it never interleaves with the running swap
        self._swap_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._rollbacks = 0
        self._deploys = 0
        self._history = []
        self._last_error = None
        self._stop = threading.Event()
        self._thread = None
        # a fresh controller (e.g. restarted after a crash) inherits the
        # fleet's committed generation rather than assuming None
        self._generation = router.stats()["deploy"]["generation"]
        domain = profiler.Domain("serving")
        self._c_generation = domain.new_counter("deploy:generation")
        self._c_swap_ms = domain.new_counter("deploy:swap_ms")
        self._c_rollbacks = domain.new_counter("deploy:rollbacks")

    # -- watcher ----------------------------------------------------------
    def start(self):
        """Background watcher: poll() every ``poll_interval_s``."""
        with self._state_lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(target=self._watch,
                                            name="deploy-watcher",
                                            daemon=True)
            self._thread.start()

    def stop(self):
        with self._state_lock:
            self._stop.set()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=30.0)

    def _watch(self):
        with self._state_lock:
            stop = self._stop
        while not stop.wait(self.poll_interval_s):
            try:
                self.poll()
            except faults.SimulatedCrash:
                raise           # chaos kill: the controller thread dies
            except MXNetError as exc:
                with self._state_lock:
                    self._last_error = str(exc)

    # -- one deployment step ----------------------------------------------
    def poll(self):
        """One step: resolve the newest complete checkpoint; deploy it if
        it is newer than what the fleet serves.  Returns the deploy
        report, or None when there is nothing new."""
        epoch = latest_complete_checkpoint(
            self.prefix, allow_unverified=self.allow_unverified)
        if epoch is None:
            return None
        with self._state_lock:
            current = self._generation
        if current is not None and epoch <= current:
            return None
        return self.deploy(epoch)

    def deploy(self, epoch):
        """Roll weight generation ``epoch`` across the fleet.

        Returns a report dict (``status`` is ``"deployed"`` or
        ``"rolled_back"``).  A :class:`~mxnet_tpu_torch.faults.SimulatedCrash`
        at any fault point propagates — that IS the controller dying; a
        restarted controller calls :meth:`recover` and the fleet is found
        serving one consistent generation.  Any other failure before
        commit aborts the staging and re-raises; the fleet never left the
        old generation."""
        with self._swap_lock:
            return self._deploy_locked(epoch)

    def _deploy_locked(self, epoch):
        with self._state_lock:
            if self._generation is not None and epoch == self._generation:
                return None
        t0 = time.monotonic()
        faults.fault_point("deploy.resolve", prefix=self.prefix,
                           epoch=epoch)
        # torn-checkpoint gate: a manifest-complete epoch loads or the
        # deploy fails here with nothing staged and nothing changed
        _sym, arg_params, aux_params = load_checkpoint(self.prefix, epoch,
                                                       ctx=self.ctx)
        self.router.begin_swap(epoch)
        report = {"generation": epoch, "status": None,
                  "staged_engines": [], "staged_models": [],
                  "warmup_compiles": {}, "handoffs": 0, "fenced": 0,
                  "swap_ms": None, "rollback_reason": None}
        with self._state_lock:
            report["previous"] = self._generation
        try:
            placements = self.router.stats()
            for name in sorted(self._engine_builders):
                build = self._engine_builders[name]
                placed = placements["decode_models"].get(name, {}) \
                    .get("placement", [])
                if not placed:
                    raise MXNetError("decode engine %r has no routable "
                                     "placement to swap" % (name,))
                for rid in placed:
                    faults.fault_point("deploy.warmup", name=name,
                                       rid=rid, epoch=epoch)
                    eng = self.router.stage_decode(
                        name, rid,
                        lambda srv_name, _b=build: _b(
                            srv_name, arg_params, aux_params, epoch))
                    wr = getattr(eng, "warmup_report", None) or {}
                    report["warmup_compiles"]["%s@%s" % (name, rid)] = \
                        wr.get("compiles")
                    report["staged_engines"].append((name, rid))
            for name in sorted(self._model_builders):
                build = self._model_builders[name]
                placed = placements["models"].get(name, {}) \
                    .get("placement", [])
                if not placed:
                    raise MXNetError("model %r has no routable placement "
                                     "to swap" % (name,))
                for rid in placed:
                    faults.fault_point("deploy.warmup", name=name,
                                       rid=rid, epoch=epoch)
                    block = build(arg_params, aux_params, epoch)
                    self.router.stage_model(name, rid, block)
                    report["staged_models"].append((name, rid))
            faults.fault_point("deploy.cutover", epoch=epoch)
            self.router.fence_swap()
            faults.fault_point("deploy.commit", epoch=epoch)
            self.router.commit_swap()
        except faults.SimulatedCrash:
            raise               # controller death; recover() cleans up
        except BaseException:
            self.router.abort_swap()
            raise
        # committed.  Canary window: any regression flips it back.
        reason = self._canary()
        if reason is not None:
            self.router.rollback_swap(reason)
            retired = self.router.retire_swap(
                timeout_s=self.retire_timeout_s)
            report.update(status="rolled_back", rollback_reason=reason,
                          handoffs=retired["handoffs"],
                          fenced=retired["fenced"])
            with self._state_lock:
                self._rollbacks += 1
                rollbacks = self._rollbacks
                self._history.append(report)
            if profiler.profiling_active():
                self._c_rollbacks.set_value(rollbacks)
            return report
        retired = self.router.retire_swap(timeout_s=self.retire_timeout_s)
        swap_ms = (time.monotonic() - t0) * 1e3
        report.update(status="deployed", swap_ms=swap_ms,
                      handoffs=retired["handoffs"],
                      fenced=retired["fenced"])
        with self._state_lock:
            self._generation = epoch
            self._deploys += 1
            self._history.append(report)
        if profiler.profiling_active():
            self._c_generation.set_value(epoch)
            self._c_swap_ms.set_value(swap_ms)
        return report

    def _canary(self):
        """Watch the fleet for ``canary_s`` after commit.  Returns a
        rollback reason, or None when the new generation holds."""
        deadline = time.monotonic() + self.canary_s
        while True:
            health = self.router.health()
            if health != HEALTHY:
                return "fleet health %s during canary" % (health,)
            if self.slo_probe is not None:
                verdict = self.slo_probe(self.router)
                if verdict:
                    return str(verdict)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            time.sleep(min(self.canary_interval_s, remaining))

    # -- crash recovery ----------------------------------------------------
    def recover(self):
        """Clean up after a controller that died mid-swap.

        Pre-commit death leaves a staging area: abort it (staged copies
        tear down; routing never changed).  Post-commit death leaves
        retiring old copies: retire them (the committed generation
        stands).  Either way the fleet ends on ONE consistent
        generation, and ``self._generation`` re-syncs to it."""
        aborted = self.router.abort_swap()
        retired = self.router.retire_swap(timeout_s=self.retire_timeout_s)
        generation = self.router.stats()["deploy"]["generation"]
        with self._state_lock:
            self._generation = generation
        return {"aborted_staging": aborted, "generation": generation,
                "handoffs": retired["handoffs"],
                "fenced": retired["fenced"]}

    # -- observability -----------------------------------------------------
    def stats(self):
        with self._state_lock:
            return {"generation": self._generation,
                    "deploys": self._deploys,
                    "rollbacks": self._rollbacks,
                    "last_error": self._last_error,
                    "history": list(self._history[-8:])}
