"""mxnet_tpu_torch.serving.deploy against the JAX package's, on the CPU.

tests/test_deploy.py's model and engines, the weight generations written
by the port's ``model.save_checkpoint`` (its manifest is held to the JAX
package's in tests/test_torch_checkpoint.py), the JAX engines' greedy
streams as references: the full swap is bitwise and idempotent, a stream
in flight across it finishes on its own generation, an ``slo_probe``
rollback restores generation 1 bitwise, the controller killed at each
``deploy.*`` fault point leaves generation 1 serving and a fresh
controller recovers and redeploys, a replica killed mid-swap aborts the
swap, a torn newest checkpoint is not a candidate (for either package's
reader), a generation published mid-swap queues, a wedged rebalance is
named, and the deploy counters reach the profiler.
"""
import json
import threading
import time

import pytest

from mxnet_tpu import model as jmodel
from mxnet_tpu.serving.decode import DecodeEngine as JEngine
from mxnet_tpu.serving.decode import TinyCausalLM as JModel
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, faults, profiler, serving
from mxnet_tpu_torch import model as model_io
from mxnet_tpu_torch.serving import deploy
from mxnet_tpu_torch.serving.decode import DecodeEngine, TinyCausalLM
from mxnet_tpu_torch.serving.fleet import FleetRouter

MODEL_KW = dict(vocab_size=20, hidden=16, num_layers=1, num_heads=2,
                max_len=24)
ENGINE_KW = dict(max_slots=2, block_size=4, num_blocks=12,
                 max_prompt_len=4, max_new_tokens=5, max_queue=8,
                 width_blocks=[4])
PROMPT = [3, 1, 2]
SEED_A, SEED_B = 7, 99


# ---------------------------------------------------------------------------
# the deployment controller
# ---------------------------------------------------------------------------

def _save_gen(prefix, epoch, seed):
    """Publish one TinyCausalLM weight generation (the port's writer)."""
    lm = TinyCausalLM(seed=seed, device="cpu", **MODEL_KW)
    model_io.save_checkpoint(prefix, epoch, mx.sym.var("data"),
                             lm.param_dict(), {})


def _build(srv_name, arg_params, aux_params, generation):
    return DecodeEngine(TinyCausalLM(params=arg_params, device="cpu",
                                     **MODEL_KW),
                        name=srv_name, generation=generation, **ENGINE_KW)


def _baseline(name):
    return DecodeEngine(TinyCausalLM(seed=SEED_A, device="cpu", **MODEL_KW),
                        name=name, **ENGINE_KW)


def _controller(router, prefix, **kw):
    return deploy.DeploymentController(router, prefix,
                                       engines={"lm": kw.pop("build",
                                                             _build)},
                                       ctx="cpu", **kw)


@pytest.fixture(scope="module")
def refs():
    """The JAX engines' greedy streams, one per weight generation."""
    out = {}
    for seed in (SEED_A, SEED_B):
        eng = JEngine(JModel(seed=seed, **MODEL_KW), name="jref%d" % seed,
                      **ENGINE_KW)
        try:
            out[seed] = eng.generate_reference(PROMPT, 5).tolist()
        finally:
            eng.stop()
    assert out[SEED_A] != out[SEED_B]
    return out


def _fresh_fleet(prefix, replicas=2):
    """A live fleet on generation 1 (seed A), rolled in so every engine
    carries the tag."""
    _save_gen(prefix, 1, SEED_A)
    router = FleetRouter(replicas=replicas, failover_budget=2)
    router.load_decode("lm", _baseline, replicas=replicas)
    ctl = _controller(router, prefix)
    rep = ctl.poll()
    assert rep["status"] == "deployed" and rep["generation"] == 1
    return router, ctl


def _tokens(router, **kw):
    s = router.submit_stream("lm", PROMPT, max_new_tokens=5, **kw)
    assert s.wait(15.0), "stream hung"
    assert s.status == serving.OK, (s.status, s.error)
    return s.tokens()


def test_full_swap_is_bitwise_and_idempotent(tmp_path, refs):
    prefix = str(tmp_path / "ck")
    router, ctl = _fresh_fleet(prefix)
    with router:
        assert _tokens(router) == refs[SEED_A]
        _save_gen(prefix, 2, SEED_B)
        rep = ctl.poll()
        assert rep["status"] == "deployed" and rep["generation"] == 2
        assert rep["previous"] == 1
        placed = router.stats()["decode_models"]["lm"]["placement"]
        assert set(rep["warmup_compiles"]) == {"lm@%s" % r for r in placed}
        assert all(c > 0 for c in rep["warmup_compiles"].values())
        assert _tokens(router) == refs[SEED_B]
        assert ctl.poll() is None
        st = router.stats()["deploy"]
        assert st["generation"] == 2 and st["previous"] == 1
        assert st["in_progress"] is None and st["retiring"] == 0
        for rid, snap in router.stats()["engines"]["lm"].items():
            assert snap["generation"] == 2, rid
            assert snap["cache"]["recompiles"] == \
                snap["warmup"]["cache"]["misses"], rid
        assert ctl.stats()["deploys"] == 2


def test_mid_swap_stream_finishes_on_its_own_generation(tmp_path, refs):
    prefix = str(tmp_path / "ck")
    router, ctl = _fresh_fleet(prefix)
    with router:
        _save_gen(prefix, 2, SEED_B)
        slow = lambda t: time.sleep(0.01)  # noqa: E731
        pre = router.submit_stream("lm", PROMPT, max_new_tokens=5,
                                   on_token=slow)
        rep = ctl.poll()
        assert rep["status"] == "deployed" and rep["generation"] == 2
        assert pre.wait(20.0)
        assert pre.status == serving.OK and pre.tokens() == refs[SEED_A]
        assert _tokens(router) == refs[SEED_B]


def test_slo_probe_rollback_restores_generation_1_bitwise(tmp_path, refs):
    prefix = str(tmp_path / "ck")
    router, ctl = _fresh_fleet(prefix)
    with router:
        _save_gen(prefix, 2, SEED_B)
        bad = _controller(router, prefix,
                          slo_probe=lambda r: "ttft regression (planted)")
        rep = bad.poll()
        assert rep["status"] == "rolled_back"
        assert "planted" in rep["rollback_reason"]
        st = router.stats()["deploy"]
        assert st["generation"] == 1
        assert st["last_rollback"] == {"generation": 2,
                                       "reason": "ttft regression "
                                                 "(planted)"}
        assert router.health() == serving.HEALTHY
        assert _tokens(router) == refs[SEED_A]
        assert bad.poll()["status"] == "rolled_back"
        assert bad.stats()["rollbacks"] == 2


@pytest.mark.parametrize("site", ["deploy.resolve", "deploy.warmup",
                                  "deploy.cutover", "deploy.commit"])
def test_controller_killed_at_a_fault_point_leaves_generation_1(
        tmp_path, refs, site):
    prefix = str(tmp_path / "ck")
    router, ctl = _fresh_fleet(prefix)
    with router:
        _save_gen(prefix, 2, SEED_B)
        plan = faults.FaultPlan(0).add(site, kind="crash", times=1)
        with faults.plan(plan):
            with pytest.raises(faults.SimulatedCrash):
                ctl.poll()
        assert plan.fired_count(site) == 1
        ctl2 = _controller(router, prefix)
        rec = ctl2.recover()
        assert rec["generation"] == 1, (site, rec)
        assert router.health() == serving.HEALTHY, site
        st = router.stats()["deploy"]
        assert st["generation"] == 1 and st["in_progress"] is None \
            and st["retiring"] == 0, (site, st)
        assert _tokens(router) == refs[SEED_A], site
        rep = ctl2.poll()
        assert rep["status"] == "deployed" and rep["generation"] == 2, site
        assert _tokens(router) == refs[SEED_B], site


def test_replica_killed_mid_swap_aborts_it(tmp_path, refs, monkeypatch):
    prefix = str(tmp_path / "ck")
    router, ctl = _fresh_fleet(prefix)
    with router:
        _save_gen(prefix, 2, SEED_B)
        warmups = []
        real = faults.fault_point

        def chaos(site, **info):
            if site == "deploy.warmup":
                warmups.append(info)
                if len(warmups) == 2:
                    router.kill_replica(info["rid"])
            return real(site, **info)

        monkeypatch.setattr(faults, "fault_point", chaos)
        with pytest.raises(MXNetError, match="died mid-swap"):
            ctl.poll()
        monkeypatch.setattr(faults, "fault_point", real)
        ctl2 = _controller(router, prefix)
        ctl2.recover()
        assert router.stats()["deploy"]["generation"] == 1
        assert _tokens(router) == refs[SEED_A]
        router.add_replica()
        assert router.wait_converged(timeout_s=10.0)
        rep = ctl2.poll()
        assert rep["status"] == "deployed" and rep["generation"] == 2
        assert _tokens(router) == refs[SEED_B]


def test_torn_newest_checkpoint_is_not_a_candidate(tmp_path, refs):
    prefix = str(tmp_path / "ck")
    router, ctl = _fresh_fleet(prefix)
    with router:
        _save_gen(prefix, 2, SEED_B)
        with open("%s-0002.params" % prefix, "r+b") as f:
            f.seek(10)
            f.write(b"\xff\xff\xff\xff")
        assert model_io.latest_complete_checkpoint(prefix) == 1
        assert jmodel.latest_complete_checkpoint(prefix) == 1
        assert ctl.poll() is None
        assert _tokens(router) == refs[SEED_A]
        _save_gen(prefix, 3, SEED_B)
        rep = ctl.poll()
        assert rep["status"] == "deployed" and rep["generation"] == 3
        assert _tokens(router) == refs[SEED_B]


def test_generation_published_mid_swap_queues(tmp_path, refs):
    prefix = str(tmp_path / "ck")
    router, _ = _fresh_fleet(prefix)
    staging = threading.Event()

    def slow_build(srv_name, arg_params, aux_params, generation):
        staging.set()
        time.sleep(0.15)
        return _build(srv_name, arg_params, aux_params, generation)

    slow = _controller(router, prefix, build=slow_build)
    with router:
        _save_gen(prefix, 2, SEED_B)
        first = threading.Thread(target=slow.deploy, args=(2,))
        first.start()
        assert staging.wait(10.0)
        _save_gen(prefix, 3, SEED_A)
        rep = slow.poll()           # blocks until generation 2 commits
        first.join(30.0)
        assert rep["status"] == "deployed" and rep["generation"] == 3
        assert rep["previous"] == 2
        assert [(h["previous"], h["generation"])
                for h in slow.stats()["history"]] == [(1, 2), (2, 3)]
        assert _tokens(router) == refs[SEED_A]


def test_wait_converged_names_a_wedged_rebalance():
    built = []
    wedged, release = threading.Event(), threading.Event()

    def factory(name):
        built.append(name)
        if len(built) > 2:
            wedged.set()
            release.wait(20.0)
        return _baseline(name)

    router = FleetRouter(replicas=2, failover_budget=2)
    with router:
        router.load_decode("lm", factory, replicas=2)
        assert router.wait_converged(timeout_s=10.0) is True
        rid = router.stats()["decode_models"]["lm"]["placement"][0]
        router.kill_replica(rid)
        joiner = threading.Thread(target=router.add_replica)
        joiner.start()
        try:
            assert wedged.wait(10.0)
            assert router.wait_converged(timeout_s=0.2) is False
            with pytest.raises(MXNetError,
                               match=r"decode 'lm': 1/2 routable"):
                router.wait_converged(timeout_s=0.2,
                                      reason_on_timeout=True)
        finally:
            release.set()
            joiner.join(20.0)
        assert router.wait_converged(timeout_s=10.0) is True


def test_deploy_counters_in_the_profiler_dump(tmp_path, refs):
    prefix = str(tmp_path / "ck")
    trace = str(tmp_path / "deploy_profile.json")
    profiler.set_config(filename=trace)
    profiler.set_state("run")
    try:
        router, ctl = _fresh_fleet(prefix)
        with router:
            _save_gen(prefix, 2, SEED_B)
            assert ctl.poll()["status"] == "deployed"
            _save_gen(prefix, 3, SEED_A)
            veto = _controller(router, prefix,
                               slo_probe=lambda r: "planted regression")
            assert veto.poll()["status"] == "rolled_back"
    finally:
        profiler.set_state("stop")
        profiler.dump()
    counters = {e["name"] for e in json.load(open(trace))["traceEvents"]
                if e.get("ph") == "C"}
    for name in ("deploy:generation", "deploy:swap_ms", "deploy:rollbacks"):
        assert name in counters, (name, counters)
