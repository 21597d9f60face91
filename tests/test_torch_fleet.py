"""mxnet_tpu_torch.serving.fleet, traffic and the membership table against
the JAX package's, on the CPU.

* ``serving/traffic.py``: the Poisson, bursty and diurnal traces and
  ``tenant_mix`` equal the JAX package's float for float for several
  seeds, and ``replay`` fires on an injected clock as there;
* ``kvstore_server.MembershipTable``: one scripted history of registers,
  heartbeats, expiries, sweeps and generation checks on an injected clock
  gives the same leases, generations, evictions and fencing answers;
* the predict tier: the same LM (tests/test_torch_serving.py's, the JAX
  weights carried across) behind both packages' FleetRouters through one
  scripted run (a ``kill_replica``, a replica crashed at the
  ``fleet.replica`` fault site, a joining replica): answers within
  test_torch_serving.py's bound (1e-4) of the JAX fleet's, and equal
  ``FleetStats`` counts, states and placements;
* the decode tier: a drained 2-replica fleet's streams (greedy and seeded
  sampled) equal the JAX fleet's token for token; ``scaling_advice``
  equals the JAX package's in every field but the device budget, a
  deliberate divergence (the port counts CUDA devices, or the host);
* ``CircuitBreaker.reset``, ``ModelStats``' profiler counters and
  ``load_decode(tp=2)``.
"""
import json
import os
import sys
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import faults as jfaults
from mxnet_tpu import kvstore_server as jkvs
from mxnet_tpu.serving import fleet as jfleet
from mxnet_tpu.serving import health as jhealth
from mxnet_tpu.serving import traffic as jtraffic
from mxnet_tpu.serving.decode import DecodeEngine as JEngine
from mxnet_tpu.serving.decode import TinyCausalLM as JModel
from mxnet_tpu_torch import faults, kvstore_server, profiler, serving
from mxnet_tpu_torch.convert import load_mxnet_params
from mxnet_tpu_torch.models import TransformerLM
from mxnet_tpu_torch.serving import fleet, health, traffic
from mxnet_tpu_torch.serving.decode import DecodeEngine, TinyCausalLM

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "example", "gluon"))
from transformer_lm import TransformerLM as JaxLM  # noqa: E402

VOCAB, DIM, HEADS, DEPTH, MAX_LEN, T = 16, 64, 4, 2, 64, 8
LM_DTYPES = ("int32", "int32")
SERVING_BOUND = 1e-4          # tests/test_torch_serving.py
STAT_KEYS = ("requests", "ok", "timeouts", "errors", "unavailable", "shed",
             "invalid", "failovers", "replica_deaths", "rebalances")
# tests/test_decode_fleet.py's model; a pool that lets one survivor take
# every stream (6 x 3 blocks + the trash block)
DEC_MODEL = dict(vocab_size=20, hidden=16, num_layers=1, num_heads=2,
                 max_len=24, seed=13)
DEC_ENGINE = dict(max_slots=4, block_size=4, num_blocks=19,
                  max_prompt_len=4, max_new_tokens=5, max_queue=12,
                  width_blocks=[4])
SAMPLED = dict(temperature=0.8, top_k=6, top_p=0.95)


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_traces_and_tenant_mix_equal_jax(seed):
    for name, kw in (("poisson_trace", {}),
                     ("bursty_trace", dict(burst_factor=3.0,
                                           burst_fraction=0.3, n_bursts=3)),
                     ("diurnal_trace", dict(period_s=0.7, depth=0.6))):
        mine = getattr(traffic, name)(40.0, 2.0, seed=seed, **kw)
        theirs = getattr(jtraffic, name)(40.0, 2.0, seed=seed, **kw)
        assert mine == theirs and len(mine) > 20, name
    arrivals = traffic.poisson_trace(40.0, 2.0, seed=seed)
    weights = {"free": 1, "paid": 3, "batch": 0.5}
    assert traffic.tenant_mix(arrivals, weights, seed=seed) == \
        jtraffic.tenant_mix(arrivals, weights, seed=seed)


@pytest.mark.parametrize("call", [
    lambda t: t.poisson_trace(0, 1.0),
    lambda t: t.bursty_trace(5.0, 1.0, burst_factor=0.5),
    lambda t: t.bursty_trace(5.0, 1.0, burst_fraction=1.0),
    lambda t: t.diurnal_trace(5.0, 1.0, depth=1.0),
    lambda t: t.tenant_mix([0.1], {"a": 0}),
    lambda t: t.replay([0.1], lambda i, x: None, time_scale=0),
])
def test_trace_validation_matches_jax(call):
    with pytest.raises(ValueError) as mine:
        call(traffic)
    with pytest.raises(ValueError) as theirs:
        call(jtraffic)
    assert str(mine.value) == str(theirs.value)


def _replay_log(mod):
    clock = [10.0]
    log = []

    def sleep(dt):
        log.append(("sleep", round(dt, 9)))
        clock[0] += dt

    fired = mod.replay([0.0, 0.12, 0.12, 0.3], lambda i, t: log.append(
        ("submit", i, t, round(clock[0], 9))), time_scale=0.5,
        now=lambda: clock[0], sleep=sleep)
    return fired, log


def test_replay_fires_on_an_injected_clock_as_jax():
    assert _replay_log(traffic) == _replay_log(jtraffic)
    assert _replay_log(traffic)[0] == 4


# ---------------------------------------------------------------------------
# the membership table
# ---------------------------------------------------------------------------

def _membership_history(mod):
    now = [100.0]
    table = mod.MembershipTable(lease_ttl_s=5.0, clock=lambda: now[0])
    log = []

    def do(label, fn, *args):
        try:
            out = fn(*args)
            if isinstance(out, mod.Lease):
                out = (out.worker_id, out.generation, out.expires_at)
            log.append((label, args, out))
        except Exception as exc:
            log.append((label, args, type(exc).__name__, str(exc)))

    def tick(dt):
        now[0] += dt

    do("register", table.register, "a")
    do("register", table.register, "b")
    tick(3.0)
    do("heartbeat", table.heartbeat, "a")
    tick(3.0)
    do("check", table.check, "a")
    do("check", table.check, "b")           # b lapsed: evicted here
    do("sweep", table.sweep)
    do("alive", table.alive)
    do("dead", table.dead)
    do("is_alive", table.is_alive, "b")
    do("generation", table.generation, "b")
    do("check_generation", table.check_generation, "a", 1)
    do("register", table.register, "a")     # the fence bump
    do("check_generation", table.check_generation, "a", 1)
    do("check_generation", table.check_generation, "a", 2)
    do("check", table.check, "ghost")
    do("generation", table.generation, "ghost")
    do("heartbeat", table.heartbeat, "b")
    do("register", table.register, "b")     # rejoin
    tick(20.0)
    do("sweep", table.sweep)
    do("snapshot", table.snapshot)
    return log


def test_membership_history_equals_jax():
    mine = _membership_history(kvstore_server)
    theirs = _membership_history(jkvs)
    assert mine == theirs
    kinds = [entry[2] for entry in mine if len(entry) == 4]
    assert kinds.count("LeaseExpired") == 3
    assert kinds.count("UnknownWorker") == 2
    assert mine[-1][2]["evictions"] == 3
    with pytest.raises(ValueError):
        kvstore_server.MembershipTable(lease_ttl_s=0)


# ---------------------------------------------------------------------------
# the predict tier
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_pair():
    jmx.random.seed(11)
    jnet = JaxLM(VOCAB, dim=DIM, heads=HEADS, depth=DEPTH, max_len=MAX_LEN)
    jnet.initialize(jmx.init.Xavier())
    zeros = jmx.nd.array(np.zeros((1, T), np.int32), dtype="int32")
    jnet(zeros, zeros)
    tnet = TransformerLM(VOCAB, dim=DIM, heads=HEADS, depth=DEPTH,
                         max_len=MAX_LEN, device="cpu")
    load_mxnet_params(tnet, {n: p.data().asnumpy()
                             for n, p in jnet.collect_params().items()})
    return jnet, tnet


def _fleet_script(mod, pkg_faults, net, requests, **load_kw):
    """One scripted run: 2 copies on 3 replicas; two answers; a
    kill_replica; a replica crashed at the fleet.replica site under a
    request; a joining replica; two more answers."""
    router = mod.FleetRouter(replicas=3, breaker_backoff_ms=10.0)
    try:
        router.load_model("lm", net, input_shapes=[((T,), (T,))],
                          replicas=2, dtype=LM_DTYPES, max_batch=1,
                          batch_ladder=[1], linger_ms=1.0, **load_kw)
        out = [router.predict("lm", r, timeout_ms=30000)
               for r in requests[:2]]
        victim = router.stats()["models"]["lm"]["placement"][0]
        assert router.kill_replica(victim)
        assert not router.kill_replica(victim)
        assert router.wait_converged(timeout_s=60.0)
        out.append(router.predict("lm", requests[2], timeout_ms=30000))
        plan = pkg_faults.FaultPlan(0).add("fleet.replica", kind="crash",
                                           times=1)
        with pkg_faults.plan(plan):
            out.append(router.predict("lm", requests[3], timeout_ms=30000))
        assert router.wait_converged(timeout_s=60.0)
        joined = router.add_replica()
        assert router.wait_converged(timeout_s=60.0)
        out += [router.predict("lm", r, timeout_ms=30000)
                for r in requests[4:]]
        st = router.stats()
        return (out, {k: st[k] for k in STAT_KEYS}, router.replicas(),
                st["models"]["lm"]["placement"], joined,
                router.health("lm"))
    finally:
        router.stop()


def test_fleet_predicts_across_kill_and_crash_match_jax(lm_pair):
    jnet, tnet = lm_pair
    rng = np.random.RandomState(12)
    requests = [(rng.randint(0, VOCAB, T).astype(np.int32),
                 np.arange(T, dtype=np.int32)) for _ in range(6)]
    theirs = _fleet_script(jfleet, jfaults, jnet, requests)
    mine = _fleet_script(fleet, faults, tnet, requests, device="cpu")
    for a, b in zip(mine[0], theirs[0]):
        assert a.status == b.status == serving.OK, (a.error, b.error)
        assert a.output.shape == b.output.shape == (T, VOCAB)
        assert np.abs(a.output - b.output).max() <= SERVING_BOUND
    assert mine[1] == theirs[1]
    assert mine[1]["replica_deaths"] == 2 and mine[1]["failovers"] == 1
    assert mine[1]["requests"] == mine[1]["ok"] == 6
    assert mine[2] == theirs[2]            # rid -> LIVE/DEAD
    assert mine[3:] == theirs[3:]          # placement, joined rid, health
    assert list(mine[2].values()).count(fleet.DEAD) == 2


def test_drain_and_enable_route_as_jax(lm_pair):
    """A drained replica takes no new request ("draining" when nothing
    else is routable); enable() restores it."""
    _, tnet = lm_pair
    router = fleet.FleetRouter(replicas=1)
    try:
        router.load_model("lm", tnet, input_shapes=[((T,), (T,))],
                          replicas=1, dtype=LM_DTYPES, max_batch=1,
                          batch_ladder=[1], linger_ms=1.0, device="cpu")
        (rid,) = router.stats()["models"]["lm"]["placement"]
        router.drain(rid)
        req = (np.zeros(T, np.int32), np.arange(T, dtype=np.int32))
        res = router.predict("lm", req, timeout_ms=5000)
        assert res.status == serving.UNAVAILABLE and "draining" in res.error
        assert router.health("lm") == serving.health.UNAVAILABLE_HEALTH
        router.enable(rid)
        assert router.predict("lm", req, timeout_ms=5000).status == \
            serving.OK
        st = router.stats()
        assert st["requests"] == st["ok"] + st["unavailable"] == 2
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# the decode tier
# ---------------------------------------------------------------------------

def _streams_spec():
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 20, rng.randint(1, 5)).tolist()
               for _ in range(6)]
    kws = [dict(SAMPLED, seed=100 + i) if i % 3 == 2 else {}
           for i in range(6)]
    return prompts, kws


@pytest.fixture(scope="module")
def decode_fleets():
    theirs = jfleet.FleetRouter(replicas=2)
    theirs.load_decode("lm", lambda n: JEngine(JModel(**DEC_MODEL), name=n,
                                               **DEC_ENGINE), replicas=2)
    mine = fleet.FleetRouter(replicas=2)
    mine.load_decode("lm", lambda n: DecodeEngine(
        TinyCausalLM(device="cpu", **DEC_MODEL), name=n, **DEC_ENGINE),
        replicas=2)
    yield theirs, mine
    theirs.stop()
    mine.stop()


def test_scaling_advice_matches_jax_but_the_device_budget(decode_fleets):
    theirs, mine = decode_fleets
    caches = [router.engine("lm", rid)._cache for router in (theirs, mine)
              for rid in router.stats()["decode_models"]["lm"]["placement"]]
    for cache in caches:
        assert cache.reserve("pressure", 16)     # 16/18 promised: 0.89
    try:
        a, b = mine.scaling_advice(), theirs.scaling_advice()
        assert a["action"] == "scale_out"
        # the deliberate divergence: the port counts CUDA devices (the
        # host, 1, without one); the JAX tests force 8 host devices
        assert a["devices_total"] == 1 and b["devices_total"] == 8
        reason = "device budget exhausted: 2/1 devices in use"
        assert a["reasons"][-1] == reason
        assert a.pop("reasons")[:-1] == b.pop("reasons")
        a.pop("devices_total"), b.pop("devices_total")
        assert a == b
    finally:
        for cache in caches:
            cache.release("pressure")
    assert mine.scaling_advice()["action"] == "scale_in"
    with pytest.raises(NotImplementedError, match="sharding.py"):
        mine.load_decode("lm2", lambda n: None, tp=2)
    with pytest.raises(ValueError):
        mine.load_decode("lm2", lambda n: None, tp=0)


def _drained_run(router):
    prompts, kws = _streams_spec()
    placement = router.stats()["decode_models"]["lm"]["placement"]
    slow = lambda t: time.sleep(0.005)  # noqa: E731
    streams = [router.submit_stream("lm", p, max_new_tokens=5, on_token=slow,
                                    **kw) for p, kw in zip(prompts, kws)]
    router.drain(placement[0])
    for s in streams:
        assert s.wait(30), "stream hung across the drain"
    d = router.decode_stats.snapshot()
    router.enable(placement[0])
    return [(s.status, s.tokens()) for s in streams], d


def test_drained_decode_fleet_streams_equal_jax(decode_fleets):
    theirs, mine = decode_fleets
    want, jd = _drained_run(theirs)
    got, d = _drained_run(mine)
    assert got == want
    assert all(status == serving.OK for status, _ in got)
    assert d["handoffs"] >= 1 and jd["handoffs"] >= 1
    assert d["fenced"] == jd["fenced"] == 0
    assert d["requests"] == d["ok"] == 6
    # and each equals the port's own one-at-a-time reference
    ref_engine = mine.engine(
        "lm", mine.stats()["decode_models"]["lm"]["placement"][1])
    prompts, kws = _streams_spec()
    for (_, tokens), p, kw in zip(got, prompts, kws):
        assert tokens == ref_engine.generate_reference(p, 5, **kw).tolist()
    for rid in mine.stats()["decode_models"]["lm"]["placement"]:
        kv = mine.engine("lm", rid).kv_stats()
        assert kv["allocated_total"] == kv["freed_total"] and not kv["used"]


# ---------------------------------------------------------------------------
# what the fleet needs of the server parts
# ---------------------------------------------------------------------------

def _breaker_trace(mod):
    now = [0.0]
    b = mod.CircuitBreaker(failure_threshold=2, backoff_s=1.0,
                           max_backoff_s=4.0, clock=lambda: now[0])
    out = []
    for _ in range(2):
        b.on_failure()
    out.append((b.state(), b.admit(), b.health()))
    now[0] += 1.5
    out.append(b.admit())
    b.on_failure()                  # failed probe: backoff doubles
    out.append((b.state(), b.snapshot()))
    b.reset()
    out.append((b.state(), b.admit(), b.health(), b.snapshot()))
    b.on_failure()
    b.on_failure()
    now[0] += 1.5                   # the base backoff again, not 2 s
    out.append((b.state(), b.admit()))
    return out


def test_breaker_reset_matches_jax():
    assert _breaker_trace(health) == _breaker_trace(jhealth)


def test_served_model_counters_land_in_the_profiler_dump(tmp_path,
                                                         lm_pair):
    _, tnet = lm_pair
    trace = str(tmp_path / "serve_profile.json")
    server = serving.ModelServer()
    profiler.set_config(filename=trace)
    profiler.set_state("run")
    try:
        model = server.load_model(
            "lm", tnet, input_shapes=[((T,), (T,))], dtype=LM_DTYPES,
            max_batch=1, batch_ladder=[1], max_queue=1, device="cpu",
            generation=3)
        assert model.generation == 3
        req = (np.zeros(T, np.int32), np.arange(T, dtype=np.int32))
        assert server.predict("lm", req, timeout_ms=30000).status == \
            serving.OK
        server.pause("lm")
        server.predict_async("lm", req, timeout_ms=30000)   # queued
        shed = server.predict_async("lm", req, timeout_ms=30000)
        assert shed.status == serving.OVERLOADED
        server.stop()            # the queued request ends UNAVAILABLE
    finally:
        server.stop()
        profiler.set_state("stop")
        profiler.dump()
    counters = {e["name"] for e in json.load(open(trace))["traceEvents"]
                if e.get("ph") == "C"}
    for name in ("lm:queue_depth", "lm:batch_ms", "lm:shed",
                 "lm:unavailable"):
        assert name in counters, counters
