"""The decode engine's runtime modules in the port, against the JAX package.

``faults``, ``memory_accounting``, ``profiler``, the host halves of the
decode tier (``PagedKVCache``'s ledger, ``StreamSampler``) and the
``serving/stats.py`` stream helpers are host code: the same inputs must
give the same hits, bytes, blocks, tokens and rows in both packages.  The
engine's retry envelope, circuit breaker and profiler counters, and
``ModelServer``'s engine surface and ``serving.predict`` fault point, are
driven on the CPU at a tiny size.
"""
import json
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import faults as jfaults
from mxnet_tpu import memory_accounting as jmem
from mxnet_tpu.serving import server as jserver
from mxnet_tpu.serving import stats as jstats
from mxnet_tpu.serving.decode import DecodeEngine as JEngine
from mxnet_tpu.serving.decode import TinyCausalLM as JModel
from mxnet_tpu.serving.decode import kv_cache as jkv
from mxnet_tpu.serving.decode import sampling as jsampling
from mxnet_tpu_torch import MXNetError, faults, memory_accounting, profiler
from mxnet_tpu_torch import serving, util
from mxnet_tpu_torch.serving import stats
from mxnet_tpu_torch.serving.decode import DecodeEngine, TinyCausalLM
from mxnet_tpu_torch.serving.decode import kv_cache, sampling

TINY = dict(vocab_size=16, hidden=16, num_layers=1, num_heads=2, max_len=32)


def _tiny_engine(name, seed=2, **kw):
    kw = dict(dict(max_slots=2, block_size=4, max_prompt_len=4,
                   max_new_tokens=8), **kw)
    return DecodeEngine(TinyCausalLM(seed=seed, device="cpu", **TINY),
                        name=name, **kw)


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------

def _fire_pattern(pkg, seed, rules, n=48):
    plan = pkg.FaultPlan(seed)
    for rule in rules:
        plan.add(**rule)
    out = []
    with pkg.plan(plan):
        for i in range(n):
            site = ("serving.predict", "kvstore.push")[i % 2]
            try:
                pkg.fault_point(site)
                out.append(None)
            except pkg.InjectedFault as exc:
                out.append(type(exc).__name__)
            except pkg.SimulatedCrash:
                out.append("crash")
    return out, plan.hit_count(), plan.fired_count("serving."), \
        plan.truncate_offset(1000)


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_seeded_fault_plan_fires_at_the_same_hits(seed):
    rules = [dict(site="serving.predict", kind="transient", p=0.4),
             dict(site="kvstore.*", kind="fatal", p=0.3, after=3, times=4),
             dict(site="serving.predict", kind="crash", after=40)]
    got = _fire_pattern(faults, seed, rules)
    assert got == _fire_pattern(jfaults, seed, rules)
    assert any(got[0]) and got[1] == 48


def test_fault_catalog_and_retry_class():
    assert faults.KNOWN_SITES == jfaults.KNOWN_SITES
    assert util.TransientFault is faults.TransientFault
    assert faults.is_retryable(faults.TransientFault("x"))
    assert not faults.is_retryable(faults.FatalFault("x"))
    with pytest.raises(ValueError):
        faults.FaultPlan(0).add("no.such.site")
    with faults.plan(faults.FaultPlan(0)):
        with pytest.raises(ValueError):
            faults.fault_point("checkpoint.wriet")
    faults.fault_point("serving.predict")          # no plan: a no-op


def test_served_model_retries_a_transient_predict_fault():
    from mxnet_tpu_torch.gluon import nn
    net = nn.Dense(2, in_units=4, device="cpu")
    net.initialize()
    server = serving.ModelServer()
    try:
        server.load_model("m", net, input_shapes=[(4,)], max_batch=2,
                          device="cpu")
        plan = faults.FaultPlan(0).add("serving.predict", kind="transient",
                                       times=2)
        with faults.plan(plan):
            res = server.predict("m", np.ones(4, np.float32),
                                 timeout_ms=5000)
        assert res.status == serving.OK
        snap = server.stats()["models"]["m"]
        assert snap["retries"] == 2 and snap["errors"] == 0
        assert plan.fired_count() == 2
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# the engine's retry envelope and breaker (cf. tests/test_decode.py)
# ---------------------------------------------------------------------------

def test_engine_retries_transients_and_breaker_opens_and_recovers():
    eng = _tiny_engine("brk", breaker_threshold=2, breaker_backoff_ms=30.0)
    try:
        plan = faults.FaultPlan(0).add("serving.predict", kind="transient",
                                       times=2)
        with faults.plan(plan):
            res = eng.generate([1, 2], max_new_tokens=4, timeout_ms=10000)
        assert res.status == serving.OK
        assert eng.stats_snapshot()["retries"] == 2
        assert res.tokens() == eng.generate_reference([1, 2], 4).tolist()
        persistent = faults.FaultPlan(0).add("serving.predict", kind="fatal")
        with faults.plan(persistent):
            statuses = [eng.generate([1], max_new_tokens=2,
                                     timeout_ms=10000).status
                        for _ in range(4)]
        # the first K=2 fail their execution; once open, admission
        # fast-fails with the retryable status
        assert statuses[:2] == [serving.ERROR] * 2, statuses
        assert serving.UNAVAILABLE in statuses[2:], statuses
        assert eng.health() == "UNAVAILABLE"
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if eng.generate([1], max_new_tokens=2,
                            timeout_ms=10000).status == serving.OK:
                break
            time.sleep(0.01)
        assert eng.health() == "HEALTHY"
        kv = eng.kv_stats()
        assert kv["used"] == 0 and kv["allocated_total"] == kv["freed_total"]
    finally:
        eng.stop()
    snap = eng.stats_snapshot()
    assert snap["requests"] == snap["ok"] + snap["timeouts"] \
        + snap["errors"] + snap["unavailable"]
    assert eng.submit([1]).status == serving.UNAVAILABLE


# ---------------------------------------------------------------------------
# profiler
# ---------------------------------------------------------------------------

def test_decode_counters_land_in_the_profiler_dump(tmp_path):
    eng = _tiny_engine("t")
    trace = str(tmp_path / "decode_profile.json")
    profiler.set_config(filename=trace)
    profiler.set_state("run")
    try:
        assert profiler.state() == "run"
        with profiler.Domain("test").new_task("generate"):
            res = eng.generate([5, 6, 7], max_new_tokens=6, timeout_ms=30000)
        assert res.status == serving.OK
        profiler.Domain("test").new_marker("done").mark()
    finally:
        profiler.set_state("stop")
        profiler.dump()
        eng.stop()
    events = json.load(open(trace))["traceEvents"]
    counters = {e["name"] for e in events if e.get("ph") == "C"}
    for name in ("t:live_seqs", "t:kv_blocks_used", "t:ttft_ms",
                 "t:tokens_per_s"):
        assert name in counters, counters
    assert {"generate", "done"} <= {e["name"] for e in events}
    assert "generate" in profiler.dumps()
    # the device half: torch.profiler's trace where the XPlane one goes
    assert (tmp_path / "decode_profile_xplane" / "torch_trace.json").exists()
    assert "generate" in profiler.merge_dumps([trace])


def test_memory_summary_lists_live_tensors():
    keep = torch.ones(3, 5, 7)
    table = profiler.memory_summary("cpu")
    assert any(l.startswith("float32") and "(3, 5, 7)" in l
               for l in table.splitlines())
    total = next(l for l in table.splitlines() if l.startswith("TOTAL"))
    assert int(total.split()[1]) >= 1 and int(total.split()[2]) >= 420
    del keep


# ---------------------------------------------------------------------------
# memory accounting
# ---------------------------------------------------------------------------

@pytest.fixture
def accountants():
    """Both packages' process-wide accountants, zeroed after the test (a
    worker runs other files' tests in this process afterwards)."""
    yield memory_accounting, jmem
    memory_accounting.reset_memory_counters()
    jmem.reset_memory_counters()


def test_accountant_api_matches_jax(accountants):
    for pkg in accountants:
        pkg.reset_memory_counters()
        pkg.record_alloc(100, "a", count=2)
        with pkg.track_region("a"):
            assert pkg.current_region() == "a"
            assert pkg.record_temp(np.zeros(8, np.float32))
            assert pkg.record_temp(24)
        pkg.record_free(40, "a")
        assert not pkg.record_temp(8)           # no scope: free of charge
    assert memory_accounting.memory_counters() == jmem.memory_counters()
    assert memory_accounting.memory_totals() == jmem.memory_totals()
    assert memory_accounting.region_peak_bytes("a") == 156
    with memory_accounting.track_region("b"):
        memory_accounting.record_temp(torch.zeros(4, dtype=torch.float64))
    assert memory_accounting.memory_counters()["b"]["alloc_bytes"] == 32
    if not torch.cuda.is_available():
        assert memory_accounting.device_memory_stats() is None


def test_engine_charges_the_jax_engines_bytes(accountants):
    """Same geometry and traffic: the KV region's block bytes and one pool
    set's bytes are the JAX engine's."""
    kw = dict(max_slots=2, block_size=4, max_prompt_len=4, max_new_tokens=8,
              warmup=False)
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
    counters = []
    for pkg, make in ((memory_accounting, lambda: DecodeEngine(
            TinyCausalLM(seed=2, device="cpu", **TINY), name="mem", **kw)),
            (jmem, lambda: JEngine(JModel(seed=2, **TINY), name="mem",
                                   **kw))):
        pkg.reset_memory_counters()
        eng = make()
        try:
            for p in prompts:
                assert eng.generate(p, max_new_tokens=6,
                                    timeout_ms=30000).status == "OK"
        finally:
            eng.stop()
        counters.append(pkg.memory_counters())
    mine, theirs = counters
    assert mine["kv:mem"] == theirs["kv:mem"]
    assert mine["kv:mem"]["alloc_bytes"] > 0
    assert mine["kv:mem"]["live_bytes"] == 0
    # the live pool set (the JAX engine makes it when its worker starts)
    assert mine["kv:mem:pools"] == theirs["kv:mem:pools"]


# ---------------------------------------------------------------------------
# the host halves of the decode tier
# ---------------------------------------------------------------------------

def _ledger_run(mod):
    cache = mod.PagedKVCache(num_layers=1, num_blocks=12, block_size=4,
                             num_heads=2, head_dim=8)
    prompt = [5, 3, 7, 1, 2, 6, 4, 8, 9]
    log = [cache.reserve("d", 4, prompt=prompt, align_tokens=4)]
    cache.ensure_capacity("d", len(prompt))
    log.append(cache.register_prefix("d", prompt))
    log.append(cache.reserve("a", 4, prompt=prompt, align_tokens=4))
    log.append(cache.reserve("b", 3, prompt=prompt[:8], align_tokens=4))
    log.append(cache.writable("a", 1))
    cache.ensure_capacity("b", 8)
    log.append(cache.table("a", 5))
    log.append(cache.free_seq("d"))
    log.append(cache.free_seq("a"))
    log.append(cache.reserve("c", 9))
    log.append(cache.available_unreserved())
    log.append(cache.stats())
    return [repr(x) if isinstance(x, mod.ReserveResult) else x for x in log]


def test_kv_ledger_matches_jax():
    assert _ledger_run(kv_cache) == _ledger_run(jkv)
    pools = kv_cache.PagedKVCache(2, 5, 4, 2, 8).init_pools("cpu")
    assert [tuple(p.shape) for p in pools] == [(2, 5, 4, 2, 8)] * 2
    assert all(p.dtype == torch.float32 and not p.any() for p in pools)


def test_stream_sampler_matches_jax():
    rng = np.random.RandomState(0)
    rows = rng.randn(20, 48).astype(np.float32) * 3
    for opts in (dict(temperature=0.9, top_k=8, top_p=0.95, seed=1234),
                 dict(temperature=1.3, top_p=0.5, seed=9),
                 dict(temperature=0.0)):
        want = jsampling.StreamSampler(jsampling.SamplingParams(**opts))
        got = sampling.StreamSampler(sampling.SamplingParams(**opts))
        assert [got.sample(r) for r in rows] == \
            [want.sample(r) for r in rows]
        resumed = sampling.StreamSampler.restore(got.params, got.seed, 7)
        again = sampling.StreamSampler(got.params)
        [again.sample(r) for r in rows[:7]]
        assert [resumed.sample(r) for r in rows[7:]] == \
            [again.sample(r) for r in rows[7:]]
    with pytest.raises(ValueError):
        sampling.SamplingParams(top_p=0.0)


def test_stream_helpers_match_jax():
    rng = np.random.RandomState(1)
    rows = []
    for i in range(40):
        ttft = float(rng.uniform(1, 50))
        rows.append({"status": ("OK", "OK", "TIMEOUT")[i % 3],
                     "ttft_ms": None if i == 7 else ttft,
                     "latency_ms": ttft + float(rng.uniform(0, 200)),
                     "tokens": int(rng.randint(0, 30))})
    for slo in ((None, None), (25.0, None), (30.0, 5.0), (None, 3.0)):
        assert stats.goodput_under_slo(rows, *slo) == \
            jstats.goodput_under_slo(rows, *slo)
    for r in rows:
        assert stats.stream_tpot_ms(r["latency_ms"], r["ttft_ms"],
                                    r["tokens"]) == jstats.stream_tpot_ms(
            r["latency_ms"], r["ttft_ms"], r["tokens"])


# ---------------------------------------------------------------------------
# ModelServer's engine surface, against the JAX server's
# ---------------------------------------------------------------------------

class _Engine:
    """What the servers read of an attached engine."""

    def __init__(self, name):
        self.name = name
        self.stopped = False

    def stats_snapshot(self):
        return {"ok": 1}

    def health(self):
        return "DEGRADED"

    def stop(self):
        self.stopped = True


def _engine_surface(mod, errors):
    server = mod.ModelServer()
    out = []
    eng, other = _Engine("dec"), _Engine("dec2")
    out.append(server.attach_engine(eng) is eng)
    server.attach_engine(other)
    out.append(server.engines())
    for call in (lambda: server.attach_engine(_Engine("dec")),
                 lambda: server.detach_engine("nope")):
        try:
            call()
            out.append("no error")
        except errors as exc:
            out.append(str(exc))
    out.append(server.stats()["engines"])
    out.append(server.health("dec"))
    out.append(server.detach_engine("dec2") is other)
    server.stop()
    out.append((eng.stopped, other.stopped, server.engines()))
    try:
        server.attach_engine(_Engine("late"))
    except errors as exc:
        out.append(str(exc))
    return out


def test_attach_detach_engines_as_in_jax():
    from mxnet_tpu.base import MXNetError as JaxError
    assert _engine_surface(serving.server, MXNetError) == \
        _engine_surface(jserver, JaxError)


def test_a_loaded_name_and_an_engine_name_clash():
    from mxnet_tpu_torch.gluon import nn
    net = nn.Dense(2, in_units=4, device="cpu")
    net.initialize()
    server = serving.ModelServer()
    try:
        server.load_model("m", net, input_shapes=[(4,)], max_batch=1,
                          device="cpu")
        with pytest.raises(MXNetError, match="already a loaded model"):
            server.attach_engine(_Engine("m"))
        server.attach_engine(_Engine("e"))
        with pytest.raises(MXNetError, match="attached engine"):
            server.load_model("e", net, input_shapes=[(4,)], device="cpu")
    finally:
        server.stop()
