"""mxnet_tpu_torch.serving.disagg: the disaggregated prefill/decode pair
and its autoscaler against the JAX package's, on the CPU.

tests/test_disagg.py's model and engines (vocab 24, hidden 16, 1 layer,
chunks of 4) in both packages:

* the same greedy and seeded-sampled streams through both packages'
  ``DisaggRouter``s are token-identical to each other and to the JAX
  package's colocated reference, each handed off once at its first
  token, with the same ledger on the prefill router (conservation across
  the tiers) and the same engine counts;
* an open-loop ``traffic.poisson_trace`` with a ``tenant_mix``, fired by
  ``traffic.replay``: arrivals == fired == terminal, every stream equal
  to the reference, one handoff a stream;
* a failed adoption ends UNAVAILABLE with the first token; the prefill
  tier takes only ``prefill_only`` engines;
* the autoscaler scales a tier out on an SLO breach (the joined engine
  warm) and in by draining a victim whose streams finish bitwise, and
  ``TierPolicy`` refuses what the JAX one refuses.
"""
import json

import pytest

from mxnet_tpu.serving import disagg as jdisagg
from mxnet_tpu.serving.decode import DecodeEngine as JEngine
from mxnet_tpu.serving.decode import TinyCausalLM as JModel
from mxnet_tpu_torch import MXNetError, profiler, serving
from mxnet_tpu_torch.serving import traffic
from mxnet_tpu_torch.serving.decode import DecodeEngine, TinyCausalLM
from mxnet_tpu_torch.serving.disagg import (Autoscaler, DisaggRouter,
                                            TierPolicy)

MODEL_KW = dict(vocab_size=24, hidden=16, num_layers=1, num_heads=2,
                max_len=32, seed=11)
ENGINE_KW = dict(max_slots=2, block_size=4, num_blocks=32,
                 max_prompt_len=8, max_new_tokens=6, max_queue=16,
                 prefill_chunk=4)
PROMPTS = [[5, 3, 7, 1], [2, 6, 4], [9, 8, 1, 2, 3], [7, 7]]
SAMPLE = dict(temperature=0.8, top_k=6, seed=321)
LEDGER = ("requests", "ok", "timeouts", "errors", "unavailable", "shed",
          "handoffs", "fenced", "tokens_out")


def _prefill(name, **kw):
    return DecodeEngine(TinyCausalLM(device="cpu", **MODEL_KW), name=name,
                        prefill_only=True, **dict(ENGINE_KW, **kw))


def _full(name, **kw):
    return DecodeEngine(TinyCausalLM(device="cpu", **MODEL_KW), name=name,
                        **dict(ENGINE_KW, **kw))


def _pair(mod=None, prefill=1, decode=1, **engine_kw):
    if mod is None:
        dr = DisaggRouter(prefill_replicas=prefill, decode_replicas=decode)
        dr.load("lm", lambda n: _prefill(n, **engine_kw),
                lambda n: _full(n, **engine_kw), prefill_replicas=prefill,
                decode_replicas=decode)
        return dr
    dr = mod.DisaggRouter(prefill_replicas=prefill, decode_replicas=decode)
    dr.load("lm", lambda n: JEngine(JModel(**MODEL_KW), name=n,
                                    prefill_only=True, **ENGINE_KW),
            lambda n: JEngine(JModel(**MODEL_KW), name=n, **ENGINE_KW))
    return dr


@pytest.fixture(scope="module")
def refs():
    """The JAX package's colocated references, greedy and sampled."""
    eng = JEngine(JModel(**MODEL_KW), name="jref", **ENGINE_KW)
    try:
        return ([eng.generate_reference(p, 6).tolist() for p in PROMPTS],
                [eng.generate_reference(p, 6, **SAMPLE).tolist()
                 for p in PROMPTS])
    finally:
        eng.stop()


def _both_kinds(dr):
    streams = []
    for p in PROMPTS:
        streams.append(dr.submit_stream("lm", list(p), max_new_tokens=6))
        streams.append(dr.submit_stream("lm", list(p), max_new_tokens=6,
                                        **SAMPLE))
    for s in streams:
        assert s.wait(30.0), "a stream never terminated"
    ledger = dr.prefill.decode_stats.snapshot()
    engines = {tier: sorted((k, v) for snap in dr.stats()[tier]["engines"][
        "lm"].values() for k, v in snap.items()
        if k in ("requests", "handed_off", "imported"))
        for tier in ("prefill", "decode")}
    return ([(s.status, s.tokens()) for s in streams],
            {k: ledger[k] for k in LEDGER}, dr.stats()["disagg"], engines)


def test_handoff_streams_and_ledger_equal_jax(refs):
    greedy, sampled = refs
    with _pair(jdisagg) as jdr:
        theirs = _both_kinds(jdr)
    with _pair() as dr:
        mine = _both_kinds(dr)
        assert dr.decode.decode_stats.snapshot()["requests"] == 0
    assert mine[0] == theirs[0]
    for i, (status, tokens) in enumerate(mine[0]):
        assert status == serving.OK
        assert tokens == (sampled if i % 2 else greedy)[i // 2]
    assert mine[1] == theirs[1]
    assert mine[1]["requests"] == mine[1]["ok"] == 2 * len(PROMPTS)
    assert mine[2]["handoffs"] == theirs[2]["handoffs"] == 2 * len(PROMPTS)
    assert mine[2]["handoff_failures"] == theirs[2]["handoff_failures"] == 0
    assert mine[3] == theirs[3]


def test_open_loop_trace_conserves_arrivals(refs):
    greedy, _ = refs
    arrivals = traffic.poisson_trace(200.0, 0.1, seed=4)
    tenants = traffic.tenant_mix(arrivals, {"free": 1, "paid": 3}, seed=4)
    streams = [None] * len(arrivals)
    # the decode tier's pool holds every arrival's worst case (3 blocks):
    # an adoption reserves its blocks at once, and a busy host must not
    # turn the burst into failed adoptions
    with _pair(num_blocks=3 * len(arrivals) + 1,
               max_queue=len(arrivals)) as dr:
        def submit(i, _t):
            streams[i] = dr.submit_stream(
                "lm", list(PROMPTS[i % len(PROMPTS)]), max_new_tokens=6,
                tenant=tenants[i])

        fired = traffic.replay(arrivals, submit)
        for s in streams:
            assert s.wait(30.0)
        ledger = dr.prefill.decode_stats.snapshot()
        hand = dr.stats()["disagg"]
        seen = dr.tenant_snapshot()
    assert len(arrivals) == fired == sum(1 for s in streams
                                         if s.status is not None) > 5
    for i, s in enumerate(streams):
        assert s.status == serving.OK and \
            s.tokens() == greedy[i % len(PROMPTS)]
    assert ledger["requests"] == ledger["ok"] == hand["handoffs"] == fired
    assert {t: seen[t]["admitted"] for t in seen} == \
        {t: tenants.count(t) for t in set(tenants)}


def test_failed_adoption_ends_unavailable_with_the_first_token(refs):
    greedy, _ = refs
    with _pair() as dr:
        (rid,) = [r for r, st in dr.decode.replicas().items()
                  if st == "LIVE"]
        dr.decode.drain(rid)
        s = dr.submit_stream("lm", list(PROMPTS[0]), max_new_tokens=6)
        assert s.wait(30.0)
        assert s.status == serving.UNAVAILABLE, (s.status, s.error)
        assert s.tokens() == greedy[0][:1]
        assert dr.stats()["disagg"]["handoff_failures"] == 1
        ledger = dr.prefill.decode_stats.snapshot()
        assert ledger["requests"] == ledger["unavailable"] == 1


def test_prefill_tier_takes_only_prefill_only_engines():
    dr = DisaggRouter(prefill_replicas=1, decode_replicas=1)
    try:
        with pytest.raises(MXNetError,
                           match="prefill_only=True|could not place"):
            dr.load("lm", _full, _full)
        dr.load("lm", _prefill, _full)        # the name is free again
        s = dr.submit_stream("lm", [5, 3, 7], max_new_tokens=4)
        assert s.wait(30.0) and s.status == serving.OK
        assert set(dr.health("lm").values()) == {serving.HEALTHY}
        assert set(dr.scaling_advice()) == {"prefill", "decode"}
    finally:
        dr.stop()


@pytest.mark.parametrize("kw", [dict(min_replicas=0),
                                dict(min_replicas=3, max_replicas=2),
                                dict(kv_low=0.9, kv_high=0.5),
                                dict(queue_low=0.9, queue_high=0.5)])
def test_tier_policy_refuses_as_jax(kw):
    with pytest.raises(ValueError) as mine:
        TierPolicy(**kw)
    with pytest.raises(ValueError) as theirs:
        jdisagg.TierPolicy(**kw)
    assert str(mine.value) == str(theirs.value)


def test_autoscaler_scales_out_warm_and_in_by_draining(refs, tmp_path):
    greedy, _ = refs
    trace = str(tmp_path / "disagg_profile.json")
    profiler.set_config(filename=trace)
    profiler.set_state("run")
    try:
        with _pair(decode=2) as dr:
            s = dr.submit_stream("lm", list(PROMPTS[0]), max_new_tokens=6)
            assert s.wait(30.0) and s.status == serving.OK
            sc = Autoscaler(dr, prefill=TierPolicy(max_replicas=2,
                                                   slo_p99_ttft_ms=1e-6),
                            decode=TierPolicy(min_replicas=1, kv_low=0.98,
                                              kv_high=0.99, queue_low=0.98,
                                              queue_high=0.99))
            streams = [dr.submit_stream("lm", list(p), max_new_tokens=6)
                       for p in PROMPTS]
            decisions = sc.poll()
            assert decisions["prefill"]["action"] == "scale_out"
            assert decisions["prefill"]["replicas"] == 2
            assert decisions["decode"]["action"] == "scale_in"
            assert [d["tier"] for d in sc.decisions] == ["prefill",
                                                         "decode"]
            for i, s in enumerate(streams):
                assert s.wait(30.0) and s.status == serving.OK
                assert s.tokens() == greedy[i]
            dr.wait_converged(10.0)
            assert len(dr.prefill.stats()["decode_models"]["lm"][
                "placement"]) == 2
            for i, p in enumerate(PROMPTS):
                s = dr.submit_stream("lm", list(p), max_new_tokens=6)
                assert s.wait(30.0) and s.tokens() == greedy[i]
    finally:
        profiler.set_state("stop")
        profiler.dump()
    counters = {e["name"] for e in json.load(open(trace))["traceEvents"]
                if e.get("ph") == "C"}
    for name in ("prefill:handoff_ms", "prefill:replicas", "decode:replicas",
                 "prefill:slo_p99_ttft_ms", "decode:slo_p99_tpot_ms"):
        assert name in counters, (name, counters)
