"""mxnet_tpu_torch.serving.decode: the decode engine against the JAX one.

The JAX package's engine is the reference.  The same seeded
``TinyCausalLM`` (vocab 48, hidden 32, 2 layers, 2 heads, max_len 128,
seed 7: tests/test_decode.py's model) runs in both packages:

* the five paged-KV functions (prefill, decode, chunk prefill, verify,
  propose) on the same seeded inputs, tables and pools: logits and the
  written pages within 2e-5 (the decode-logits bound of
  tests/test_sharded_decode.py), pages neither side writes bit-equal, the
  seeded weights bit-equal;
* greedy streams through continuous batching, chunked prefill with the
  prefix cache, speculative decoding with a draft model, and a seeded
  sampled stream: token-identical to the JAX engine's and to the port's
  own ``generate_reference``, with no signature missed after warmup and no
  KV block leaked;
* a stream exported mid-stream and imported into a second engine, and the
  Gluon adapter over ``TinyGluonLM`` and over a ``SymbolBlock.imports`` of
  its ``export``, finish as the plain model does.

Engines are built once per module with small ladders (prompts <= 16,
<= 24 new tokens) to keep the file within a few seconds of JAX compiles.
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.serving import decode as jdecode
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, serving
from mxnet_tpu_torch.serving import decode

MODEL_KW = dict(vocab_size=48, hidden=32, num_layers=2, num_heads=2,
                max_len=128, seed=7)
DRAFT_KW = dict(MODEL_KW, num_layers=1, seed=99)
ENGINE_KW = dict(max_slots=8, block_size=4, max_prompt_len=16,
                 max_new_tokens=24, max_queue=256)
# chunked prefill + prefix cache + speculation (3 draft tokens a round)
SPEC_KW = dict(ENGINE_KW, prefill_chunk=4, prefix_cache=True, spec_k=3)
TOL = dict(rtol=2e-5, atol=2e-5)
SAMPLED = dict(temperature=0.9, top_k=8, top_p=0.95, seed=1234)


def _prompts(n, seed=0, max_len=16, budget=24):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 48, rng.randint(1, max_len + 1)).tolist()
               for _ in range(n)]
    budgets = [int(rng.randint(1, budget + 1)) for _ in range(n)]
    return prompts, budgets


def _shared_prefix_prompts():
    """Prompts sharing an 8-token (two-block) prefix, and one duplicate."""
    base = [5, 3, 7, 1, 2, 6, 4, 8]
    return [base, base + [9, 2], base + [11, 3, 5, 7], [4, 4, 11], base]


def _run_streams(engine, prompts, budgets, **kw):
    """Submit every prompt at once from four client threads; wait all."""
    streams = [None] * len(prompts)

    def client(c):
        for i in range(c, len(prompts), 4):
            streams[i] = engine.submit(prompts[i], max_new_tokens=budgets[i],
                                       timeout_ms=60000, **kw)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    for s in streams:
        assert s.wait(60) and s.status == "OK", s
    return [s.tokens() for s in streams]


def _leak(engine):
    kv = engine.kv_stats()
    return kv["allocated_total"] - kv["freed_total"], kv["used"], \
        kv["reserved"]


@pytest.fixture(scope="module")
def models():
    jm = jdecode.TinyCausalLM(**MODEL_KW)
    tm = decode.TinyCausalLM(device="cpu", **MODEL_KW)
    return jm, tm


@pytest.fixture(scope="module")
def greedy_pair(models):
    jm, tm = models
    je = jdecode.DecodeEngine(jm, name="jg", **ENGINE_KW)
    te = decode.DecodeEngine(tm, name="tg", **ENGINE_KW)
    yield je, te
    je.stop()
    te.stop()


@pytest.fixture(scope="module")
def spec_pair(models):
    jm, tm = models
    je = jdecode.DecodeEngine(jm, name="js", draft_model=jdecode.TinyCausalLM(
        **DRAFT_KW), **SPEC_KW)
    te = decode.DecodeEngine(tm, name="ts", draft_model=decode.TinyCausalLM(
        device="cpu", **DRAFT_KW), **SPEC_KW)
    yield je, te
    je.stop()
    te.stop()


# ---------------------------------------------------------------------------
# the model: weights and the five functions
# ---------------------------------------------------------------------------

def test_seeded_weights_bit_equal_and_params_round_trip(models):
    jm, tm = models
    jp = {k: v.asnumpy() for k, v in jm.param_dict().items()}
    tp = tm.param_dict()
    assert set(jp) == set(tp)
    for k in jp:
        assert np.array_equal(jp[k], tp[k].numpy()), k
    # the JAX package's weights carry across through params=
    again = decode.TinyCausalLM(device="cpu", params=jp, **{
        k: v for k, v in MODEL_KW.items() if k != "seed"})
    assert all(torch.equal(again.param_dict()[k], tp[k]) for k in tp)
    bad = dict(jp)
    bad["l0_wq"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="l0_wq"):
        decode.TinyCausalLM(device="cpu", params=bad, **{
            k: v for k, v in MODEL_KW.items() if k != "seed"})
    with pytest.raises(ValueError, match="missing"):
        decode.TinyCausalLM(device="cpu", params={"embed": jp["embed"]}, **{
            k: v for k, v in MODEL_KW.items() if k != "seed"})
    with pytest.raises(NotImplementedError):
        decode.TinyCausalLM(device="cpu", context_attention="sp")


def _fn_cases():
    """name -> (seeded integer inputs after params, before the pools)."""
    rng = np.random.RandomState(3)
    i32 = lambda *a: np.asarray(a, np.int32)  # noqa: E731
    tables = np.zeros((4, 6), np.int32)
    tables[0, :3] = [1, 2, 4]
    tables[1, :2] = [6, 7]
    tables[3, :1] = [11]
    toks = np.zeros((1, 8), np.int32)
    toks[0, :5] = rng.randint(0, 48, 5)
    return {
        "prefill_fn": (toks, i32(5), i32([3, 5, 0, 0, 0, 0])),
        "decode_fn": (rng.randint(0, 48, 4).astype(np.int32),
                      i32(9, 5, 0, 2), tables),
        "chunk_prefill_fn": (rng.randint(0, 48, (1, 8)).astype(np.int32),
                             i32(4), i32(6), i32([8, 9, 10, 0, 0, 0])),
        "verify_fn": (rng.randint(0, 48, (4, 4)).astype(np.int32),
                      i32(9, 5, 0, 2), i32(4, 2, 0, 1), tables),
        "propose_fn": (rng.randint(0, 48, 4).astype(np.int32),
                       i32(9, 5, 0, 2), tables),
    }


@pytest.mark.parametrize("fn", ["prefill_fn", "decode_fn", "chunk_prefill_fn",
                                "verify_fn", "propose_fn"])
def test_model_function_matches_jax(models, fn):
    import jax
    import jax.numpy as jnp
    jm, tm = models
    args = [np.asarray(a).reshape((1,) if np.ndim(a) == 0 else np.shape(a))
            for a in _fn_cases()[fn]]
    rng = np.random.RandomState(4)
    shape = (2, 12, 4, 2, 16)    # layers, blocks, block size, heads, dim
    kp = rng.randn(*shape).astype(np.float32)
    vp = rng.randn(*shape).astype(np.float32)
    extra = (3,) if fn == "propose_fn" else ()
    jp = {k: v._data for k, v in jm.param_dict().items()}
    jfn = jax.jit(getattr(jm, fn), static_argnums=(len(args) + 3,)
                  if extra else ())
    jout = jfn(jp, *map(jnp.asarray, args), jnp.asarray(kp),
               jnp.asarray(vp), *extra)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tout = getattr(tm, fn)(tm.param_dict(), *map(torch.from_numpy, args),
                           tk, tv, *extra)
    assert tout[1] is tk and tout[2] is tv      # written in place
    if fn == "propose_fn":                       # greedy ids
        assert np.array_equal(np.asarray(jout[0]), tout[0].numpy())
    else:
        np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                                   **TOL)
    for before, j, t in ((kp, jout[1], tk), (vp, jout[2], tv)):
        j, t = np.asarray(j), t.numpy()
        j_wrote = np.any(j != before, axis=(3, 4))
        t_wrote = np.any(t != before, axis=(3, 4))
        assert np.array_equal(j_wrote, t_wrote)      # the same pages
        assert j_wrote.any()
        np.testing.assert_allclose(t, j, **TOL)
        assert np.array_equal(t[~t_wrote], before[~t_wrote])


@pytest.mark.parametrize("width", [3, 4, 8, 11])
def test_decode_step_is_bitwise_across_width_buckets(models, width):
    """The decode step of a slot gives the same bits at every table width
    at least as wide as its sequence, whatever its neighbours hold."""
    _, tm = models
    rng = np.random.RandomState(5)
    shape = (2, 24, 4, 2, 16)
    kp = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    vp = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    tokens = torch.from_numpy(rng.randint(0, 48, 8).astype(np.int32))
    positions = torch.tensor([6, 1, 0, 0, 3, 0, 5, 2], dtype=torch.int32)
    narrow = torch.zeros((8, 2), dtype=torch.int32)
    narrow[:, 0] = torch.arange(1, 9)
    narrow[:, 1] = torch.arange(9, 17)
    wide = torch.zeros((8, width), dtype=torch.int32)
    wide[:, :2] = narrow
    # garbage neighbours: the dead slots' rows differ in the wide call
    wide[2, 2:] = 17
    want = tm.decode_fn(tm.param_dict(), tokens, positions, narrow,
                        kp.clone(), vp.clone())[0]
    got = tm.decode_fn(tm.param_dict(), tokens, positions, wide,
                       kp.clone(), vp.clone())[0]
    live = [0, 1, 4, 6, 7]
    assert torch.equal(got[live], want[live])


# ---------------------------------------------------------------------------
# engines: greedy, chunked + prefix + speculative, sampled
# ---------------------------------------------------------------------------

def test_greedy_streams_equal_jax_engine_and_reference(greedy_pair):
    je, te = greedy_pair
    prompts, budgets = _prompts(16)
    warm = te.warmup_report
    assert warm["signatures"] == warm["compiles"] == 10   # 5 prompt + 5 width
    assert warm["captures"] == 0                          # CPU: eager
    misses = te.cache_stats()["misses"]
    want = _run_streams(je, prompts, budgets)
    got = _run_streams(te, prompts, budgets)
    assert got == want
    refs = [te.generate_reference(p, b).tolist()
            for p, b in zip(prompts, budgets)]
    assert got == refs
    assert te.cache_stats()["misses"] == misses
    assert te.stats_snapshot()["avg_live_slots"] > 2.0
    assert _leak(te) == (0, 0, 0)


def test_prefix_chunked_speculative_streams_equal_jax(spec_pair):
    je, te = spec_pair
    prompts = _shared_prefix_prompts()
    budgets = [10, 8, 12, 9, 10]
    misses = te.cache_stats()["misses"]
    # the donor finishes first, so that the rest attach its pages
    want = [je.submit(prompts[0], 10).result().tokens()]
    got = [te.submit(prompts[0], 10).result().tokens()]
    want += _run_streams(je, prompts[1:], budgets[1:])
    got += _run_streams(te, prompts[1:], budgets[1:])
    assert got == want
    assert got == [te.generate_reference(p, b).tolist()
                   for p, b in zip(prompts, budgets)]
    snap, jsnap = te.stats_snapshot(), je.stats_snapshot()
    assert snap["prefix_hits"] >= 2 and snap["spec_proposed"] > 0
    # per-stream counts (the copy-on-write forks depend on timing)
    for key in ("prefix_hits", "prefix_blocks_shared", "spec_proposed",
                "spec_accepted"):
        assert snap[key] == jsnap[key], key
    assert te.cache_stats()["misses"] == misses
    assert _leak(te) == (0, 0, 0)


def test_sampled_stream_equals_jax_and_replays_on_a_fresh_engine(spec_pair,
                                                                  models):
    je, te = spec_pair
    prompt = [5, 3, 7, 1, 2, 6, 4, 8, 9]
    want = je.submit(prompt, 12, **SAMPLED).result().tokens()
    got = te.submit(prompt, 12, **SAMPLED).result().tokens()
    assert got == want
    assert got == te.generate_reference(prompt, 12, **SAMPLED).tolist()
    fresh = decode.DecodeEngine(models[1], name="fresh", warmup=False,
                                **dict(ENGINE_KW, max_slots=2))
    try:
        assert fresh.submit(prompt, 12, **SAMPLED).result().tokens() == got
    finally:
        fresh.stop()


def test_derived_seed_matches_jax_under_framework_seed(greedy_pair):
    """No explicit seed: both packages derive the stream's seed from the
    caller's ``mx.random.seed``, so the streams agree and replay."""
    je, te = greedy_pair
    prompt = [9, 8, 7, 6]
    jmx.random.seed(21)
    want = je.submit(prompt, 8, temperature=0.7).result().tokens()
    mx.random.seed(21)
    one = te.submit(prompt, 8, temperature=0.7).result().tokens()
    mx.random.seed(21)
    two = te.submit(prompt, 8, temperature=0.7).result().tokens()
    assert one == two == want


def test_admission_statuses_match_jax(greedy_pair):
    je, te = greedy_pair
    cases = [np.arange(17), [1, 2, 999], [], [[1, 2]], [0.5, 1.5]]
    for bad in cases:
        for eng in (je, te):
            assert eng.submit(bad, max_new_tokens=4).status == "INVALID_INPUT"
    assert te.submit([1], max_new_tokens=9999).status == "INVALID_INPUT"
    assert te.submit([1], temperature=-1.0).status == "INVALID_INPUT"


def test_handoff_carries_shared_pages_and_sampler_state(models):
    """cf. tests/test_decode_prefix.py: a greedy and a sampled stream move
    mid-stream between two engines and finish as if never moved."""
    kw = dict(ENGINE_KW, max_slots=2, prefill_chunk=4, prefix_cache=True,
              max_new_tokens=16, warmup=False)
    a = decode.DecodeEngine(models[1], name="ha", **kw)
    b = decode.DecodeEngine(models[1], name="hb", **kw)
    prompt = [5, 3, 7, 1, 2, 6, 4, 8, 9, 2]
    try:
        ref = a.generate_reference(prompt, 12).tolist()
        ref_sam = a.generate_reference(prompt, 12, temperature=0.8,
                                       seed=555).tolist()
        assert a.submit(prompt, 12).result().status == "OK"   # the donor
        # a slow consumer paces the worker, so the move lands mid-stream
        slow = lambda tok: time.sleep(0.03)  # noqa: E731
        greedy = a.submit(prompt, 12, on_token=slow)
        sampled = a.submit(prompt, 12, temperature=0.8, seed=555,
                           on_token=slow)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not (
                len(greedy.tokens()) >= 3 and len(sampled.tokens()) >= 3):
            time.sleep(0.001)
        assert a.quiesce()
        moved = a.export_streams()
        a.resume()
        assert moved, "nothing left to move"
        for stream, snap in moved:
            if snap["generated"]:
                assert snap["k"].shape[1] == -(-snap["position"] // 4)
            stream.set_owner("mig")
            b.import_stream(snap, stream=stream, owner="mig")
        assert greedy.result().status == "OK"
        assert sampled.result().status == "OK"
        assert greedy.tokens() == ref
        assert sampled.tokens() == ref_sam
        assert a.stats_snapshot()["handed_off"] == len(moved)
        assert b.stats_snapshot()["imported"] == len(moved)
        with pytest.raises(MXNetError, match="quiesced"):
            a.export_stream(greedy)
    finally:
        a.stop()
        b.stop()
    assert _leak(a) == (0, 0, 0) and _leak(b) == (0, 0, 0)


def test_gluon_adapter_streams_equal_the_plain_model(models, greedy_pair):
    _, tm = models
    _, te = greedy_pair
    block = decode.TinyGluonLM(vocab_size=48, hidden=32, num_layers=2,
                               num_heads=2, max_len=128, device="cpu")
    from mxnet_tpu_torch.serving.decode.adapter import copy_reference_weights
    copy_reference_weights(block, tm)
    adapted = decode.GluonCausalLMAdapter(block, num_heads=2)
    assert (adapted.vocab_size, adapted.num_layers, adapted.max_len) == \
        (48, 2, 128)
    # live handles: the engine reads the block's own tensors
    names = adapted.role_names
    assert adapted.param_dict()["l0_wq"] is dict(
        block.collect_params())[names["l0_wq"]]._check_and_get()
    eng = decode.DecodeEngine(adapted, name="ad", **ENGINE_KW)
    try:
        prompts, budgets = _prompts(6, seed=1)
        assert _run_streams(eng, prompts, budgets) == [
            te.generate_reference(p, b).tolist()
            for p, b in zip(prompts, budgets)]
    finally:
        eng.stop()
    # the block's batch forward agrees with the paged prefill
    tokens = torch.tensor([[3, 1, 4, 1, 5]], dtype=torch.int32)
    with torch.no_grad():
        batch = block(tokens)[0, -1]
    kp, vp = (torch.zeros(2, 4, 4, 2, 16) for _ in range(2))
    paged = tm.prefill_fn(tm.param_dict(), tokens, torch.tensor([5]),
                          torch.tensor([[1, 2]]), kp, vp)[0][0]
    torch.testing.assert_close(batch, paged, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="embed"):
        decode.adapter.discover_roles(["l0_wq_weight"])


def test_adapter_export_roundtrip_serves_bitwise(models, greedy_pair,
                                                 tmp_path):
    """``export`` -> ``SymbolBlock.imports`` -> the adapter: the imported
    block's weights serve token-identical streams
    (``tests/test_sharded_decode.py:382-392``)."""
    from mxnet_tpu_torch.gluon.block import SymbolBlock
    from mxnet_tpu_torch.serving.decode.adapter import copy_reference_weights
    _, tm = models
    _, te = greedy_pair
    block = decode.TinyGluonLM(vocab_size=48, hidden=32, num_layers=2,
                               num_heads=2, max_len=128, device="cpu")
    copy_reference_weights(block, tm)
    prefix = str(tmp_path / "lm")
    block.export(prefix)
    imported = SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                   prefix + "-0000.params", ctx="cpu")
    adapted = decode.GluonCausalLMAdapter(imported, num_heads=2)
    assert adapted.role_names == decode.GluonCausalLMAdapter(
        block, num_heads=2).role_names
    eng = decode.DecodeEngine(adapted, name="adexp", **ENGINE_KW)
    try:
        prompts, budgets = _prompts(6, seed=2)
        assert _run_streams(eng, prompts, budgets) == [
            te.generate_reference(p, b).tolist()
            for p, b in zip(prompts, budgets)]
    finally:
        eng.stop()
    tokens = torch.tensor([[3, 1, 4, 1, 5]], dtype=torch.int32)
    with torch.no_grad():
        torch.testing.assert_close(imported(tokens), block(tokens),
                                   rtol=1e-4, atol=1e-5)


def test_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        decode.TinyCausalLM(**MODEL_KW)
    model = decode.TinyCausalLM(device="cpu", **MODEL_KW)
    with pytest.raises(MXNetError, match="no CUDA device"):
        decode.DecodeEngine(model, device="cuda:0", warmup=False)
    with pytest.raises(ValueError, match="cannot serve"):
        decode.DecodeEngine(model, device="meta", warmup=False)


def test_server_reports_attached_engine(greedy_pair):
    _, te = greedy_pair
    server = serving.ModelServer()
    try:
        server.attach_engine(te)
        assert server.engines() == ["tg"]
        stats = server.stats()["engines"]["tg"]
        assert stats["kv_capacity"] == te.kv_stats()["num_blocks"]
        assert server.health("tg") == "HEALTHY"
        assert server.detach_engine("tg") is te
    finally:
        server.stop()
    assert te.submit([1, 2], 2).result().status == "OK"   # not stopped


def test_prefill_only_tier_hands_streams_to_a_decode_engine(models,
                                                             greedy_pair):
    """A prefill-only engine runs the prompt, emits the first token and
    hands the stream (pages, cursor, sampler) to a decode engine through
    its ``set_handoff`` sink; the stream finishes as the reference."""
    _, tm = models
    _, te = greedy_pair
    kw = dict(max_slots=2, block_size=4, max_prompt_len=16,
              max_new_tokens=24, warmup=False)
    pre = decode.DecodeEngine(tm, name="pre", prefill_only=True,
                              prefill_chunk=4, **kw)
    # the decode tier holds all four streams' worst-case blocks at once
    dec = decode.DecodeEngine(tm, name="dec", prefill_chunk=4,
                              **dict(kw, max_slots=4))
    with pytest.raises(ValueError, match="prefill_chunk"):
        decode.DecodeEngine(tm, prefill_only=True, warmup=False, **{
            k: v for k, v in kw.items() if k != "warmup"})
    with pytest.raises(MXNetError, match="prefill_only"):
        dec.set_handoff(lambda stream, snap: True)

    def sink(stream, snap):
        stream.set_owner("decode-tier")
        dec.import_stream(snap, stream=stream, owner="decode-tier")
        return True

    pre.set_handoff(sink)
    prompts, budgets = _prompts(4, seed=2)
    try:
        streams = [pre.submit(p, max_new_tokens=b, timeout_ms=60000)
                   for p, b in zip(prompts, budgets)]
        for s in streams:
            assert s.wait(60) and s.status == "OK", s
        # a chunked engine's reference: the same [1, C] chunk signature
        assert [s.tokens() for s in streams] == [
            dec.generate_reference(p, b).tolist()
            for p, b in zip(prompts, budgets)]
        moved = sum(b > 1 for b in budgets)
        assert pre.stats_snapshot()["handed_off"] == moved
        assert dec.stats_snapshot()["imported"] == moved
    finally:
        pre.stop()
        dec.stop()
    assert _leak(pre) == (0, 0, 0) and _leak(dec) == (0, 0, 0)


def test_routing_signals_and_snapshots_carry_the_jax_keys(greedy_pair):
    je, te = greedy_pair
    assert set(te.routing_signals()) == set(je.routing_signals())
    assert set(te.stats_snapshot()) == set(je.stats_snapshot()) | {
        "captures"}
    assert set(te.kv_stats()) == set(je.kv_stats())
    sig = te.routing_signals()
    assert sig["kv_capacity"] == je.routing_signals()["kv_capacity"]
    assert sig["kv_block_bytes"] == je.routing_signals()["kv_block_bytes"]
    assert te.capture_stats()["captures"] == 0     # the CPU runs eagerly


# ---------------------------------------------------------------------------
# the engine's own behaviour (cf. tests/test_decode.py)
# ---------------------------------------------------------------------------

def _small_engine(name, seed=1, max_len=48, **kw):
    model = decode.TinyCausalLM(vocab_size=16, hidden=16, num_layers=1,
                                num_heads=2, max_len=max_len, seed=seed,
                                device="cpu")
    return decode.DecodeEngine(model, name=name, **kw)


def test_streaming_iterator_and_callback_deliver_every_token(greedy_pair):
    _, te = greedy_pair
    seen = []
    stream = te.submit([9, 8, 7], max_new_tokens=6, timeout_ms=30000,
                       on_token=seen.append)
    got = list(stream)
    assert stream.status == "OK"
    assert got == stream.tokens() == seen and len(got) == 6
    assert list(stream) == got
    assert stream.latency_ms >= stream.ttft_ms


def test_deadline_mid_stream_keeps_a_prefix_of_the_reference(greedy_pair):
    _, te = greedy_pair
    ref = te.generate_reference([2, 4, 6], 24).tolist()
    stream = te.generate([2, 4, 6], max_new_tokens=24, timeout_ms=4)
    assert stream.status == "TIMEOUT"
    assert stream.tokens() == ref[:len(stream.tokens())]
    assert len(stream.tokens()) < 24


def test_static_scheduling_gives_the_continuous_tokens(models, greedy_pair):
    _, te = greedy_pair
    static = decode.DecodeEngine(models[1], name="st", scheduling="static",
                                 **ENGINE_KW)
    try:
        prompts, budgets = _prompts(12, seed=3)
        assert _run_streams(static, prompts, budgets) == \
            _run_streams(te, prompts, budgets)
        assert static.stats_snapshot()["scheduling"] == "static"
    finally:
        static.stop()
    with pytest.raises(ValueError, match="scheduling"):
        decode.DecodeEngine(models[1], scheduling="fifo", warmup=False)


def test_pool_exhaustion_sheds_overloaded_and_recovers():
    # 9 allocatable blocks: one worst-case stream reserves them all
    eng = _small_engine("tiny", max_slots=2, block_size=4, num_blocks=10,
                        max_prompt_len=4, max_new_tokens=32, warmup=False)
    try:
        joined = threading.Event()
        release = threading.Event()

        def hold(tok):       # keeps the first stream's blocks reserved
            joined.set()
            release.wait(10)

        s1 = eng.submit([1, 2, 3, 4], max_new_tokens=32, timeout_ms=30000,
                        on_token=hold)
        assert joined.wait(10)
        s2 = eng.submit([1], max_new_tokens=8)
        assert s2.status == "OVERLOADED" and "KV blocks" in s2.error
        release.set()
        assert s1.result().status == "OK"
        assert eng.generate([2, 3], max_new_tokens=4).status == "OK"
        snap = eng.stats_snapshot()
        assert snap["shed"] == 1 and snap["ok"] == 2
        big = _small_engine("tiny2", max_slots=1, block_size=4, num_blocks=3,
                            max_prompt_len=8, max_new_tokens=16,
                            warmup=False)
        try:
            stream = big.submit(list(range(8)), max_new_tokens=16)
            assert stream.status == "INVALID_INPUT" and "pool" in stream.error
        finally:
            big.stop()
    finally:
        release.set()
        eng.stop()
    assert _leak(eng) == (0, 0, 0)


def test_stop_drains_streams_unavailable_and_pool_whole():
    eng = _small_engine("drain", max_slots=2, block_size=4,
                        max_prompt_len=4, max_new_tokens=16, warmup=False)
    streams = [eng.submit([1, 2], max_new_tokens=16, on_token=lambda t:
                          time.sleep(0.002)) for _ in range(6)]
    eng.stop()
    for s in streams:
        assert s.wait(10)
        assert s.status in ("OK", "UNAVAILABLE"), s
    assert any(s.status == "UNAVAILABLE" for s in streams)
    snap = eng.stats_snapshot()
    assert snap["requests"] == snap["ok"] + snap["timeouts"] \
        + snap["errors"] + snap["unavailable"]
    assert _leak(eng) == (0, 0, 0)
    assert eng.submit([1]).status == "UNAVAILABLE"


def test_eos_ends_a_stream_at_the_token(models):
    _, tm = models
    with decode.DecodeEngine(tm, name="noeos", warmup=False, **dict(
            ENGINE_KW, max_slots=2)) as plain:
        ref = plain.generate_reference([3, 1, 4], 12).tolist()
    eos = decode.TinyCausalLM(device="cpu", eos_id=ref[4],
                              params=tm.param_dict(), **{
                                  k: v for k, v in MODEL_KW.items()
                                  if k != "seed"})
    eng = decode.DecodeEngine(eos, name="eos", warmup=False,
                              **dict(ENGINE_KW, max_slots=2))
    try:
        stream = eng.generate([3, 1, 4], max_new_tokens=12)
        assert stream.status == "OK"
        assert stream.tokens() == ref[:ref.index(ref[4]) + 1]
        assert stream.tokens() == eng.generate_reference([3, 1, 4],
                                                         12).tolist()
    finally:
        eng.stop()
