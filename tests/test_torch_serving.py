"""mxnet_tpu_torch.serving: the port's ModelServer on the CPU.

Mirrors the tests/test_serving.py behaviours that do not depend on CachedOp,
export, the profiler or decode engines (coalescing, deadlines, shedding,
shape menu, lifecycle), on the small port TransformerLM served with
``device="cpu"``.  The slice check: served logits equal the JAX
ModelServer's for the same weights and tokens (<= 1e-4, fp32 sums in
another order), and each served row equals the port model's own one-row
forward (<= 1e-5: a padded batch changes matmul blocking, not the math).
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as jax_serving
from mxnet_tpu_torch import MXNetError, serving
from mxnet_tpu_torch.convert import load_mxnet_params
from mxnet_tpu_torch.models import TransformerLM

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "example", "gluon"))
from transformer_lm import TransformerLM as JaxLM  # noqa: E402
from test_torch_training import initialized_lm  # noqa: E402

VOCAB, DIM, HEADS, DEPTH, MAX_LEN = 16, 64, 4, 2, 64
T = 8
LM_DTYPES = ("int32", "int32")


def _make_net(seed=0):
    net = TransformerLM(VOCAB, dim=DIM, heads=HEADS, depth=DEPTH,
                        max_len=MAX_LEN, device="cpu")
    return initialized_lm(net, seed)


def _request(rng, length=T):
    return (rng.randint(0, VOCAB, length).astype(np.int32),
            np.arange(length, dtype=np.int32))


def _reference(net, request):
    """Unbatched eager forward for one request."""
    with torch.inference_mode():
        return net(*(torch.from_numpy(a)[None] for a in request))[0].numpy()


def _load(server, net, shapes=(T,), **kw):
    kw.setdefault("device", "cpu")
    return server.load_model("m", net, input_shapes=[((s,), (s,))
                                                     for s in shapes],
                             dtype=LM_DTYPES, **kw)


def test_concurrent_clients_coalesce_into_shared_batches():
    net = _make_net()
    server = serving.ModelServer()
    _load(server, net, max_batch=8, batch_ladder=[1, 8], linger_ms=60.0)
    rng = np.random.RandomState(0)
    reqs = [_request(rng) for _ in range(8)]
    results = [None] * len(reqs)
    barrier = threading.Barrier(len(reqs))

    def client(i):
        barrier.wait()
        results[i] = server.predict("m", reqs[i], timeout_ms=5000)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    snap = server.stats()["models"]["m"]
    server.stop()
    for i, res in enumerate(results):
        assert res.status == serving.OK, res
        np.testing.assert_allclose(res.output, _reference(net, reqs[i]),
                                   rtol=1e-5, atol=1e-5)
    assert 1 <= snap["batches"] < len(reqs)
    assert snap["avg_batch"] > 1.0
    assert snap["warmup"] == {"signatures": 2, "compiles": 2,
                              "cache": {"hits": 0, "misses": 2}}
    assert snap["cache"]["recompiles"] == snap["warmup"]["compiles"]


def test_deadline_expiry_returns_timeout_status():
    server = serving.ModelServer()
    _load(server, _make_net(), max_batch=2, linger_ms=1.0, warmup=False)
    server.pause("m")                       # worker idles; request ages out
    res = server.predict("m", _request(np.random.RandomState(1)),
                         timeout_ms=30)
    server.resume("m")
    snap = server.stats()["models"]["m"]
    server.stop()
    assert res.status == serving.TIMEOUT
    assert res.outputs is None
    assert snap["timeouts"] == 1
    assert snap["ok"] == 0


def test_overload_sheds_instead_of_queueing_unboundedly():
    server = serving.ModelServer()
    _load(server, _make_net(), max_batch=2, linger_ms=1.0, max_queue=4,
          warmup=False)
    server.pause("m")
    x = _request(np.random.RandomState(2))
    handles = [server.predict_async("m", x) for _ in range(4)]
    assert all(isinstance(h, serving.Request) for h in handles)
    shed = server.predict("m", x)
    assert shed.status == serving.OVERLOADED
    assert server.stats()["models"]["m"]["shed"] == 1
    server.resume("m")
    results = [server.result("m", h) for h in handles]
    snap = server.stats()["models"]["m"]
    server.stop()
    assert all(r.status == serving.OK for r in results)
    assert snap["ok"] == 4 and snap["shed"] == 1
    assert snap["queue_depth"] == 0


def test_unlisted_shape_rejected_before_it_runs():
    server = serving.ModelServer()
    _load(server, _make_net(), max_batch=2, warmup=False)
    res = server.predict("m", _request(np.random.RandomState(3), T + 1))
    snap = server.stats()["models"]["m"]
    server.stop()
    assert res.status == serving.INVALID_INPUT
    assert "bucket menu" in res.error
    assert snap["invalid"] == 1
    assert snap["batches"] == 0


def test_duplicate_load_fails_fast_and_keeps_original_serving():
    server = serving.ModelServer()
    _load(server, _make_net(), max_batch=2, warmup=False)
    with pytest.raises(MXNetError, match="already loaded"):
        _load(server, _make_net(1), max_batch=2, warmup=False)
    res = server.predict("m", _request(np.random.RandomState(4)),
                         timeout_ms=5000)
    server.stop()
    assert res.status == serving.OK


def test_malformed_payload_is_a_status_not_an_exception():
    server = serving.ModelServer()
    _load(server, _make_net(), max_batch=2, warmup=False)
    # one input for a 2-input model: status, not ValueError
    res = server.predict("m", np.zeros((T,), np.int32))
    snap = server.stats()["models"]["m"]
    server.stop()
    assert res.status == serving.INVALID_INPUT
    assert "input" in res.error
    assert snap["invalid"] == 1


def test_bucket_ladder_rungs_and_lookup():
    ladder = serving.BucketLadder(max_batch=8)
    assert list(ladder) == [1, 2, 4, 8]
    assert [ladder.bucket(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    custom = serving.BucketLadder(max_batch=6, sizes=[1, 3, 6])
    assert list(custom) == [1, 3, 6] and custom.bucket(4) == 6
    with pytest.raises(ValueError):
        serving.BucketLadder(sizes=[0, 2])


def test_multi_input_model_batches_all_inputs():
    """Both inputs of the LM (tokens, positions) are stacked and padded
    together; a shifted position row changes the output as it should."""
    net = _make_net()
    server = serving.ModelServer()
    _load(server, net, max_batch=4, batch_ladder=[1, 4], linger_ms=30.0)
    rng = np.random.RandomState(5)
    tok = rng.randint(0, VOCAB, T).astype(np.int32)
    reqs = [(tok, np.arange(T, dtype=np.int32) + shift) for shift in (0, 3)]
    handles = [server.predict_async("m", r, timeout_ms=5000) for r in reqs]
    results = [server.result("m", h) for h in handles]
    server.stop()
    for r, res in zip(reqs, results):
        assert res.status == serving.OK
        np.testing.assert_allclose(res.output, _reference(net, r),
                                   rtol=1e-5, atol=1e-5)
    assert np.abs(results[0].output - results[1].output).max() > 1e-3


def test_shutdown_during_inflight_requests_is_clean_unavailable():
    server = serving.ModelServer()
    model = _load(server, _make_net(), max_batch=4, max_queue=64,
                  linger_ms=1.0)
    server.pause("m")
    x = _request(np.random.RandomState(6))
    handles = [server.predict_async("m", x) for _ in range(6)]
    assert all(not isinstance(h, serving.InferenceResult) for h in handles)
    resolved = {}
    threads = []

    def waiter(i, h):
        resolved[i] = server.result("m", h)

    for i, h in enumerate(handles[:3]):
        t = threading.Thread(target=waiter, args=(i, h))
        t.start()
        threads.append(t)
    time.sleep(0.05)
    server.stop()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive(), "result() hung across shutdown"
    for i, h in enumerate(handles[3:], start=3):
        resolved[i] = server.result("m", h)
    assert len(resolved) == len(handles)
    for i, res in resolved.items():
        assert res.status == serving.UNAVAILABLE, (i, res)
        assert res.outputs is None
    assert server.predict("m", x, timeout_ms=50).status == serving.UNAVAILABLE
    snap = model.stats.snapshot()
    assert snap["requests"] == len(handles)
    assert snap["unavailable"] == len(handles)
    assert snap["requests"] == (snap["ok"] + snap["timeouts"]
                                + snap["errors"] + snap["unavailable"])


def test_result_with_never_loaded_name_raises_not_clobbers():
    server = serving.ModelServer()
    _load(server, _make_net(), max_batch=4, linger_ms=1.0)
    try:
        handle = server.predict_async("m", _request(np.random.RandomState(7)))
        with pytest.raises(MXNetError):
            server.result("nope", handle)
        assert server.result("m", handle).status == serving.OK
    finally:
        server.stop()


def test_stopped_server_refuses_new_loads():
    server = serving.ModelServer()
    server.stop()
    with pytest.raises(MXNetError):
        _load(server, _make_net())


def test_load_model_needs_cuda_or_explicit_cpu(monkeypatch):
    net = _make_net()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    server = serving.ModelServer()
    try:
        with pytest.raises(MXNetError, match="no CUDA device"):
            _load(server, net, device=None)
        assert server.models() == []
    finally:
        server.stop()


def test_served_logits_match_jax_model_server():
    """The slice end to end: the same weights and tokens through the JAX
    ModelServer and the port's give the same logits (<= 1e-4), and each
    served row equals the port model's one-row forward (<= 1e-5)."""
    mx.random.seed(11)
    jnet = JaxLM(VOCAB, dim=DIM, heads=HEADS, depth=DEPTH, max_len=MAX_LEN)
    jnet.initialize(mx.init.Xavier())
    zeros = mx.nd.array(np.zeros((1, T), np.int32), dtype="int32")
    jnet(zeros, zeros)
    tnet = TransformerLM(VOCAB, dim=DIM, heads=HEADS, depth=DEPTH,
                         max_len=MAX_LEN, device="cpu")
    load_mxnet_params(tnet, {n: p.data().asnumpy()
                             for n, p in jnet.collect_params().items()})
    rng = np.random.RandomState(12)
    reqs = [_request(rng) for _ in range(3)]

    def serve_all(server, net, **kw):
        server.load_model("lm", net, input_shapes=[((T,), (T,))],
                          dtype=LM_DTYPES, max_batch=4, batch_ladder=[4],
                          linger_ms=30.0, **kw)
        try:
            handles = [server.predict_async("lm", r, timeout_ms=30000)
                       for r in reqs]
            return [server.result("lm", h) for h in handles]
        finally:
            server.stop()

    jax_results = serve_all(jax_serving.ModelServer(), jnet)
    port_results = serve_all(serving.ModelServer(), tnet, device="cpu")
    for r, jres, pres in zip(reqs, jax_results, port_results):
        assert jres.status == pres.status == serving.OK
        assert pres.output.shape == (T, VOCAB)
        assert np.abs(pres.output - jres.output).max() <= 1e-4
        assert np.abs(pres.output - _reference(tnet, r)).max() <= 1e-5
