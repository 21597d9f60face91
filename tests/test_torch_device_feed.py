"""mxnet_tpu_torch.io.DeviceFeed's lifecycle on the CPU, and the paths that
stage through it, held to mxnet_tpu.

The DeviceFeed cases of tests/test_input_pipeline.py:35-135 run on the
port: order and conservation, structure, the transform, the caller's
context taken at construction, a worker's error raised after the good
prefix (and again), a deterministic and idempotent ``close()``, an
abandoned iterator collected with its thread, a bad depth refused, and
``mesh=`` refused (ROADMAP queue 1 #8); the counters reach the profiler.
``DataLoader(prefetch_to_device=cpu)`` and ``pin_memory`` give the sync
path's batches, and ``Module.fit(prefetch_to_device=cpu)`` ends one epoch
on the JAX package's parameters within tests/test_torch_module.py's bound
(``rtol=2e-4, atol=2e-5``).  The copies to the card, the side stream and
``record_stream`` run only there (``chip_smoke.py`` phase
``feed_card_checks``).
"""
import gc
import json
import weakref

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.io import DeviceFeed
from test_torch_module import ATOL, RTOL, _blobs, _fit, _mlp, _params

CPU = tmx.cpu()


def test_feed_keeps_order_and_counts_batches():
    src = [np.full((4,), i, np.float32) for i in range(10)]
    with DeviceFeed(src, ctx=CPU, depth=2) as feed:
        out = [x.numpy() for x in feed]
    assert [b[0] for b in out] == list(range(10))
    stats = feed.stats()
    assert stats["batches"] == 10 and stats["max_queue_depth"] >= 1
    assert stats["h2d_ms"] >= 0.0 and stats["starved_ms"] >= 0.0


def test_feed_keeps_the_batch_structure():
    batch = (tmx.nd.ones((2, 3), ctx=CPU), np.arange(2, dtype=np.float32),
             {"k": torch.zeros(1)}, "meta")
    (a, b, c, d), = list(DeviceFeed([batch], ctx=CPU))
    assert isinstance(a, tmx.nd.NDArray) and a.context == CPU
    assert isinstance(b, torch.Tensor) and b.tolist() == [0.0, 1.0]
    assert isinstance(c["k"], torch.Tensor) and d == "meta"
    db = tmx.io.DataBatch(data=[tmx.nd.ones((2, 2), ctx=CPU)],
                          label=[tmx.nd.zeros((2,), ctx=CPU)], pad=1)
    staged, = list(DeviceFeed([db], ctx=CPU))
    assert staged.pad == 1 and isinstance(staged.data[0], tmx.nd.NDArray)


def test_feed_takes_the_callers_context_at_construction():
    with tmx.cpu():
        feed = DeviceFeed([tmx.nd.ones((2, 2), ctx=CPU)])
    staged, = list(feed)
    assert staged.context == CPU
    pinned, = list(DeviceFeed([tmx.nd.ones((2,), ctx=CPU)],
                              ctx=tmx.cpu_pinned()))
    assert pinned.context == CPU   # page-locked only where CUDA runs


def test_feed_runs_the_transform_before_staging():
    feed = DeviceFeed([1, 2, 3], ctx=CPU,
                      transform=lambda i: np.full((2,), i * 10, np.float32))
    assert [x[0].item() for x in feed] == [10.0, 20.0, 30.0]


def test_a_worker_error_follows_the_good_prefix_and_sticks():
    def src():
        yield np.zeros((2,), np.float32)
        yield np.ones((2,), np.float32)
        raise ValueError("decode exploded")
    it = iter(DeviceFeed(src(), ctx=CPU))
    next(it)
    next(it)
    for _ in range(2):
        with pytest.raises(ValueError, match="decode exploded"):
            next(it)


def test_close_mid_epoch_is_deterministic_and_idempotent():
    feed = DeviceFeed((np.zeros((2,), np.float32) for _ in range(1000)),
                      ctx=CPU, depth=1)
    it = iter(feed)
    next(it)
    feed.close()
    feed.close()
    assert not feed._thread.is_alive()
    with pytest.raises((StopIteration, RuntimeError)):
        next(it)


def test_an_abandoned_feed_is_collected_with_its_thread():
    ds = tmx.gluon.data.ArrayDataset(np.zeros((100, 3), np.float32),
                                     np.arange(100, dtype=np.float32))
    loader = tmx.gluon.data.DataLoader(ds, batch_size=2,
                                       prefetch_to_device=CPU)
    it = iter(loader)
    next(it)
    thread = it._thread
    ref = weakref.ref(it)
    del it
    gc.collect()
    assert ref() is None
    thread.join(5.0)
    assert not thread.is_alive()
    loader.close()


def test_bad_depth_and_mesh_are_refused():
    with pytest.raises(ValueError):
        DeviceFeed([], ctx=CPU, depth=0)
    with pytest.raises(MXNetError, match="#8"):
        DeviceFeed([], ctx=CPU, mesh=object())
    with pytest.raises(MXNetError, match="#8"):
        tmx.io.stage_batch(np.zeros(2), ctx=CPU, mesh=object())


def test_feed_counters_reach_the_profiler(tmp_path):
    trace = tmp_path / "feed.json"
    profiler.set_config(filename=str(trace))
    profiler.set_state("run")
    try:
        with DeviceFeed([np.full((4,), i, np.float32) for i in range(6)],
                        ctx=CPU) as feed:
            list(feed)
    finally:
        profiler.set_state("stop")
    profiler.dump()
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]
             if e.get("ph") == "C"}
    assert {"feed:queue_depth", "feed:h2d_ms"} <= names


def _dataset(n=23):
    rng = np.random.RandomState(12)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randint(0, 4, n).astype(np.float32))


@pytest.mark.parametrize("feed", ["prefetch_to_device", "pin_memory"])
def test_dataloader_feed_paths_equal_the_sync_path(feed):
    X, Y = _dataset()
    kw = ({"prefetch_to_device": CPU} if feed == "prefetch_to_device"
          else {"pin_memory": True})
    out = {}
    for name, extra in (("sync", {}), ("feed", kw)):
        tmx.random.seed(13)
        with tmx.gluon.data.DataLoader(
                tmx.gluon.data.ArrayDataset(X, Y), batch_size=5,
                shuffle=True, **extra) as loader:
            it = iter(loader)
            out[name] = [(x.asnumpy(), y.asnumpy()) for x, y in it]
            if name == "feed":
                assert it.stats()["batches"] == 5
    mx.random.seed(13)
    want = [(x.asnumpy(), y.asnumpy()) for x, y in mx.gluon.data.DataLoader(
        mx.gluon.data.ArrayDataset(X, Y), batch_size=5, shuffle=True)]
    for got in (out["feed"], out["sync"]):
        assert len(got) == len(want) == 5
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_dataloader_prefetch_to_device_is_type_checked():
    X, Y = _dataset()
    with pytest.raises(TypeError):
        tmx.gluon.data.DataLoader(tmx.gluon.data.ArrayDataset(X, Y),
                                  batch_size=5, prefetch_to_device=3)


@pytest.mark.parametrize("compiled", [False, True],
                         ids=["eager", "compiled"])
def test_module_fit_through_the_feed_follows_the_jax_package(compiled):
    data, labels = _blobs(256)
    jmod, _ = _fit(mx, _mlp, data, labels, 1, 21, 0.1, 32,
                   prefetch_to_device=mx.cpu(0))
    mod, _ = _fit(tmx, _mlp, data, labels, 1, 21, 0.1, 32,
                  prefetch_to_device=CPU, compiled=compiled)
    assert mod.feed_stats["batches"] == 8
    want, got = _params(jmod), _params(mod)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
