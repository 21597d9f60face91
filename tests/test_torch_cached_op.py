"""mxnet_tpu_torch.cached_op and HybridBlock.hybridize() on the CPU.

Mirrors tests/test_serving.py::test_cached_op_cache_stats_counts_signatures
(the signature counts of one call sequence, dict for dict), tests/
test_gluon.py's hybridize tests (:43, :60, :292: hybridized against eager,
outputs and gradients, at the JAX tests' own bounds), BatchNorm's running
statistics after hybridized training calls, outputs that follow
``Parameter.set_data`` and ``cast``, and the serving registry's warmup
report.  On the CPU a CachedOp runs its forward eagerly on every call; the
CUDA-graph capture runs on the card (chip_smoke.py: hybrid_serve,
hybrid_lm_train, hybrid_resnet_train).  Both packages get the same weights
and inputs, from a seeded numpy RandomState.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jax_autograd
from mxnet_tpu import serving as jax_serving
from mxnet_tpu.gluon import nn as jax_nn

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, serving
from mxnet_tpu_torch.cached_op import CachedOp
from mxnet_tpu_torch.gluon import HybridBlock, nn

# tests/test_gluon.py:292-301, the hybridize bound; :60-78 for gradients
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """The bitwise comparisons run the port on one CPU thread: with
    several, oneDNN's and MKL's reductions can split the work differently
    from one process to the next."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxPoolMLP(mx.gluon.HybridBlock):
    """tests/test_serving.py's PoolMLP: (B, L, F) -> mean over L -> MLP."""

    def __init__(self, feat=8, hidden=16, classes=4, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.h = jax_nn.Dense(hidden, activation="relu", in_units=feat)
            self.out = jax_nn.Dense(classes, in_units=hidden)

    def hybrid_forward(self, F, x):
        return self.out(self.h(F.mean(x, axis=1)))


class PoolMLP(HybridBlock):
    def __init__(self, feat=8, hidden=16, classes=4, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.h = nn.Dense(hidden, activation="relu", in_units=feat,
                              device="cpu")
            self.out = nn.Dense(classes, in_units=hidden, device="cpu")

    def forward(self, x):
        return self.out(self.h(x.mean(dim=1)))


def _copy_weights(jax_net, net):
    """The JAX block's values into the port block, by Gluon name."""
    values = {n: p.data().asnumpy()
              for n, p in jax_net.collect_params().items()}
    for name, p in net.collect_params().items():
        p.set_data(torch.from_numpy(values[name].copy()))


def _pool_pair():
    mx.random.seed(3)
    jnet = JaxPoolMLP(prefix="pool_")
    jnet.initialize(mx.init.Xavier())
    net = PoolMLP(prefix="pool_")
    net.initialize(tmx.init.Xavier(), ctx="cpu")
    _copy_weights(jnet, net)
    return jnet, net


def _mlp_pair(bn=False):
    """tests/test_gluon.py's hybridize MLP (Dense relu -> [BatchNorm] ->
    Dense), the same weights in both packages."""
    jnet, net = jax_nn.HybridSequential(prefix="mlp_"), \
        nn.HybridSequential(prefix="mlp_")
    with jnet.name_scope():
        jnet.add(jax_nn.Dense(8, activation="relu", in_units=5))
        if bn:
            jnet.add(jax_nn.BatchNorm(in_channels=8))
        jnet.add(jax_nn.Dense(2, in_units=8))
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu", in_units=5, device="cpu"))
        if bn:
            net.add(nn.BatchNorm(in_channels=8, device="cpu"))
        net.add(nn.Dense(2, in_units=8, device="cpu"))
    mx.random.seed(5)
    jnet.initialize(mx.init.Xavier())
    net.initialize(tmx.init.Xavier(), ctx="cpu")
    _copy_weights(jnet, net)
    return jnet, net


def test_cache_stats_equal_the_jax_cached_ops():
    """tests/test_serving.py:232's call sequence through both packages'
    CachedOps: the same signature strings and counts."""
    jnet, net = _pool_pair()
    jnet.hybridize()
    net.hybridize()
    seen = []
    for shape in [(1, 4, 8), (1, 4, 8), (2, 4, 8)]:
        jnet(mx.nd.zeros(shape))
        net(torch.zeros(shape))
        seen.append((jnet._cached_op.cache_stats(),
                     net._cached_op.cache_stats()))
    for jstats, stats in seen:
        assert stats == jstats
    assert stats["misses"] == 2 and stats["hits"] == 1
    assert any(s.startswith("infer|") for s in stats["signatures"])
    net._cached_op.reset_cache_stats()
    jnet._cached_op.reset_cache_stats()
    assert net._cached_op.cache_stats() == jnet._cached_op.cache_stats()
    assert net._cached_op.cache_stats()["misses"] == 0
    with autograd.record():
        net(torch.zeros((1, 4, 8)))
    assert list(net._cached_op.cache_stats()["signatures"]) == \
        ["train|float32[1,4,8]"]


def test_hybridized_outputs_match_eager_and_the_jax_hybridized_block():
    jnet, net = _mlp_pair()
    x = np.random.RandomState(0).uniform(-1, 1, (4, 5)).astype(np.float32)
    eager = net(torch.from_numpy(x))
    net.hybridize()
    jnet.hybridize()
    hybrid = net(torch.from_numpy(x))
    again = net(tmx.nd.array(x, ctx=tmx.cpu()))
    assert torch.equal(eager, hybrid)
    assert isinstance(again, tmx.nd.NDArray)
    assert torch.equal(again._data, hybrid)
    want = jnet(mx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(hybrid.numpy(), want, rtol=RTOL, atol=ATOL)
    assert net._cached_op.cache_stats()["hits"] == 1


def test_hybridize_takes_mxnets_static_keywords():
    """``static_alloc``/``static_shape`` are accepted and ignored (a
    captured graph's memory is static already): the block's outputs equal
    the JAX block's hybridized with the same keywords, through one op."""
    jnet, net = _mlp_pair()
    x = np.random.RandomState(1).uniform(-1, 1, (4, 5)).astype(np.float32)
    net.hybridize(static_alloc=True, static_shape=True)
    jnet.hybridize(static_alloc=True, static_shape=True)
    got = net(torch.from_numpy(x))
    want = jnet(mx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert net._cached_op.cache_stats()["misses"] == 1


def test_hybridized_gradients_match_eager_and_the_jax_hybridized_block():
    jnet, net = _mlp_pair()
    x = np.random.RandomState(1).uniform(-1, 1, (4, 5)).astype(np.float32)

    def grads(hybridize):
        net.hybridize(hybridize)
        for p in net.parameters():
            p.grad = None
        with autograd.record():
            loss = (net(torch.from_numpy(x)) ** 2).sum()
        loss.backward()
        return {n: p.grad().asnumpy().copy()
                for n, p in net.collect_params().items()}

    eager, hybrid = grads(False), grads(True)
    jnet.hybridize()
    xj = mx.nd.array(x)
    with jax_autograd.record():
        jloss = (jnet(xj) ** 2).sum()
    jloss.backward()
    for name, p in jnet.collect_params().items():
        assert np.array_equal(hybrid[name], eager[name]), name
        np.testing.assert_allclose(hybrid[name], p.grad().asnumpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    assert net._cached_op.cache_stats()["signatures"] == {
        "train|float32[4,5]": {"hits": 0, "misses": 1}}


def test_batchnorm_running_stats_after_hybridized_training_calls():
    jnet, net = _mlp_pair(bn=True)
    _, eager_net = _mlp_pair(bn=True)
    rng = np.random.RandomState(2)
    xs = [rng.uniform(-1, 1, (6, 5)).astype(np.float32) for _ in range(3)]
    net.hybridize()
    jnet.hybridize()
    for x in xs:
        for block, wrap, rec in ((net, torch.from_numpy, autograd.record),
                                 (eager_net, torch.from_numpy,
                                  autograd.record),
                                 (jnet, mx.nd.array, jax_autograd.record)):
            with rec():
                block(wrap(x))
    stats = {n: p.data().asnumpy() for n, p in net.collect_params().items()
             if "running" in n}
    assert len(stats) == 2
    for name, value in stats.items():
        assert np.array_equal(
            value, eager_net.collect_params()[name].data().asnumpy()), name
        np.testing.assert_allclose(
            value, jnet.collect_params()[name].data().asnumpy(), rtol=RTOL,
            atol=ATOL, err_msg=name)
        assert not np.allclose(value, 0.0 if "mean" in name else 1.0)
    # the captured op lists exactly the running statistics as aux
    assert sorted(net._cached_op._aux_names) == sorted(stats)


def test_outputs_follow_set_data_and_cast():
    _, net = _mlp_pair()
    x = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (4, 5)).astype(np.float32))
    net.hybridize()
    before = net(x)
    net.collect_params()["mlp_dense0_weight"].set_data(torch.zeros(8, 5))
    after = net(x)
    with torch.no_grad():
        want = net[1](torch.relu(torch.zeros(4, 8) + net[0].bias))
    assert torch.equal(after, want)
    assert not torch.equal(after, before)
    op = net._cached_op
    net.cast("bfloat16")
    assert net._cached_op is None         # a cast drops the op
    out = net(x.bfloat16())
    assert out.dtype == torch.bfloat16 and net._cached_op is not op
    net.hybridize(False)
    assert torch.equal(out, net(x.bfloat16()))


def test_cached_op_keeps_the_jax_signature_format():
    op = CachedOp(lambda p, x, y: x + p["w"] * y, {"w": torch.ones(3)})
    op({"w": torch.ones(3)}, torch.zeros(2, 3), torch.zeros(2, 3))
    with autograd.train_mode():
        op({"w": torch.ones(3)}, torch.zeros(2, 3, dtype=torch.bfloat16),
           torch.zeros(2, 3))
    assert sorted(op.cache_stats()["signatures"]) == [
        "infer|float32[2,3]|float32[2,3]",
        "train|bfloat16[2,3]|float32[2,3]"]
    assert CachedOp._signature(False, [np.zeros((4, 16), np.float32)]) == \
        "infer|float32[4,16]"


def test_registry_warmup_report_matches_the_jax_registry():
    jnet, net = _pool_pair()
    shapes = [(4, 8), (6, 8)]
    reports = []
    for server, block, kw in ((jax_serving.ModelServer(), jnet, {}),
                              (serving.ModelServer(), net,
                               {"device": "cpu"})):
        try:
            server.load_model("m", block, input_shapes=shapes, max_batch=4,
                              batch_ladder=[1, 4], warmup=True, **kw)
            x = np.random.RandomState(4).randn(4, 8).astype(np.float32)
            res = server.predict("m", x, timeout_ms=20000)
            assert res.status == serving.OK
            snap = server.stats()["models"]["m"]
            reports.append((snap["warmup"], snap["cache"], res.output))
        finally:
            server.stop()
    (jwarm, jcache, jout), (warm, cache, out) = reports
    assert warm == jwarm == {"signatures": 4, "compiles": 4,
                             "cache": {"hits": 0, "misses": 4}}
    assert cache["recompiles"] == jcache["recompiles"] == 4
    np.testing.assert_allclose(out, jout, rtol=RTOL, atol=ATOL)
