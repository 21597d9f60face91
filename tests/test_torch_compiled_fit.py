"""The port's compiled train step (``module/compiled_step.py``) on the CPU.

The port-side cases of tests/test_compiled_fit.py: compiled ``fit()``
bitwise equal to eager ``fit()`` (SGD with momentum, a small convnet),
one capture per signature and none in the steady state, no host fetch in
the step loop (``Tensor.item`` counted: only the metric syncs), the
``metric_interval`` cadence, ``steps_per_call`` windows (bitwise here: the
port's window runs the same microsteps in order), the train metric equal to
eager's, Adam with a scheduler at the JAX test's own bound (the bias
correction in fp32 on the device against float64 on the host), the two
fallbacks with their warning, a composite metric on the device, and inputs
bound by name.  Then the port against the JAX package: compiled ``fit`` of
both from one seed, and ``CompiledTrainStep.from_block`` of both on one
block, at tests/test_module.py's bound for two runs of one SGD trajectory.
On the CPU the step's CachedOp runs eagerly; on the card it is one CUDA
graph a window (chip_smoke.py: compiled_step, module_fit).
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer as topt

# tests/test_module.py::test_module_multi_device_training_matches_single
RTOL, ATOL = 2e-4, 2e-5
# tests/test_compiled_fit.py::test_compiled_fit_adam_and_scheduler_...
ADAM_RTOL, ADAM_ATOL = 3e-5, 3e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """The bitwise comparisons run the port on one CPU thread: with
    several, oneDNN's and MKL's reductions can split the work differently
    from one process to the next, and two runs of one eager fit then
    differ in the last bits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _convnet(pkg):
    sym = pkg.sym
    data = sym.Variable("data")
    net = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4,
                          name="conv1")
    net = sym.Activation(net, act_type="relu")
    net = sym.Pooling(net, global_pool=True, pool_type="avg", kernel=(1, 1))
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=10, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")


_B, _N = 8, 6   # batch size, batches per epoch
_RNG = np.random.RandomState(0)
_DATA = _RNG.uniform(-1, 1, (_B * _N, 3, 8, 8)).astype(np.float32)
_LABELS = _RNG.randint(0, 10, _B * _N).astype(np.float32)


def _module(pkg=tmx, labels=_LABELS):
    pkg.random.seed(77)
    kw = {"ctx": tmx.cpu()} if pkg is tmx else {}
    it = pkg.io.NDArrayIter(_DATA, labels, batch_size=_B, **kw)
    with pkg.name.NameManager():
        net = _convnet(pkg)
    return pkg.mod.Module(net, context=pkg.cpu()), it


def _fit(compiled, num_epoch=2, eval_metric="acc", opt="sgd",
         opt_params=None, pkg=tmx, **kw):
    mod, it = _module(pkg)
    mod.fit(it, num_epoch=num_epoch, optimizer=opt,
            optimizer_params=dict(
                opt_params or {"learning_rate": 0.1, "momentum": 0.9}),
            eval_metric=eval_metric, initializer=pkg.init.Xavier(),
            compiled=compiled, **kw)
    args, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in args.items()}


def test_compiled_fit_bitwise_parity_with_eager():
    mod_c, params_c = _fit(True)
    assert mod_c._compiled_step is not None, "compiled path did not engage"
    mod_e, params_e = _fit(False)
    assert mod_e._compiled_step is None
    for name in params_e:
        assert np.array_equal(params_c[name], params_e[name]), name


def test_compiled_fit_zero_steady_state_captures():
    counts = []
    mod, it = _module()
    mod.fit(it, num_epoch=3, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1}, eval_metric="acc",
            initializer=tmx.init.Xavier(),
            epoch_end_callback=lambda *a: counts.append(
                mod._compiled_step.cache_stats()["recompiles"]))
    stats = mod._compiled_step.cache_stats()
    assert len(stats["signatures"]) == 1, stats
    assert stats["recompiles"] == 1, stats
    assert counts == [1, 1, 1]
    assert stats["hits"] == 3 * _N - 1, stats


def _counted_fit(compiled, num_epoch, **kw):
    """fit() alone with ``Tensor.item`` (every host fetch of the port's
    metrics and step) counted."""
    counts = {"n": 0}
    item = torch.Tensor.item

    def counted(self):
        counts["n"] += 1
        return item(self)

    mod, it = _module()
    torch.Tensor.item = counted
    try:
        mod.fit(it, num_epoch=num_epoch, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                eval_metric="acc", initializer=tmx.init.Xavier(),
                compiled=compiled, **kw)
    finally:
        torch.Tensor.item = item
    return mod, counts["n"]


def test_compiled_fit_no_host_fetch_inside_step_loop():
    mod, compiled_fetches = _counted_fit(True, 2)
    assert mod._compiled_step is not None
    _, eager_fetches = _counted_fit(False, 2)
    # compiled: only the metric sync at each epoch's end (sum and count)
    assert compiled_fetches == 2 * 2, compiled_fetches
    # eager: at least one fetch a batch
    assert eager_fetches >= 2 * _N, eager_fetches


def test_compiled_fit_metric_interval_bounds_fetch_cadence():
    mod, fetches = _counted_fit(True, 1, metric_interval=2)
    assert mod._compiled_step is not None
    # 6 batches, interval 2: syncs after batches 2, 4 and 6
    assert fetches == 3 * 2, fetches


def test_compiled_fit_steps_per_call_window_equivalence():
    _, params_1 = _fit(True, steps_per_call=1)
    mod_4, params_4 = _fit(True, steps_per_call=4)
    # 6 batches: windows of 4 and 2, two signatures, stable over epochs
    stats = mod_4._compiled_step.cache_stats()
    assert len(stats["signatures"]) == 2, stats
    assert stats["recompiles"] == 2, stats
    for name in params_1:
        assert np.array_equal(params_1[name], params_4[name]), name


def test_compiled_fit_train_metric_matches_eager():
    got = {}
    for compiled in (True, False):
        mod, it = _module()
        seen = []
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                eval_metric="acc", initializer=tmx.init.Xavier(),
                compiled=compiled,
                batch_end_callback=lambda p: seen.append(
                    (p.epoch, p.nbatch, p.eval_metric.get()[1],
                     p.eval_metric.num_inst)))
        got[compiled] = seen
    assert len(got[True]) == len(got[False])
    for epoch in (0, 1):
        last_c = [s for s in got[True] if s[0] == epoch][-1]
        last_e = [s for s in got[False] if s[0] == epoch][-1]
        assert last_c[3] == last_e[3] == _B * _N
        assert last_c[2] == last_e[2]


def test_compiled_fit_adam_and_scheduler_match_eager_closely():
    params = {}
    for compiled in (True, False):
        sched = tmx.lr_scheduler.FactorScheduler(step=4, factor=0.5)
        _, params[compiled] = _fit(compiled, opt="adam",
                                   opt_params={"learning_rate": 0.01,
                                               "lr_scheduler": sched})
    for name in params[False]:
        np.testing.assert_allclose(params[True][name], params[False][name],
                                   rtol=ADAM_RTOL, atol=ADAM_ATOL,
                                   err_msg=name)


@topt.register
class EagerOnlySGD(topt.SGD):
    """SGD whose update is not declared capturable."""

    trace_safe = False


def test_compiled_fit_falls_back_with_warning_for_unsupported(caplog):
    with caplog.at_level(logging.WARNING):
        mod, _ = _fit(True, opt="eageronlysgd",
                      opt_params={"learning_rate": 0.01})
    assert mod._compiled_step is None
    assert any("falling back to the eager loop" in r.getMessage()
               for r in caplog.records)


def test_compiled_fit_falls_back_for_undeviceable_metric(caplog):
    mod, it = _module(labels=(_LABELS % 2).astype(np.float32))
    with caplog.at_level(logging.WARNING):
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1}, eval_metric="f1",
                initializer=tmx.init.Xavier())
    assert mod._compiled_step is None
    assert any("no traced_update device twin" in r.getMessage()
               for r in caplog.records)


def test_compiled_fit_composite_metric_accumulates_on_device():
    metric = tmx.metric.CompositeEvalMetric(metrics=["acc", "ce"])
    mod, _ = _fit(True, eval_metric=metric)
    assert mod._compiled_step is not None
    values = dict(zip(*metric.get()))
    eager_metric = tmx.metric.CompositeEvalMetric(metrics=["acc", "ce"])
    _fit(False, eval_metric=eager_metric)
    want = dict(zip(*eager_metric.get()))
    assert 0.0 <= values["accuracy"] <= 1.0
    assert values["cross-entropy"] > 0.0
    assert values["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(values["cross-entropy"],
                               want["cross-entropy"], rtol=1e-6)


def test_compiled_fit_binds_inputs_by_provide_order():
    """Two same-shaped inputs whose iterator order differs from the
    module's data_names: the step binds each array by its name."""
    sym = tmx.sym
    rng = np.random.RandomState(4)
    xa = rng.randn(32, 6).astype(np.float32)
    xb = np.zeros((32, 6), np.float32) + 99.0   # poison if bound as 'a'
    y = rng.randint(0, 10, 32).astype(np.float32)

    def run(compiled):
        tmx.random.seed(9)
        with tmx.name.NameManager():
            a, b = sym.Variable("a"), sym.Variable("b")
            net = sym.FullyConnected(a + 0 * b, num_hidden=10, name="fc")
            net = sym.SoftmaxOutput(net, name="softmax")
        it = tmx.io.NDArrayIter({"a": xa, "b": xb}, y, batch_size=16,
                                ctx=tmx.cpu())
        mod = tmx.mod.Module(net, data_names=("b", "a"),
                             context=tmx.cpu())
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1}, eval_metric="acc",
                initializer=tmx.init.Xavier(), compiled=compiled)
        args, _ = mod.get_params()
        return mod, {k: v.asnumpy() for k, v in args.items()}

    mod_c, params_c = run(True)
    assert mod_c._compiled_step is not None
    _, params_e = run(False)
    for name in params_e:
        assert np.array_equal(params_c[name], params_e[name]), name


def test_compiled_fit_follows_the_jax_compiled_fit():
    _, want = _fit(True, pkg=mx)
    _, got = _fit(True)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def _block(pkg, nn):
    kw = {"device": "cpu"} if pkg is tmx else {}
    net = nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=6, **kw))
        net.add(nn.BatchNorm(in_channels=16, **kw))
        net.add(nn.Dense(4, in_units=16, **kw))
    pkg.random.seed(21)
    net.initialize(pkg.init.Xavier())
    return net


def test_from_block_follows_the_jax_from_block():
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxCE
    from mxnet_tpu.module.compiled_step import \
        CompiledTrainStep as JaxStep
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.module import CompiledTrainStep

    rng = np.random.RandomState(6)
    batches = [(rng.randn(8, 6).astype(np.float32),
                rng.randint(0, 4, 8).astype(np.float32)) for _ in range(4)]
    jnet, net = _block(mx, jnn), _block(tmx, nn)
    jce, ce = JaxCE(), SoftmaxCrossEntropyLoss()
    jstep = JaxStep.from_block(
        jnet, lambda outs, y: jce(outs[0], y).mean(),
        mx.optimizer.SGD(learning_rate=0.1, momentum=0.9),
        eval_metric=mx.metric.Accuracy())
    metric = tmx.metric.Accuracy()
    step = CompiledTrainStep.from_block(
        net, lambda outs, y: ce(outs[0], y).mean(),
        topt.SGD(learning_rate=0.1, momentum=0.9), eval_metric=metric,
        steps_per_call=2)
    jlosses = [float(jstep.step(mx.nd.array(x), mx.nd.array(y))
                     .asnumpy()[0]) for x, y in batches]
    losses = [float(v) for i in range(0, len(batches), 2)
              for v in step.run_window([(torch.from_numpy(x),
                                         torch.from_numpy(y))
                                        for x, y in batches[i:i + 2]])]
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    want = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    for name, p in net.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(), want[name],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert step.cache_stats()["misses"] == 1
    step.sync_metric()
    jstep.sync_metric()
    assert step._metrics[0].get() == jstep._metrics[0].get()
