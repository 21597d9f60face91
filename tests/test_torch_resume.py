"""Optimizer-state files and crash resume, the port against the JAX package.

- ``sym.var(lr_mult=0)``: ``Module`` hands its symbol to the optimizer,
  whose ``__lr_mult__`` leaves that weight where it started, in both
  packages;
- ``Module.save_optimizer_states`` and ``Trainer.save_states`` files cross
  both ways for Adam, centered RMSProp, FTML and Nadam: the reader goes on
  training as the writer does, within tests/test_module.py's bound for two
  trajectories of one run (``rtol=2e-4, atol=2e-5``);
- a bf16 state file crosses both ways bit for bit (the port writes the
  ``ml_dtypes`` array the JAX package reads);
- every ``mxnet_tpu`` class that a JAX ``Trainer.save_states`` file names
  has a mapping in the port's reader, which imports nothing of the JAX
  package;
- every trace-safe optimizer trains through the compiled step (its
  ``lr`` and ``t`` 0-d tensors) as it does eagerly, at the JAX compiled
  fit's bound;
- ``fit(auto_resume=True)`` after a crash in the middle of a checkpoint
  ends bitwise equal to an uninterrupted compiled fit
  (tests/test_compiled_fit.py::test_compiled_fit_killed_mid_epoch_resumes_
  bitwise);
- the port resumes from a checkpoint directory the JAX package wrote, and
  the JAX package from one the port wrote, at the same bound.
"""
import io
import os
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.optimizer import optimizer as topt_mod

# tests/test_module.py::test_module_multi_device_training_matches_single
RTOL, ATOL = 2e-4, 2e-5
_B, _N = 8, 2      # batch size, batches an epoch
_RNG = np.random.RandomState(0)
_DATA = _RNG.uniform(-1, 1, (_B * _N, 3, 6, 6)).astype(np.float32)
_LABELS = _RNG.randint(0, 10, _B * _N).astype(np.float32)
OPTIMIZERS = {
    "adam": {"learning_rate": 0.01},
    "rmsprop": {"learning_rate": 0.01, "centered": True},
    "ftml": {"learning_rate": 0.01},
    "nadam": {"learning_rate": 0.01},
}


@pytest.fixture(autouse=True)
def _one_thread():
    """Bitwise comparisons run the port on one CPU thread (see
    tests/test_torch_compiled_fit.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _convnet(pkg, lr_mult=None):
    sym = pkg.sym
    data = sym.Variable("data")
    net = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4,
                          name="conv1")
    net = sym.Activation(net, act_type="relu")
    net = sym.Pooling(net, global_pool=True, pool_type="avg", kernel=(1, 1))
    net = sym.Flatten(net)
    weight = None if lr_mult is None else sym.var("fc_weight",
                                                  lr_mult=lr_mult)
    net = sym.FullyConnected(net, weight=weight, num_hidden=10, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")


def _module(pkg, seed=77, **kw):
    pkg.random.seed(seed)
    it_kw = {"ctx": tmx.cpu()} if pkg is tmx else {}
    it = pkg.io.NDArrayIter(_DATA, _LABELS, batch_size=_B, **it_kw)
    with pkg.name.NameManager():
        net = _convnet(pkg, **kw)
    return pkg.mod.Module(net, context=pkg.cpu()), it


def _params(mod):
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the lr_mult repair

def test_lr_mult_zero_leaves_the_weight_in_both_packages():
    after, before = {}, {}
    for pkg in (mx, tmx):
        mod, it = _module(pkg, lr_mult=0.0)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(pkg.init.Xavier())
        before[pkg] = _params(mod)
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5}, compiled=False)
        after[pkg] = _params(mod)
    for pkg in (mx, tmx):
        np.testing.assert_array_equal(after[pkg]["fc_weight"],
                                      before[pkg]["fc_weight"])
        assert not np.array_equal(after[pkg]["fc_bias"],
                                  before[pkg]["fc_bias"])
    _close(after[tmx], after[mx])


# ---------------------------------------------------------------------------
# state files across the packages

def _module_run(pkg, name, tmp, load_from=None):
    """Fit one epoch and save a checkpoint with states; or, given
    ``load_from``, load that checkpoint (with its states) and fit one
    epoch on."""
    prefix = os.path.join(tmp, "m")
    kw = dict(optimizer=name, optimizer_params=OPTIMIZERS[name],
              compiled=False)
    if load_from is None:
        mod, it = _module(pkg)
        mod.fit(it, num_epoch=1, initializer=pkg.init.Xavier(), **kw)
        mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
        return prefix
    pkg.random.seed(5)
    it_kw = {"ctx": tmx.cpu()} if pkg is tmx else {}
    it = pkg.io.NDArrayIter(_DATA, _LABELS, batch_size=_B, **it_kw)
    load_kw = {"context": pkg.cpu()}
    mod = pkg.mod.Module.load(load_from, 1, load_optimizer_states=True,
                              **load_kw)
    mod.fit(it, begin_epoch=1, num_epoch=2, **kw)
    return _params(mod)


def _trainer_run(pkg, name, tmp, load_from=None):
    """Two Trainer steps of a Dense net, then save its parameters and
    states; or, given ``load_from``, load both and take two more."""
    rng = np.random.RandomState(1)
    xs = [rng.normal(0, 1, (4, 6)).astype(np.float32) for _ in range(4)]
    pkg.random.seed(3)
    kw = {"device": "cpu"} if pkg is tmx else {}
    net = pkg.gluon.nn.Dense(3, in_units=6, prefix="dense0_", **kw)
    net.initialize(pkg.init.Xavier())
    trainer = pkg.gluon.Trainer(net.collect_params(), name,
                                dict(OPTIMIZERS[name]))
    if load_from is not None:
        net.load_parameters(load_from + ".params")
        trainer.load_states(load_from + ".states")
        xs = xs[2:]
    else:
        xs = xs[:2]
    for x in xs:
        x = pkg.nd.array(x, ctx=pkg.cpu())
        with pkg.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        trainer.step(4)
    if load_from is None:
        prefix = os.path.join(tmp, "t")
        net.save_parameters(prefix + ".params")
        trainer.save_states(prefix + ".states")
        return prefix
    return {p.name: p.data().asnumpy()
            for p in net.collect_params().values()}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("run", ["module", "trainer"])
def test_state_files_cross_both_ways(tmp_path, run, writer, name):
    fn = _module_run if run == "module" else _trainer_run
    src, dst = (mx, tmx) if writer == "jax" else (tmx, mx)
    prefix = fn(src, name, str(tmp_path))
    own = fn(src, name, str(tmp_path), load_from=prefix)
    other = fn(dst, name, str(tmp_path), load_from=prefix)
    _close(other, own)


def test_port_state_file_is_plain_pickle_of_numpy_and_builtins(tmp_path):
    """What the JAX package's reader needs: nothing of the port's."""
    net = tmx.gluon.nn.Dense(3, in_units=6, device="cpu")
    net.initialize()
    net.cast("bfloat16")
    trainer = tmx.gluon.Trainer(net.collect_params(), "adam")
    with tmx.autograd.record():
        loss = net(torch.ones(2, 6, dtype=torch.bfloat16)).float().sum()
    loss.backward()
    trainer.step(2)
    data = trainer._updater.get_states(dump_optimizer=True)
    seen = set()

    class Recorder(pickle.Unpickler):
        def find_class(self, module, name):
            seen.add(module.split(".")[0])
            return super().find_class(module, name)

    states, opt_dict = Recorder(io.BytesIO(data)).load()
    assert seen <= {"numpy", "ml_dtypes"}
    assert "param_dict" not in opt_dict and "lr_scheduler" not in opt_dict
    # the JAX package's Updater reads it, bf16 states as ml_dtypes arrays
    jup = mx.optimizer.get_updater(mx.optimizer.create("adam"))
    jup.set_states(data)
    for i, state in trainer._updater.states.items():
        for mine, theirs in zip(state, jup.states[i]):
            assert theirs.dtype.name == "bfloat16"
            np.testing.assert_array_equal(
                np.asarray(theirs).view(np.int16),
                mine.view(torch.int16).numpy())
    assert jup.optimizer.num_update == 1


def test_jax_bf16_state_file_reads_as_bf16_bits():
    jw = mx.nd.array(np.linspace(-1, 1, 12).reshape(3, 4)).astype("bfloat16")
    jup = mx.optimizer.get_updater(mx.optimizer.create("adam"))
    jup(0, jw * 0.5, jw)
    up = tmx.optimizer.get_updater(tmx.optimizer.create("adam"))
    up.set_states(jup.get_states(dump_optimizer=True))
    for mine, theirs in zip(up.states[0], jup.states[0]):
        assert mine.dtype == torch.bfloat16
        np.testing.assert_array_equal(mine.view(torch.int16).numpy(),
                                      theirs.asnumpy().view(np.int16))
    assert up.optimizer._index_update_count == {0: 1}


def _jax_trainer_file(name, tmp):
    """A JAX Trainer.save_states file from a net of every kind of layer
    and initializer the zoo uses, with a schedule."""
    mx.random.seed(0)
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, 3, in_channels=3,
                                   weight_initializer=mx.init.Xavier()),
                mx.gluon.nn.BatchNorm(in_channels=4),
                mx.gluon.nn.Dense(2, in_units=4 * 4 * 4,
                                  weight_initializer=mx.init.Normal(0.1)))
    net.initialize(mx.init.MSRAPrelu())
    params = {"learning_rate": 0.01,
              "lr_scheduler": mx.lr_scheduler.FactorScheduler(5, 0.9)}
    params.update(OPTIMIZERS.get(name, {}))
    trainer = mx.gluon.Trainer(net.collect_params(), name, params)
    x = mx.nd.array(np.ones((2, 3, 6, 6), np.float32))
    with mx.autograd.record():
        loss = net(x).sum()
    loss.backward()
    trainer.step(2)
    path = os.path.join(tmp, name + ".states")
    trainer.save_states(path)
    return path, trainer._updaters[0].states


@pytest.mark.parametrize("name", ["sgd", "adam", "nadam", "sgld"])
def test_every_class_of_a_jax_trainer_file_has_a_mapping(tmp_path, name):
    path, jax_states = _jax_trainer_file(name, str(tmp_path))
    data = open(path, "rb").read()
    named = set()

    class Recorder(pickle.Unpickler):
        def find_class(self, module, attr):
            named.add((module, attr))
            return super().find_class(module, attr)

    Recorder(io.BytesIO(data)).load()
    foreign = {c for c in named if c[0].split(".")[0] in ("mxnet_tpu",
                                                           "jax")}
    assert ("mxnet_tpu.gluon.parameter", "Parameter") in foreign
    mapped = topt_mod._JAX_CLASSES | topt_mod._JAX_FUNCTIONS
    assert foreign <= mapped, sorted(foreign - mapped)
    up = tmx.optimizer.get_updater(tmx.optimizer.create(name))
    up.set_states(data)
    assert sorted(up.states) == sorted(jax_states)
    assert up.optimizer.num_update == 1


def test_the_reader_refuses_a_class_it_does_not_map():
    data = pickle.dumps({0: np.zeros(2)}).replace(b"numpy", b"nump0", 1)
    up = tmx.optimizer.get_updater(tmx.optimizer.create("sgd"))
    with pytest.raises(pickle.UnpicklingError, match="no mapping"):
        up.set_states(data)


# ---------------------------------------------------------------------------
# crash resume

def _fit_ckpt(pkg, prefix, name="sgd", resume=False, crash_plan=None,
              num_epoch=2, compiled=None):
    mod, it = _module(pkg, seed=1234)
    cbs = [pkg.callback.module_checkpoint(mod, prefix,
                                          save_optimizer_states=True)]
    params = {"sgd": {"learning_rate": 0.1, "momentum": 0.9}}.get(
        name, OPTIMIZERS.get(name))
    kw = dict(num_epoch=num_epoch, optimizer=name, optimizer_params=params,
              initializer=pkg.init.Xavier(), epoch_end_callback=cbs,
              compiled=compiled)
    if crash_plan is not None:
        with faults.plan(crash_plan):
            mod.fit(it, **kw)
    else:
        mod.fit(it, auto_resume=resume, **kw)
    return mod, _params(mod)


@pytest.mark.parametrize("name", ["sgd", "rmsprop"])
def test_compiled_fit_killed_mid_epoch_resumes_bitwise(tmp_path, name):
    mod, ref = _fit_ckpt(tmx, str(tmp_path / "ref"), name)
    assert mod._compiled_step is not None
    # the JAX test's kills tear the epoch-1 checkpoint (at its params
    # file's rename, then in the middle of a write); the third tears the
    # epoch-2 one after epoch 1 committed
    for n, (site, after) in enumerate([("checkpoint.replace", 1),
                                       ("checkpoint.write", 3),
                                       ("checkpoint.replace", 5)]):
        prefix = str(tmp_path / ("kill%d" % n))
        plan = faults.FaultPlan(n).add(site, kind="crash", after=after,
                                       times=1)
        with pytest.raises(faults.SimulatedCrash):
            _fit_ckpt(tmx, prefix, name, crash_plan=plan)
        found = tmx.model.latest_complete_checkpoint(prefix)
        assert found == (1 if n == 2 else None)
        mod, resumed = _fit_ckpt(tmx, prefix, name, resume=True)
        assert mod._compiled_step is not None
        for k in ref:
            assert np.array_equal(ref[k], resumed[k]), \
                "param %r diverged after kill@%s#%d" % (k, site, after)


# tests/test_compiled_fit.py::test_compiled_fit_adam_and_scheduler_...:
# the step-dependent arithmetic runs in fp32 on the device when captured
COMPILED_RTOL, COMPILED_ATOL = 3e-5, 3e-6
TRACE_SAFE = {"nag": {"momentum": 0.9}, "signum": {}, "ftml": {},
              "adagrad": {}, "rmsprop": {"centered": True}, "adadelta": {},
              "ftrl": {}, "adamax": {}, "test": {}}


@pytest.mark.parametrize("name", sorted(TRACE_SAFE))
def test_compiled_fit_takes_every_trace_safe_optimizer(name):
    """Its lr and step count are 0-d tensors in the captured step."""
    out = {}
    for compiled in (True, False):
        mod, it = _module(tmx)
        mod.fit(it, num_epoch=2, optimizer=name, compiled=compiled,
                optimizer_params=dict(learning_rate=0.01, wd=0.001,
                                      **TRACE_SAFE[name]),
                initializer=tmx.init.Xavier())
        assert (mod._compiled_step is not None) == compiled
        out[compiled] = _params(mod)
    _close(out[True], out[False], COMPILED_RTOL, COMPILED_ATOL)


def test_resume_restores_the_state_a_built_compiled_step_updates(tmp_path):
    """Loading states into a module whose compiled step is built copies
    them into the step's own tensors."""
    prefix = str(tmp_path / "c")
    _fit_ckpt(tmx, prefix, "rmsprop", num_epoch=1)
    mod, _ = _fit_ckpt(tmx, str(tmp_path / "d"), "rmsprop", num_epoch=1)
    step = mod._compiled_step
    mod.load_optimizer_states("%s-0001.states" % prefix)
    want = topt_mod.load_states(open("%s-0001.states" % prefix, "rb").read())
    for index, _, template, keys in step._opt_bindings:
        assert mod._updater.states[index] is template
        for key, value in zip(keys, want[index]):
            np.testing.assert_array_equal(step.state[key].numpy(), value)


def test_resume_from_raises_without_a_complete_checkpoint(tmp_path):
    mod, it = _module(tmx)
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        mod.fit(it, num_epoch=1, resume_from=str(tmp_path / "none"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_from_a_directory_the_other_package_wrote(tmp_path, writer):
    src, dst = (mx, tmx) if writer == "jax" else (tmx, mx)
    prefix = str(tmp_path / "ck")
    _fit_ckpt(src, prefix, "rmsprop", num_epoch=1)
    _, own = _fit_ckpt(src, prefix, "rmsprop", resume=True)
    # the writer's own resume committed epoch 2: take it out of the
    # manifest, so that the other package resumes from epoch 1 too
    import json
    manifest = prefix + "-manifest.json"
    entries = json.load(open(manifest))
    del entries["checkpoints"]["2"]
    json.dump(entries, open(manifest, "w"))
    _, other = _fit_ckpt(dst, prefix, "rmsprop", resume=True)
    _close(other, own)
