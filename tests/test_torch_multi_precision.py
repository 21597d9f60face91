"""mxnet_tpu_torch's multi-precision optimizers against the JAX package's.

``multi_precision=True`` keeps an fp32 master copy of each fp16 or bf16
weight.  The same seeded numpy weights and gradients go through both
packages:

- ``mp_sgd_update`` and ``mp_sgd_mom_update`` in fp16 and bf16, at the
  bounds of tests/test_registry_ops_r5.py:140-175: rtol 1e-6 / atol 1e-7 on
  the fp32 master and momentum, and the low-precision weight *equal* to the
  cast of the master;
- SGD with and without momentum and Adam through ``Updater`` over three
  steps on bf16 weights, at the same bounds on the masters and states (the
  bf16 weights, casts of masters that agree to 1e-6, within one bf16 step);
- SGD's multi-precision path never counts an update, in either package:
  ``num_update`` stays at ``begin_num_update`` and an ``lr_scheduler``
  stays at its base rate; Adam's path counts;
- state files round-trip bf16 and fp32 states bit for bit.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import gluon, lr_scheduler
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ops import optimizer_ops

RTOL, ATOL = 1e-6, 1e-7            # tests/test_registry_ops_r5.py:140-175
BF16_STEP = 2.0 ** -8              # one bf16 step, relative
DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}
ATTRS = {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 0.3}


def _jax_low(a, dtype):
    return mx.nd.array(a).astype(dtype)


def _np(a):
    """A JAX NDArray or a tensor as float64 numpy (exact for fp16/bf16)."""
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return a.asnumpy().astype(np.float64)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mp_sgd_updates_match_jax(dtype, momentum):
    rng = np.random.RandomState(0)
    w = rng.normal(0, 1, (6, 5)).astype(np.float32)
    jw, jw32, jm = _jax_low(w, dtype), mx.nd.array(w), mx.nd.zeros(w.shape)
    tw = torch.tensor(w).to(DTYPES[dtype])
    tw32, tm = torch.tensor(w), torch.zeros(w.shape)
    for _ in range(2):
        g = rng.normal(0, 1, w.shape).astype(np.float32)
        jg, tg = _jax_low(g, dtype), torch.tensor(g).to(DTYPES[dtype])
        if momentum:
            jw, jm, jw32 = mx.nd.mp_sgd_mom_update(
                jw, jg, jm, jw32, momentum=momentum, **ATTRS)
            tw, tm, tw32 = optimizer_ops.mp_sgd_mom_update(
                tw, tg, tm, tw32, momentum=momentum, **ATTRS)
        else:
            jw, jw32 = mx.nd.mp_sgd_update(jw, jg, jw32, **ATTRS)
            tw, tw32 = optimizer_ops.mp_sgd_update(tw, tg, tw32, **ATTRS)
        assert tw32.dtype == tm.dtype == torch.float32
        np.testing.assert_allclose(tw32.numpy(), jw32.asnumpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(tm.numpy(), jm.asnumpy(), rtol=RTOL,
                                   atol=ATOL)
        # the low-precision weight is the cast of the master
        assert tw.dtype == DTYPES[dtype] and str(jw.dtype) == dtype
        assert torch.equal(tw, tw32.to(DTYPES[dtype]))


_SGD = {"learning_rate": 0.1, "wd": 0.01, "rescale_grad": 0.5,
        "clip_gradient": 0.3}
MP_OPTIMIZERS = {
    "sgd": ("sgd", _SGD),
    "sgd_momentum": ("sgd", dict(_SGD, momentum=0.9)),
    "adam": ("adam", {"learning_rate": 0.01, "wd": 0.1, "rescale_grad": 0.5,
                      "clip_gradient": 0.3}),
}


def _mp_run(package, key, weights, grads, low, **extra):
    name, params = MP_OPTIMIZERS[key]
    opt = package.create(name, multi_precision=True, **params, **extra)
    upd = package.get_updater(opt)
    ws = [low(w) for w in weights]
    for step_grads in grads:
        for i, (w, g) in enumerate(zip(ws, step_grads)):
            upd(i, low(g), w)
    return opt, upd, ws


def _mp_case(seed=4):
    rng = np.random.RandomState(seed)
    weights = [rng.normal(0, 1, s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [[rng.normal(0, 1, w.shape).astype(np.float32) for w in weights]
             for _ in range(3)]
    return weights, grads


def _flat(state):
    """A state's tensors or NDArrays, in order."""
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [t for s in state for t in _flat(s)]
    return [state]


@pytest.mark.parametrize("key", sorted(MP_OPTIMIZERS))
def test_multi_precision_optimizers_match_jax_over_three_steps(key):
    weights, grads = _mp_case()
    _, jupd, jws = _mp_run(mx.optimizer, key, weights, grads,
                           lambda a: _jax_low(a, "bfloat16"))
    _, tupd, tws = _mp_run(topt, key, weights, grads,
                           lambda a: torch.tensor(a).to(torch.bfloat16))
    for i, (jw, tw) in enumerate(zip(jws, tws)):
        jstate, tstate = jupd.states[i], tupd.states[i]
        master = tstate[1]
        assert tw.dtype == torch.bfloat16 and master.dtype == torch.float32
        assert torch.equal(tw, master.to(torch.bfloat16))
        jflat, tflat = _flat(jstate), _flat(tstate)
        assert len(jflat) == len(tflat)
        for j, t in zip(jflat, tflat):       # fp32 states and the master
            assert t.dtype == torch.float32 and str(j.dtype) == "float32"
            np.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=RTOL,
                                       atol=ATOL)
        assert np.all(np.abs(_np(tw) - _np(jw))
                      <= BF16_STEP * np.abs(_np(jw))), key


def test_multi_precision_sgd_counts_no_update_and_adam_does():
    """The JAX ``SGD.update_multi_precision`` calls the mp ops without
    ``_update_count``: ``num_update`` stays at ``begin_num_update`` and the
    scheduler's rate at its base.  The port copies it.  Adam's path goes
    through ``update`` and counts."""
    weights, grads = _mp_case(5)
    masters = []
    for package, sched_mod, low in (
            (mx.optimizer, mx.lr_scheduler, lambda a: _jax_low(a, "bfloat16")),
            (topt, lr_scheduler,
             lambda a: torch.tensor(a).to(torch.bfloat16))):
        opt, upd, _ = _mp_run(
            package, "sgd_momentum", weights, grads, low,
            lr_scheduler=sched_mod.FactorScheduler(step=1, factor=0.5))
        assert opt.num_update == 0 and not opt._index_update_count
        masters.append([_np(upd.states[i][1]) for i in range(len(weights))])
        opt, _, _ = _mp_run(package, "adam", weights, grads, low)
        assert opt.num_update == 3
    for got, want in zip(*masters):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # at the scheduler's base rate throughout: the same as without one
    _, upd, _ = _mp_run(topt, "sgd_momentum", weights, grads,
                        lambda a: torch.tensor(a).to(torch.bfloat16))
    for i, got in enumerate(masters[1]):
        assert np.array_equal(got, _np(upd.states[i][1]))


def _states_equal(a, b):
    a, b = _flat(a), _flat(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01, "multi_precision": True})])
def test_state_files_round_trip_bf16_and_fp32_states(tmp_path, optimizer,
                                                     params):
    """SGD without multi-precision keeps a bf16 momentum for a bf16
    weight; Adam with it keeps fp32 moments and an fp32 master.  Both
    round-trip bit for bit through ``save_states``/``load_states``, beside
    an fp32 parameter's fp32 state, and training resumes identically."""
    rng = np.random.RandomState(8)

    def params_():
        return [torch.nn.Parameter(torch.tensor(
            rng.normal(0, 1, s).astype(np.float32)).to(dtype))
            for s, dtype in (((4, 3), torch.bfloat16), ((5,), torch.float32))]

    first = params_()
    trainer = gluon.Trainer(first, optimizer, dict(params))
    grads = [[torch.tensor(rng.normal(0, 1, p.shape).astype(np.float32))
              .to(p.dtype) for p in first] for _ in range(2)]
    for p, g in zip(first, grads[0]):
        p.grad = g
    trainer.step(1)
    trainer.save_states(tmp_path / "states")
    saved = [p.detach().clone() for p in first]
    kinds = {t.dtype for s in trainer._updater.states.values()
             for t in _flat(s)}
    assert torch.bfloat16 in kinds or optimizer == "adam"
    assert torch.float32 in kinds

    resumed = [torch.nn.Parameter(p.clone()) for p in saved]
    again = gluon.Trainer(resumed, optimizer, dict(params))
    again.load_states(tmp_path / "states")
    for i, p in enumerate(resumed):
        p.grad = grads[1][i]
        first[i].grad = grads[1][i]
    trainer.step(1)
    again.step(1)
    for i in trainer._updater.states:
        assert _states_equal(trainer._updater.states[i],
                             again._updater.states[i]), i
    for a, b in zip(first, resumed):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_updater_state_bytes_round_trip_bit_for_bit():
    bits = torch.tensor([1.0, -2.5, 3e-39, float("inf")]).to(torch.bfloat16)
    updater = topt.get_updater(topt.create("sgd", momentum=0.9))
    updater.states = {0: bits, 1: (torch.tensor([0.1, 0.2]), bits[:2]),
                      2: None}
    loaded = topt.get_updater(topt.create("sgd", momentum=0.9))
    loaded.set_states(updater.get_states())
    for i, state in updater.states.items():
        got = loaded._to_tensor(loaded.states[i], torch.device("cpu"))
        assert _states_equal(got, state), i
