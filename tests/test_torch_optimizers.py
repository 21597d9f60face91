"""mxnet_tpu_torch's optimizers and update ops against the JAX package's.

The same seeded numpy weights and gradients go through both packages, at
the bound the JAX tests pin for the update ops (rtol 1e-5, atol 1e-6,
tests/test_registry_ops_r5.py:51):

- each of the eight update ops that came with the twelve optimizers
  (``rmsprop_update`` ... ``_sparse_adagrad_update``), ``nd.<name>`` of
  both packages, every output;
- each registered optimizer over five updates through
  ``update_multi_precision``, plain, with weight decay, gradient clipping
  and a gradient rescale, with an ``lr_scheduler``, and with
  ``multi_precision`` on fp16 weights: the weight and every state leaf;
- ``SGLD``'s noise: one seed in both packages gives the same draws;
- the registry, the ``trace_safe`` and ``elementwise`` flags and the
  case-insensitive lookup equal the JAX package's;
- ``gluon.Trainer(..., "RMSProp")`` builds in both.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer as topt

RTOL, ATOL = 1e-5, 1e-6          # tests/test_registry_ops_r5.py:51
SHAPE = (6, 5)
COMMON = {"lr": 0.05, "wd": 0.01, "rescale_grad": 0.7, "clip_gradient": 0.4}


def _arrays(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, SHAPE).astype(np.float32) for _ in range(n)]


def _pos(a):
    return np.abs(a) + 0.1


# op name -> (inputs after weight and grad, attrs beyond COMMON)
OPS = {
    "rmsprop_update": (lambda r: [_pos(r[0])],
                       {"gamma1": 0.9, "epsilon": 1e-8, "clip_weights": 0.8}),
    "rmspropalex_update": (lambda r: [_pos(r[0]) + 1.0, 0.1 * r[1], r[2]],
                           {"gamma1": 0.9, "gamma2": 0.8}),
    "ftrl_update": (lambda r: [r[0], _pos(r[1])],
                    {"lamda1": 0.3, "beta": 1.0}),
    "signsgd_update": (lambda r: [], {}),
    "signum_update": (lambda r: [r[0]], {"momentum": 0.9, "wd_lh": 0.02}),
    "ftml_update": (lambda r: [_pos(r[0]), _pos(r[1]), r[2]],
                    {"beta1": 0.6, "beta2": 0.999, "epsilon": 1e-8, "t": 3}),
    "_contrib_group_adagrad_update": (
        lambda r: [_pos(r[0])[:, :1]], {"epsilon": 1e-5}),
    "_sparse_adagrad_update": (lambda r: [_pos(r[0])], {"epsilon": 1e-7}),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_update_op_matches_jax(name):
    w, g, *rest = _arrays(1, 5)
    make, attrs = OPS[name]
    inputs = [w, g] + make(rest)
    attrs = dict(COMMON, **attrs)
    want = getattr(mx.nd, name)(*[mx.nd.array(a) for a in inputs], **attrs)
    got = getattr(tmx.nd, name)(
        *[tmx.nd.array(a, ctx=tmx.cpu()) for a in inputs], **attrs)
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=RTOL,
                                   atol=ATOL, err_msg="output %d" % i)


def test_update_ops_are_registered_as_in_jax():
    from mxnet_tpu.ops.registry import get_op as jax_op
    from mxnet_tpu_torch.ops.registry import get_op
    for name in OPS:
        mine, theirs = get_op(name), jax_op(name)
        assert mine.num_outputs == theirs.num_outputs, name
        assert set(mine.dynamic_attrs) == set(theirs.dynamic_attrs), name
        # each state input is written back when out= names the weight
        assert mine.mutate_inputs == tuple(
            range(2, 1 + mine.num_outputs)), name


# optimizer -> constructor arguments beyond each case's
OPTIMIZERS = {
    "sgd": {"momentum": 0.9},
    "nag": {"momentum": 0.9},
    "signum": {"wd_lh": 0.01},
    "ftml": {},
    "lbsgd": {"momentum": 0.9},
    "dcasgd": {"momentum": 0.9},
    "sgld": {},
    "adam": {},
    "adagrad": {},
    "rmsprop": {},
    "rmsprop_centered": {"centered": True, "clip_weights": 2.0},
    "adadelta": {},
    "ftrl": {},
    "adamax": {},
    "nadam": {},
    "test": {},
}
CASES = {
    "plain": {"learning_rate": 0.05},
    "wd_clip_rescale": {"learning_rate": 0.05, "wd": 0.01,
                        "clip_gradient": 0.4, "rescale_grad": 0.7},
    "lr_scheduler": {"learning_rate": 0.05},
    "multi_precision": {"learning_rate": 0.05, "multi_precision": True},
}
STEPS = 5


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [leaf for s in state for leaf in _leaves(s)]
    return [state]


def _as_np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return a.asnumpy().astype(np.float32)


def _run(pkg, name, case, seed):
    kind = name.split("_")[0]
    kw = dict(CASES[case], **OPTIMIZERS[name])
    if case == "lr_scheduler":
        kw["lr_scheduler"] = pkg.lr_scheduler.FactorScheduler(2, 0.5)
    pkg.random.seed(seed)
    opt = pkg.optimizer.create(kind, **kw)
    w0, *grads = _arrays(seed, STEPS + 1)
    low = case == "multi_precision"
    if pkg is mx:
        w = mx.nd.array(w0)
        w = w.astype("float16") if low else w
        cast = lambda g: mx.nd.array(g).astype(w.dtype)  # noqa: E731
    else:
        w = torch.tensor(w0).to(torch.float16 if low else torch.float32)
        cast = lambda g: torch.tensor(g).to(w.dtype)  # noqa: E731
    state = opt.create_state_multi_precision(0, w)
    for g in grads:
        opt.update_multi_precision(0, w, cast(g), state)
    return opt, w, state


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(name, case):
    opt, w, state = _run(tmx, name, case, seed=3)
    jopt, jw, jstate = _run(mx, name, case, seed=3)
    np.testing.assert_allclose(_as_np(w), _as_np(jw), rtol=RTOL, atol=ATOL)
    mine, theirs = _leaves(state), _leaves(jstate)
    assert len(mine) == len(theirs)
    for i, (a, b) in enumerate(zip(mine, theirs)):
        np.testing.assert_allclose(_as_np(a), _as_np(b), rtol=RTOL,
                                   atol=ATOL, err_msg="state leaf %d" % i)
    assert opt.num_update == jopt.num_update
    assert opt._index_update_count == jopt._index_update_count


def test_sgld_draws_the_jax_noise_for_one_seed():
    """With no gradient the update is the noise alone."""
    w0 = np.zeros(SHAPE, np.float32)
    got, want = [], []
    for pkg, out, w in ((tmx, got, torch.tensor(w0)),
                        (mx, want, mx.nd.array(w0))):
        pkg.random.seed(11)
        opt = pkg.optimizer.create("sgld", learning_rate=0.04)
        zero = torch.zeros(SHAPE) if pkg is tmx else mx.nd.zeros(SHAPE)
        for _ in range(2):
            opt.update(0, w, zero, None)
            out.append(_as_np(w).copy())
    for a, b in zip(got, want):
        assert np.abs(a).max() > 0.01
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_registry_and_flags_match_jax():
    from mxnet_tpu.optimizer.optimizer import Optimizer as JaxOptimizer
    # the optimizer modules' own classes (mxnet_tpu.contrib's SVRG module
    # and tests register more)
    mine = {k: v for k, v in topt.Optimizer.opt_registry.items()
            if v.__module__ == "mxnet_tpu_torch.optimizer.optimizer"}
    theirs = {k: v for k, v in JaxOptimizer.opt_registry.items()
              if v.__module__ == "mxnet_tpu.optimizer.optimizer"}
    assert sorted(mine) == sorted(theirs)
    assert len(mine) == 15
    for name, klass in theirs.items():
        assert mine[name].__name__ == klass.__name__
        assert mine[name].trace_safe == klass.trace_safe, name
        assert mine[name].elementwise == klass.elementwise, name
    assert isinstance(topt.create("RMSProp"), topt.RMSProp)
    assert isinstance(topt.create("adaDELTA"), topt.AdaDelta)
    with pytest.raises(ValueError, match="Cannot find optimizer"):
        topt.create("lamb")


def test_trainer_takes_rmsprop_by_its_class_name():
    jnet = mx.gluon.nn.Dense(2, in_units=3)
    jnet.initialize()
    jtr = mx.gluon.Trainer(jnet.collect_params(), "RMSProp",
                           {"learning_rate": 0.01})
    net = tmx.gluon.nn.Dense(2, in_units=3, device="cpu")
    net.initialize()
    tr = tmx.gluon.Trainer(net.collect_params(), "RMSProp",
                           {"learning_rate": 0.01})
    assert type(tr._optimizer).__name__ == type(jtr._optimizer).__name__ \
        == "RMSProp"
