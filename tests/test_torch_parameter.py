"""mxnet_tpu_torch's Gluon parameter model against the JAX package's:
``Parameter``/``ParameterDict``, names, deferred shapes, and the functional
API (``functional_call``, ``param_values``, ``split_param_names``).

- Deferred shapes: a ``Dense``/``Conv2D``/``BatchNorm`` without its input
  size has a 0 in its shape and a ``DeferredInitializationError`` until
  its first call, then the JAX layer's shape and, from the same seed, its
  values (bitwise); ``set_data`` on a deferred parameter keeps the data
  for that call (``tests/test_gluon.py:21`` and :146).
- ``functional_call`` on ``resnet18_v1`` (Xavier from one seed in both
  packages, bit-equal weights), B = 2, fp32, within the bounds
  ``tests/test_torch_resnet.py`` pins: in inference at 32 x 32 (rtol/atol
  1e-4), in training (batch statistics and their fold into the new aux)
  at 64 x 64 (TRAIN_FWD_BOUND; at 32 x 32 the last stage normalizes 2
  values a channel and a training forward is ill-conditioned); the
  block's and the caller's tensors bitwise unchanged afterwards.
- One step of bench.py's headline loop (trainable parameters cast to bf16
  inside the loss, BatchNorm statistics fp32 aux, ``log_softmax`` and
  ``take_along_axis``, SGD with momentum 0.9, lr 0.05) on the model and
  batch ``tests/test_torch_bf16.py`` derives its fp64 bounds on
  (``resnet18_v1`` with its random BatchNorm arrays, B = 2, 64 x 64):
  each package's loss within LOSS_FP64 and new running statistics within
  RSTAT_FP64 of the port's fp64 step from the same bf16-rounded weights
  and batch, the port within twice those of the JAX package, and each
  leaf's gradient within 2 x FP64_REL of the JAX package's; the update
  itself is exact in fp32.
- ``pretrained=<path>`` of a ``.params`` file the JAX package wrote (both
  naming schemes) gives the JAX net's logits (the forward bound).

Each test seeds both packages itself.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import block as jblock
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.gluon import block as tblock
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.parameter import (DeferredInitializationError,
                                             Parameter, ParameterDict)
from test_torch_bf16 import FP64_REL, LOSS_FP64, RSTAT_FP64, _fit_args
from test_torch_resnet import (TRAIN_FWD_BOUND, _two_threads,  # noqa: F401
                               jax_model, port_model, synthetic_batches)

FWD_RTOL = FWD_ATOL = 1e-4          # tests/test_torch_resnet.py
CPU = tmx.cpu()
LR, MOMENTUM = 0.05, 0.9            # bench.py:234-235


def _local(net):
    """``{name after the model's prefix: Parameter}``."""
    n = len(net.prefix)
    return {k[n:]: p for k, p in net.collect_params().items()}


# --------------------------------------------------------- deferred init

def test_dense_deferred_init_takes_the_first_batch():
    mx.random.seed(3)
    tmx.random.seed(3)
    jnet, tnet = mx.gluon.nn.Dense(4), nn.Dense(4, device="cpu")
    jnet.initialize()
    tnet.initialize()
    weight = tnet.collect_params()[tnet.prefix + "weight"]
    assert weight.shape == (4, 0)
    with pytest.raises(DeferredInitializationError):
        weight.data()
    x = np.random.RandomState(1).uniform(-1, 1, (3, 7)).astype(np.float32)
    want = jnet(mx.nd.array(x)).asnumpy()
    got = tnet(tmx.nd.array(x, ctx=CPU))
    assert got.shape == (3, 4) and weight.shape == (4, 7)
    np.testing.assert_array_equal(weight.data().asnumpy(),
                                  jnet.weight.data().asnumpy())
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_conv_and_batchnorm_defer_to_the_first_batch(layout):
    mx.random.seed(5)
    tmx.random.seed(5)
    jnet, tnet = mx.gluon.nn.HybridSequential(), nn.HybridSequential()
    for net, pkg, kw in ((jnet, mx.gluon.nn, {}),
                         (tnet, nn, {"device": "cpu"})):
        with net.name_scope():
            net.add(pkg.Conv2D(6, 3, layout=layout, **kw),
                    pkg.BatchNorm(axis=layout.index("C"), **kw))
        net.initialize(pkg is nn and tmx.init.Xavier() or mx.init.Xavier())
    shape = (2, 4, 5, 5) if layout == "NCHW" else (2, 5, 5, 4)
    tparams = _local(tnet)
    assert tparams["conv2d0_weight"].shape == (
        (6, 0, 3, 3) if layout == "NCHW" else (6, 3, 3, 0))
    assert tparams["batchnorm0_running_var"].shape == (0,)
    x = np.random.RandomState(2).normal(0, 1, shape).astype(np.float32)
    jnet(mx.nd.array(x))
    with torch.no_grad():
        tnet(torch.from_numpy(x))
    jparams = _local(jnet)
    assert list(tparams) == list(jparams)
    for n, p in jparams.items():
        assert tparams[n].shape == p.shape, n
        np.testing.assert_array_equal(tparams[n].data().asnumpy(),
                                      p.data().asnumpy())


def test_set_data_on_a_deferred_parameter_waits_for_the_first_call():
    tnet = nn.Dense(3, use_bias=False, device="cpu")
    tnet.initialize()
    weight = tnet.collect_params()[tnet.prefix + "weight"]
    value = np.arange(6, dtype=np.float32).reshape(3, 2)
    weight.set_data(value)
    assert weight.shape == (3, 2)
    with pytest.raises(DeferredInitializationError):
        weight.data()
    out = tnet(torch.ones(1, 2))
    np.testing.assert_array_equal(weight.data().asnumpy(), value)
    np.testing.assert_array_equal(out.detach().numpy(), [[1, 5, 9]])
    fresh = nn.Dense(3, device="cpu")
    with pytest.raises(RuntimeError, match="has not been initialized"):
        fresh(torch.ones(1, 2))


def test_parameter_dict_get_update_and_attributes():
    params = ParameterDict("net_")
    w = params.get("weight", shape=(2, 0), allow_deferred_init=True)
    assert w.name == "net_weight" and params.get("weight", shape=(0, 3)) is w
    assert w.shape == (2, 3)
    with pytest.raises(AssertionError, match="already exists"):
        params.get("weight", shape=(4, 3))
    other = ParameterDict("net_")
    other._params["net_weight"] = Parameter("net_weight")
    with pytest.raises(AssertionError, match="different Parameters"):
        params.update(other)
    params.setattr("lr_mult", 0.5)
    assert w.lr_mult == 0.5 and "net_weight" in params and len(params) == 1
    with pytest.raises(ValueError, match="grad_req"):
        w.grad_req = "sometimes"
    frozen = Parameter("x_gamma", grad_req="write", differentiable=False)
    assert frozen.grad_req == "null"


def test_names_grad_req_and_trainer_follow_gluon():
    tmx.random.seed(0)
    net = tvision.resnet18_v1(classes=10, device="cpu")
    names = list(_local(net))
    mx_names = list(_local(jvision.resnet18_v1(classes=10)))
    assert names == mx_names
    assert names[:6] == ["conv2d0_weight", "batchnorm0_gamma",
                         "batchnorm0_beta", "batchnorm0_running_mean",
                         "batchnorm0_running_var",
                         "stage1_conv2d0_weight"]
    train, frozen = tblock.split_param_names(net)
    assert len(frozen) == 2 * 20 and all("running" in n for n in frozen)
    assert set(net.collect_params(".*running_var")) \
        == {n for n in frozen if n.endswith("var")}
    net.initialize(tmx.init.Xavier())
    net(torch.zeros(1, 3, 16, 16))
    # BatchNorm's statistics are buffers with grad_req 'null'
    bn = net.features[1]
    assert set(dict(bn.named_buffers())) == {"running_mean", "running_var"}
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    assert [p is None for p in trainer._params].count(True) == len(frozen)


# ------------------------------------------------------ functional_call

@pytest.fixture(scope="module")
def resnet18():
    """``resnet18_v1`` (10 classes) Xavier from seed 0 in both packages,
    its deferred shapes filled by a call; the batches of each mode (B = 2;
    32 x 32 in inference, 64 x 64 in training) and the JAX package's
    ``functional_call`` outputs and aux on them, under ``jax.jit`` as
    bench.py calls it."""
    rng = np.random.RandomState(0)
    xs = {False: rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32),
          True: rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)}
    mx.random.seed(0)
    tmx.random.seed(0)
    jnet = jvision.resnet18_v1(classes=10)
    tnet = tvision.resnet18_v1(classes=10, device="cpu")
    jnet.initialize(mx.init.Xavier())
    tnet.initialize(tmx.init.Xavier())
    jnet(mx.nd.array(xs[False]))
    with torch.no_grad():
        tnet(torch.from_numpy(xs[False]))
    jvals = jblock.param_values(jnet)
    call = jax.jit(lambda vals, x, training: jblock.functional_call(
        jnet, vals, x, training=training), static_argnums=2)
    want = {}
    for training, x in xs.items():
        outs, aux = call(jvals, jnp.asarray(x), training)
        want[training] = (np.asarray(outs[0]),
                          {n: np.asarray(v) for n, v in aux.items()})
    return jnet, tnet, xs, want


def _as_port_names(jnet, tnet):
    """JAX Gluon name -> port Gluon name, through the structural names."""
    tnames = {k: p.name for k, p in tnet._collect_params_with_prefix().items()}
    return {p.name: tnames[k]
            for k, p in jnet._collect_params_with_prefix().items()}


@pytest.mark.parametrize("training", [False, True])
def test_functional_call_matches_jax_and_writes_nothing(resnet18, training):
    jnet, tnet, xs, want = resnet18
    x = xs[training]
    bound = TRAIN_FWD_BOUND if training else FWD_ATOL
    names = _as_port_names(jnet, tnet)
    jvals = jblock.param_values(jnet)
    vals = tblock.param_values(tnet)
    for jn, tn in names.items():   # the same seed drew the same weights
        np.testing.assert_array_equal(vals[tn].numpy(), np.asarray(jvals[jn]))
    before = {n: v.clone() for n, v in vals.items()}
    own = {n: t.detach().clone() for n, t in tnet.state_dict().items()}
    outs, aux = tblock.functional_call(tnet, vals, torch.from_numpy(x),
                                       training=training)
    want_out, want_aux = want[training]
    assert len(outs) == 1 and outs[0].shape == (2, 10)
    np.testing.assert_allclose(outs[0].detach().numpy(), want_out,
                               rtol=bound, atol=bound)
    assert set(aux) == {names[n] for n in want_aux}
    for jn, a in want_aux.items():
        np.testing.assert_allclose(aux[names[jn]].numpy(), a, rtol=bound,
                                   atol=bound)
    if training:   # the statistics moved, in the returned aux only
        assert any(not torch.equal(aux[n], before[n]) for n in aux)
    for n, v in vals.items():
        assert torch.equal(v, before[n]), n
    for n, t in tnet.state_dict().items():
        assert torch.equal(t, own[n]), n
    with pytest.raises(KeyError, match="missing"):
        tblock.functional_call(tnet, {}, torch.from_numpy(x))


def test_split_param_names_match_jax(resnet18):
    jnet, tnet, _, _ = resnet18
    names = _as_port_names(jnet, tnet)
    jtrain, jfrozen = jblock.split_param_names(jnet)
    ttrain, tfrozen = tblock.split_param_names(tnet)
    assert sorted(names[n] for n in jtrain) == ttrain
    assert sorted(names[n] for n in jfrozen) == tfrozen


def _bench_step_jax(net, x, y):
    """bench.py's step (:223-246) on ``net``: loss, gradients, new
    parameters and new aux."""
    params = jblock.param_values(net)
    aux_names = {n for n, p in net.collect_params().items()
                 if p.grad_req == "null"}
    train = {n: v for n, v in params.items() if n not in aux_names}
    aux = {n: v for n, v in params.items() if n in aux_names}

    def loss_fn(train_params, aux_params):
        p = dict(aux_params)
        p.update({n: v.astype(jnp.bfloat16) for n, v in train_params.items()})
        outs, new_aux = jblock.functional_call(net, p, x.astype(jnp.bfloat16),
                                               training=True)
        logp = jax.nn.log_softmax(outs[0].astype(jnp.float32))
        loss = -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))
        return loss, new_aux

    (loss, new_aux), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(train, aux)
    new_p = {n: train[n] - LR * (MOMENTUM * 0 + grads[n]) for n in train}
    return (float(loss), {n: np.asarray(g) for n, g in grads.items()},
            {n: np.asarray(v) for n, v in new_p.items()},
            {n: np.asarray(v) for n, v in new_aux.items()})


def _bench_step_port(net, x, y):
    """The same step through the port's ``functional_call`` and
    ``torch.autograd``."""
    train_names, aux_names = tblock.split_param_names(net)
    params = tblock.param_values(net)
    train = {n: params[n].clone().requires_grad_() for n in train_names}
    aux = {n: params[n] for n in aux_names}
    momenta = {n: torch.zeros_like(v) for n, v in train.items()}
    p = dict(aux)
    p.update({n: v.to(torch.bfloat16) for n, v in train.items()})
    outs, new_aux = tblock.functional_call(net, p, x.to(torch.bfloat16),
                                           training=True)
    logp = torch.log_softmax(outs[0].float(), dim=-1)
    loss = -torch.take_along_dim(logp, y[:, None], dim=1).mean()
    grads = dict(zip(train, torch.autograd.grad(loss, list(train.values()))))
    with torch.no_grad():
        new_p = {}
        for n, v in train.items():
            momenta[n] = MOMENTUM * momenta[n] + grads[n]
            new_p[n] = v - LR * momenta[n]
    return (loss.item(), {n: g.numpy() for n, g in grads.items()},
            {n: v.numpy() for n, v in new_p.items()},
            {n: v.numpy() for n, v in new_aux.items()}, train)


def test_bench_functional_step_matches_jax():
    jnet = jax_model("resnet18_v1", 64, classes=10, forward=False)
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = port_model("resnet18_v1", arrays, classes=10)
    x, y = synthetic_batches(_fit_args(), (3, 64, 64), 1)[0]
    y = y.long()
    names = _as_port_names(jnet, tnet)
    jloss, jgrads, jnew, jaux = _bench_step_jax(
        jnet, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    tloss, tgrads, tnew, taux, start = _bench_step_port(tnet, x, y)
    # the port's step in fp64 from the bf16-rounded weights and batch
    net64 = port_model("resnet18_v1", arrays, classes=10).double()
    train, _ = tblock.split_param_names(net64)
    vals64 = {n: v.to(torch.bfloat16).double() if n in train else v
              for n, v in tblock.param_values(net64).items()}
    outs, aux64 = tblock.functional_call(
        net64, vals64, x.to(torch.bfloat16).double(), training=True)
    to_port = _as_port_names(net64, tnet)
    aux64 = {to_port[n]: a for n, a in aux64.items()}
    logp = torch.log_softmax(outs[0], dim=-1)
    loss64 = -torch.take_along_dim(logp, y[:, None], dim=1).mean().item()

    def stats_gap(got, want):
        return max(np.abs(got[n] - w).max() / np.abs(w).max()
                   for n, w in want.items())

    want_aux = {n: a.numpy() for n, a in aux64.items()}
    jaux = {names[n]: a for n, a in jaux.items()}
    assert abs(tloss - loss64) <= LOSS_FP64
    assert abs(jloss - loss64) <= LOSS_FP64
    assert abs(tloss - jloss) <= 2 * LOSS_FP64
    assert stats_gap(taux, want_aux) <= RSTAT_FP64
    assert stats_gap(jaux, want_aux) <= RSTAT_FP64
    assert stats_gap(taux, jaux) <= 2 * RSTAT_FP64
    assert all(a.dtype == np.float32 for a in taux.values())
    for jn, g in jgrads.items():
        n = names[jn]
        assert np.linalg.norm(tgrads[n] - g) <= 2 * FP64_REL \
            * np.linalg.norm(g), n
        # the update is fp32 arithmetic on the port's own gradient
        exact = start[n].detach().double().numpy() - LR * tgrads[n]
        np.testing.assert_allclose(tnew[n], exact, rtol=1e-6, atol=1e-7)


def test_pretrained_path_loads_a_jax_file(resnet18, tmp_path):
    """Both of the JAX package's naming schemes: ``save_parameters``
    (structural names) and ``collect_params().save`` (Gluon names, paired
    by kind in construction order)."""
    jnet, _, xs, want = resnet18
    x = xs[False]
    for fname, save in (("structural.params", jnet.save_parameters),
                        ("gluon.params", jnet.collect_params().save)):
        path = str(tmp_path / fname)
        save(path)
        tnet = tvision.resnet18_v1(classes=10, pretrained=path,
                                   device="cpu")
        with torch.no_grad():
            got = tnet(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want[False][0], rtol=FWD_RTOL,
                                   atol=FWD_ATOL)
    with pytest.raises(NotImplementedError, match="download"):
        tvision.resnet18_v1(pretrained=True, device="cpu")
