"""bf16 training in mxnet_tpu_torch against the JAX package's.

The same seeded numpy inputs and weights go through both packages; each
casts the fp32 weights to bf16 itself (``Block.cast``), so both round the
same values.  bf16 keeps 8 bits of mantissa, and the two packages round at
different places (the JAX package's XLA fuses elementwise chains and
rounds their results; torch rounds each op's), so no bound here is one of
fp32.  Each is derived the way tests/test_torch_resnet.py derives its
fp32 ones: both packages' bf16 results are measured against an fp64 run of
the port from the same bf16-rounded weights and inputs, each package is
held within a bound over the worst reading (the ``*_FP64`` constants,
checked by the ``..._as_accurate_as_jax`` tests), and the port is held to
the JAX package at twice that bound.  The port's readings are taken with
both of the convolutions a CPU may run (oneDNN's, and torch's own with
``torch.backends.mkldnn`` off), since bf16 rounding depends on them.
Readings (CPU runs):

- BatchNorm, two recorded calls, relative to max(1, |fp64|): JAX up to
  0.0132 (beta's gradient), the port up to 0.0072 (either oneDNN
  setting): BN_FP64 = 0.02.
- ``fit_gluon --dtype bfloat16``, resnet18_v1, B = 2, 64 x 64, step 1,
  NCHW/NHWC, the port with oneDNN and then without.  Logits (up to 2.9)
  from fp64: JAX 0.079, the port 0.078/0.086 and 0.094/0.102:
  LOGIT_FP64 = 0.15.  Loss: JAX 0.018, the port 0.029/0.013 and
  0.037/0.005: LOSS_FP64 = 0.06.  Gradients, per leaf ||g - g64|| /
  ||g64||: JAX up to 0.489 (median 0.389), the port up to 0.557/0.544 and
  0.563/0.532 (medians 0.350-0.381): FP64_REL = 0.75.  A bf16 step moves
  that much because rounding the weights and the input to bf16 flips
  max-pool and ReLU decisions: the exact (fp64) gradient at the rounded
  point lies 25-42% from the one at the fp32 point.
  At 32 x 32 the last stage normalizes 2 values a channel and each
  package's bf16 gradient lies up to 15 (JAX) and 21 (port) times a leaf's
  norm from fp64, which would hold nothing: the test runs at 64 x 64
  (8 values a channel).  Running statistics after step 1, relative to the
  largest value of their array: both 0.0083 (the same bf16 values):
  RSTAT_FP64 = 0.012.
- The LM (depth 2, dim 64) with ``Adam(multi_precision=True)``: step-1
  gradients JAX up to 0.043, the port up to 0.022 from fp64 (either
  oneDNN setting): LM_FP64_REL = 0.06.  Loss: both 0.0041 from fp64 (the
  same bf16 value): LM_LOSS_FP64 = 0.01.

After step 1 the two packages' weights differ by what the update makes of
their gradients' gaps.  SGD is linear in the gradient, so the weights and
momenta after two steps are held at what it makes of the measured
per-element gaps (as tests/test_torch_resnet.py does in fp32), plus the
bf16 rounding of the update: the port rounds each of its six intermediate
results, the JAX package its two outputs, each by up to 2^-9 of its
magnitude, so 2^-6 of the magnitudes of the update's terms (measured:
0.0106 on the momenta, 0.0055 on the weights).  Adam's fp32 masters are
held at what Adam makes of the gradient gaps (``_adam_gap_bound``) plus
tests/test_torch_training.py's LM bounds, and the bf16 weights are the
masters' casts.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, gluon, metric
from mxnet_tpu_torch.base import as_dtype, tensor_from_numpy
from mxnet_tpu_torch.convert import (load_mxnet_params, mxnet_pairs,
                                     mxnet_to_torch_name)
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.nn.conv_layers import _channel_first
from mxnet_tpu_torch.models import image_classification as ic
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.ops import cuda_ops
from test_torch_conv_layers import _bn_pair
from test_torch_resnet import (LR, MOM, WD, FirstBatches, _args, arrays_of,
                               jax_model, port_model, synthetic_batches)
from test_torch_training import (LM_ATOL, LM_RTOL, VOCAB, _adam_gap_bound,
                                 _lm_pair)

BF16 = torch.bfloat16
BN_FP64 = 0.02
LOGIT_FP64, LOSS_FP64, FP64_REL = 0.15, 0.06, 0.75
RSTAT_FP64 = 0.012
LM_FP64_REL, LM_LOSS_FP64 = 0.06, 0.01
BF16_ROUND = 2.0 ** -6     # the update's bf16 rounding, of its terms
BF16_STEP = 2.0 ** -7      # one bf16 step at most, relative


def _f64(a):
    """A tensor or a JAX NDArray as float64 numpy (exact from bf16)."""
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return a.asnumpy().astype(np.float64)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _err(got, want):
    """Max abs gap relative to max(1, |want|)."""
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


# ------------------------------------------------------------------ cast

def _small_nets():
    """Conv (with bias), BatchNorm, ReLU, Dense in both packages; shapes
    given, so the JAX net initializes without a forward."""
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Conv2D(4, 3, in_channels=3),
             mx.gluon.nn.BatchNorm(in_channels=4),
             mx.gluon.nn.Activation("relu"),
             mx.gluon.nn.Dense(5, in_units=4 * 4 * 4))
    jnet.initialize(mx.init.Xavier())
    tnet = nn.HybridSequential(
        nn.Conv2D(4, 3, in_channels=3, device="cpu"),
        nn.BatchNorm(in_channels=4, device="cpu"), nn.Activation("relu"),
        nn.Dense(5, in_units=4 * 4 * 4, device="cpu"))
    load = dict(zip(tnet.state_dict(), jnet.collect_params().values()))
    with torch.no_grad():
        for key, t in tnet.state_dict(keep_vars=True).items():
            t.copy_(tensor_from_numpy(load[key].data().asnumpy()))
    return jnet, tnet


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cast_gives_the_jax_dtypes_array_by_array(dtype):
    """BatchNorm stays fp32 under float16 only (the JAX
    ``BatchNorm.cast``); every other array takes the dtype."""
    jnet, tnet = _small_nets()
    jnet.cast(dtype)
    assert tnet.cast(dtype) is tnet
    want = [str(p.data().dtype) for p in jnet.collect_params().values()]
    got = [_dtype_name(t) for t in tnet.state_dict().values()]
    assert got == want
    assert ("float32" in want) == (dtype == "float16")
    if dtype == "bfloat16":   # the CPU runs no fp16 convolution
        out = tnet(torch.ones(2, 3, 6, 6, dtype=BF16))
        assert out.dtype == BF16 and out.shape == (2, 5)


def test_cast_keeps_the_parameters_and_channel_last_memory():
    net = nn.HybridSequential(
        nn.Conv2D(8, 3, in_channels=4, layout="NHWC", device="cpu"),
        nn.BatchNorm(axis=-1, in_channels=8, device="cpu"))
    tmx.random.seed(0)
    net.initialize(tmx.init.Xavier())
    before = list(net.parameters())
    weight = net[0].weight
    assert weight.shape == (8, 3, 3, 4) and weight.is_contiguous()
    values = [p.detach().clone() for p in before]
    net.cast(np.dtype("float32")).cast("bfloat16")
    after = list(net.parameters())
    assert all(a is b for a, b in zip(before, after))
    assert all(p.dtype == BF16 and isinstance(p, torch.nn.Parameter)
               and p.requires_grad for p in after)
    assert all(torch.equal(p, v.to(BF16)) for p, v in zip(after, values))
    assert weight.is_contiguous()
    assert _channel_first(weight).is_contiguous(
        memory_format=torch.channels_last)
    assert {b.dtype for b in net.buffers()} == {BF16}
    with autograd.record():
        out = net(torch.ones(2, 5, 5, 4, dtype=BF16))
    out.sum().backward()
    assert out.dtype == weight.grad.dtype == BF16
    assert as_dtype(torch.float16) is torch.float16
    with pytest.raises(TypeError, match="int8"):
        net.cast("int8")


def test_cast_between_building_a_trainer_and_its_first_step_trains():
    """The Trainer holds the same parameters after the cast, writes (not
    adds) each new gradient, and makes its states at the first update,
    in the parameters' new dtype."""
    rng = np.random.RandomState(2)
    net = nn.HybridSequential(nn.Dense(6, activation="relu", in_units=4,
                                       device="cpu"),
                              nn.Dense(3, in_units=6, device="cpu"))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.5, p.shape)
                                     .astype(np.float32)))
    trainer = gluon.Trainer(net.named_parameters(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    x = torch.from_numpy(rng.normal(0, 1, (5, 4)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 3, 5).astype(np.float32))
    with autograd.record():
        SoftmaxCrossEntropyLoss()(net(x), y).sum().backward()
    net.cast("bfloat16")
    grads = []
    for _ in range(2):
        with autograd.record():
            loss = SoftmaxCrossEntropyLoss()(net(x.to(BF16)), y)
        loss.backward(torch.ones_like(loss))
        grads.append([p.grad.clone() for p in net.parameters()])
    # the second backward wrote its gradient over the first's
    assert all(g.dtype == BF16 and torch.equal(g, h)
               for g, h in zip(*grads))
    start = [p.detach().clone() for p in net.parameters()]
    trainer.step(5)
    for p, p0 in zip(net.parameters(), start):
        assert p.dtype == BF16 and not torch.equal(p, p0)
    states = trainer._updater.states
    assert {s.dtype for s in states.values()} == {BF16}


# ------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("axis,shape", [(1, (2, 3, 4, 5)), (-1, (2, 4, 5, 3))])
def test_batchnorm_bf16_matches_jax_over_two_recorded_calls(axis, shape):
    """The layer cast to bf16 in both packages, against the port's layer
    in fp64 on the same bf16 values: output, x/gamma/beta gradients and
    the running statistics, each package within BN_FP64 of fp64 and the
    port within 2 x BN_FP64 of the JAX layer."""
    rng = np.random.RandomState(5)
    C = shape[axis]
    jbn, tbn = _bn_pair(axis, C, rng)
    b64 = nn.BatchNorm(axis=axis, in_channels=C, device="cpu")
    b64.load_state_dict(tbn.state_dict())
    jbn.cast("bfloat16")
    tbn.cast("bfloat16")
    b64.cast("bfloat16").cast("float64")
    names = ("out", "x grad", "gamma grad", "beta grad", "running_mean",
             "running_var")
    for call in range(2):
        x = torch.from_numpy(rng.normal(call, 2, shape).astype(np.float32))
        dy = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
        x, dy = x.to(BF16), dy.to(BF16)
        jx = mx.nd.array(x.float().numpy()).astype("bfloat16")
        jx.attach_grad()
        with mx.autograd.record():
            jy = jbn(jx)
        jy.backward(mx.nd.array(dy.float().numpy()).astype("bfloat16"))
        results = {}
        for net, inp in ((tbn, x), (b64, x.double())):
            inp = inp.clone().requires_grad_()
            with autograd.record():
                out = net(inp)
            out.backward(dy.to(out.dtype))
            results[net] = [_f64(out), _f64(inp.grad)] + [
                _f64(getattr(net, n).grad) for n in ("gamma", "beta")] + [
                _f64(getattr(net, n)) for n in ("running_mean", "running_var")]
            net.zero_grad()
        assert tbn.running_var.dtype == tbn.gamma.dtype == BF16
        want = [_f64(jy), _f64(jx.grad)] + [
            _f64(getattr(jbn, n).grad()) for n in ("gamma", "beta")] + [
            _f64(getattr(jbn, n).data()) for n in ("running_mean",
                                                   "running_var")]
        for name, got, jax, ref in zip(names, results[tbn], want,
                                       results[b64]):
            assert _err(got, ref) <= BN_FP64, (call, name, _err(got, ref))
            assert _err(jax, ref) <= BN_FP64, (call, name, _err(jax, ref))
            assert _err(got, jax) <= 2 * BN_FP64, (call, name)


# ------------------------------------------------------ loss and metric

def test_softmax_ce_and_accuracy_on_bf16_logits():
    """bf16 logits with fp32 labels: the loss is bf16 in both packages
    (log_softmax in the logits' dtype, then pick), as is its gradient;
    both within LOSS_FP64 of fp64.  Accuracy takes the first of tied
    maxima, as the JAX metric does."""
    rng = np.random.RandomState(3)
    logits = torch.from_numpy(rng.normal(0, 3, (6, 5)).astype(np.float32))
    logits = logits.to(BF16)
    label = rng.randint(0, 5, 6).astype(np.float32)
    jl = mx.nd.array(logits.float().numpy()).astype("bfloat16")
    jl.attach_grad()
    with mx.autograd.record():
        jloss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(jl, mx.nd.array(label))
    jloss.backward()
    results = []
    for inp in (logits, logits.double()):
        inp = inp.clone().requires_grad_()
        loss = SoftmaxCrossEntropyLoss()(inp, torch.from_numpy(label))
        loss.backward(torch.ones_like(loss))
        results.append((loss, inp.grad))
    (loss, grad), (loss64, grad64) = results
    assert loss.dtype == grad.dtype == BF16 and str(jloss.dtype) == "bfloat16"
    for got in (loss, jloss):
        assert np.abs(_f64(got) - _f64(loss64)).max() <= LOSS_FP64
    for got in (grad, jl.grad):
        assert np.abs(_f64(got) - _f64(grad64)).max() <= LOSS_FP64
    assert np.abs(_f64(loss) - _f64(jloss)).max() <= 2 * LOSS_FP64

    pred = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 1.0, 2.0],
                         [0.5, 0.25, 0.5, 0.5]], dtype=BF16)
    labels = np.array([2.0, 0.0, 0.0], np.float32)
    jm, tm = mx.metric.Accuracy(), metric.Accuracy()
    jm.update([mx.nd.array(labels)],
              [mx.nd.array(pred.float().numpy()).astype("bfloat16")])
    tm.update([torch.from_numpy(labels)], [pred])
    # first maxima: 1, 0, 0 against labels 2, 0, 0
    assert tm.get() == jm.get() == ("accuracy", 2 / 3)


# ------------------------------------------------------- fit_gluon, bf16

SIZE, B = 64, 2


def _fit_args():
    return _args(network="resnet18_v1", num_classes=10, dtype="bfloat16")


def _fit_batches(layout):
    batches = synthetic_batches(_fit_args(), (3, SIZE, SIZE), 2)
    if layout == "NHWC":
        batches = [(x.permute(0, 2, 3, 1).contiguous(), y)
                   for x, y in batches]
    return batches


@pytest.fixture(scope="module", params=["NCHW", "NHWC"])
def jax_bf16_fit(request):
    """The JAX ``fit_gluon`` loop in bf16 (``net.cast("bfloat16")`` before
    the Trainer, each batch's data cast) over two SGD steps at the
    example's defaults, recorded once per layout: the fp32 starting arrays,
    and after each step the logits, the loss, the gradients and every
    array; the momenta at the end."""
    layout = request.param
    jnet = jax_model("resnet18_v1", SIZE, classes=10, layout=layout,
                     forward=False)
    arrays = arrays_of(jnet)
    batches = _fit_batches(layout)
    jnet.cast("bfloat16")
    jparams = jnet.collect_params()
    trainer = mx.gluon.Trainer(jparams, "sgd", {
        "learning_rate": LR, "momentum": MOM, "wd": WD})
    trainable = [n for n, p in jparams.items() if p.grad_req != "null"]
    steps = []
    for x, y in batches:
        with mx.autograd.record():
            logits = jnet(mx.nd.array(x.numpy()).astype("bfloat16"))
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                logits, mx.nd.array(y.numpy()))
        loss.backward()
        trainer.step(B)
        steps.append((_f64(logits), _f64(loss),
                      {n: _f64(jparams[n].grad()) for n in trainable},
                      {n: _f64(p.data()) for n, p in jparams.items()}))
    states = trainer._updaters[0].states
    momenta = {n: _f64(states[i]) for i, n in enumerate(jparams)
               if n in trainable}
    assert {str(p.data().dtype) for p in jparams.values()} == {"bfloat16"}
    return layout, arrays, batches, trainable, steps, momenta


def _port_bf16_fit(layout, arrays, batches, monkeypatch):
    """The port's own ``fit_gluon --dtype bfloat16`` from the carried fp32
    arrays (its ``initialize`` keeps them); after each step its logits,
    loss, gradients and buffers."""
    tnet = port_model("resnet18_v1", arrays, classes=10, layout=layout)
    monkeypatch.setattr(tnet, "initialize", lambda *a, **k: None)
    seen, logits, train_step = [], [], ic.train_step

    def recording_step(net, trainer, loss_fn, metric_, x, y, batch_size):
        assert x.dtype == BF16 and y.dtype == torch.float32
        loss = train_step(net, trainer, loss_fn, metric_, x, y, batch_size)
        seen.append((_f64(logits[-1]), _f64(loss), {
            n: _f64(p.grad) for n, p in net.named_parameters()
            if p.requires_grad}, {
            n: _f64(b) for n, b in net.named_buffers()}, trainer))
        return loss

    hook = tnet.register_forward_hook(lambda m, i, o: logits.append(o))
    monkeypatch.setattr(ic, "train_step", recording_step)
    assert ic.fit_gluon(_fit_args(), tnet, FirstBatches(batches)) is tnet
    hook.remove()
    return tnet, seen


def _fp64_step1(layout, arrays, batches):
    """The port's step 1 in fp64 from the weights and batch the bf16 runs
    start from (the fp32 arrays and data rounded to bf16): logits, loss,
    gradients and buffers."""
    net = port_model("resnet18_v1", arrays, classes=10, layout=layout)
    net.cast("bfloat16").cast("float64")
    x, y = batches[0]
    with autograd.record():
        logits = net(x.to(BF16).double())
        loss = SoftmaxCrossEntropyLoss()(logits, y.double())
    loss.backward(torch.ones_like(loss))
    return _f64(logits), _f64(loss), {
        n: _f64(p.grad) for n, p in net.named_parameters()
        if p.requires_grad}, {n: _f64(b) for n, b in net.named_buffers()}


def _stats_gap(got, want):
    """The largest gap of a running statistic, relative to the largest
    value of its array; ``got`` and ``want`` keyed alike."""
    return max(np.abs(got[n] - w).max() / np.abs(w).max()
               for n, w in want.items())


def _step1_stats(jarrays, pairs):
    """The JAX arrays' running statistics after step 1, keyed by the
    port's buffer names."""
    return {pairs[n]: a for n, a in jarrays.items()
            if n.endswith(("running_mean", "running_var"))}


def test_fit_gluon_bf16_two_steps_match_jax_trainer(jax_bf16_fit,
                                                    monkeypatch):
    layout, arrays, batches, trainable, steps, momenta = jax_bf16_fit
    tnet, seen = _port_bf16_fit(layout, arrays, batches, monkeypatch)
    pairs = mxnet_pairs(tnet, arrays)
    assert {t.dtype for t in tnet.state_dict().values()} == {BF16}
    (jlogits, jloss, jgrads, jarrays), (tlogits, tloss, tgrads, tbufs, _) = \
        steps[0], seen[0]
    assert np.abs(tlogits - jlogits).max() <= 2 * LOGIT_FP64
    assert np.abs(tloss - jloss).max() <= 2 * LOSS_FP64
    for n in trainable:
        assert _rel(tgrads[pairs[n]], jgrads[n]) <= 2 * FP64_REL, n
    assert _stats_gap(tbufs, _step1_stats(jarrays, pairs)) <= 2 * RSTAT_FP64
    assert all(np.all(np.isfinite(s[1])) for s in seen)
    # SGD with momentum, each array rounded to bf16: mom_t = MOM mom_{t-1}
    # - LR (g_t / B + WD w_{t-1}), w_t = w_{t-1} + mom_t.  A gap d_t in the
    # summed gradient moves mom_t by LR d_t / B and w_t with it
    trainer = seen[-1][4]
    # the Trainer indexes every parameter, as the JAX one does
    tindex = {n: i for i, n in enumerate(tnet._collect_params_with_prefix())}
    state = tnet.state_dict()
    w1, final = steps[0][3], steps[1][3]
    for n in trainable:
        d1, d2 = (np.abs(s[2][pairs[n]] - js[2][n]) / B
                  for s, js in zip(seen, steps))
        mom_bound = LR * (MOM * d1 + d2) + LR * WD * LR * d1
        w_bound = LR * d1 + mom_bound
        got_m = _f64(trainer._updater.states[tindex[pairs[n]]])
        w0 = _f64(torch.tensor(arrays[n]).to(BF16))
        terms = (np.abs(got_m) + np.abs(momenta[n])
                 + MOM * np.abs(w1[n] - w0)
                 + LR * WD * (np.abs(w0) + np.abs(w1[n]))
                 + LR * (np.abs(steps[0][2][n]) + np.abs(steps[1][2][n])) / B)
        assert np.all(np.abs(got_m - momenta[n])
                      <= mom_bound + BF16_ROUND * terms), n
        got_w = _f64(state[pairs[n]])
        terms += (np.abs(got_w) + np.abs(final[n]) + np.abs(w1[n])
                  + np.abs(w1[n] - w0))
        assert np.all(np.abs(got_w - final[n])
                      <= w_bound + BF16_ROUND * terms), n


def test_resnet18_bf16_step_is_as_accurate_as_jax(jax_bf16_fit,
                                                  monkeypatch):
    """Why the fit's bounds: against the port's fp64 step from the same
    bf16-rounded weights and batch, both packages' bf16 logits, loss,
    gradients and running statistics lie within the ``*_FP64`` bounds, and
    the port's median leaf is no farther than twice the JAX package's."""
    layout, arrays, batches, trainable, steps, _ = jax_bf16_fit
    tnet, seen = _port_bf16_fit(layout, arrays, batches, monkeypatch)
    pairs = mxnet_pairs(tnet, arrays)
    l64, loss64, g64, b64 = _fp64_step1(layout, arrays, batches)
    (jlogits, jloss, jgrads, jarrays), (tlogits, tloss, tgrads, tbufs, _) = \
        steps[0], seen[0]
    for logits, loss in ((tlogits, tloss), (jlogits, jloss)):
        assert np.abs(logits - l64).max() <= LOGIT_FP64
        assert np.abs(loss - loss64).max() <= LOSS_FP64
    port_rel = {n: _rel(tgrads[pairs[n]], g64[pairs[n]]) for n in trainable}
    jax_rel = {n: _rel(jgrads[n], g64[pairs[n]]) for n in trainable}
    jstats = _step1_stats(jarrays, pairs)
    want = {n: b64[n] for n in jstats}
    print("%s worst leaf: port %.3g, JAX %.3g; median: port %.3g, JAX %.3g;"
          " running stats: port %.3g, JAX %.3g" % (
              layout, max(port_rel.values()), max(jax_rel.values()),
              np.median(list(port_rel.values())),
              np.median(list(jax_rel.values())),
              _stats_gap(tbufs, want), _stats_gap(jstats, want)))
    assert max(port_rel.values()) <= FP64_REL
    assert max(jax_rel.values()) <= FP64_REL
    assert np.median(list(port_rel.values())) \
        <= 2 * np.median(list(jax_rel.values()))
    assert _stats_gap(tbufs, want) <= RSTAT_FP64
    assert _stats_gap(jstats, want) <= RSTAT_FP64


# --------------------------------------------------------- the LM, bf16

LM_LR = 3e-3
LM_B, LM_T = 4, 64


@pytest.fixture(scope="module")
def jax_bf16_lm():
    """The JAX example LM cast to bf16, two steps of Adam with
    ``multi_precision=True`` at the example's lr; recorded once: the
    starting arrays, the batches, each step's loss and gradients, the fp32
    masters and the bf16 weights at the end."""
    jnet, _ = _lm_pair()
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    jnet.cast("bfloat16")
    trainer = mx.gluon.Trainer(jnet.collect_params(), "adam", {
        "learning_rate": LM_LR, "multi_precision": True})
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(0)
    pos = np.tile(np.arange(LM_T, dtype=np.int32), (LM_B, 1))
    batches, steps = [], []
    for _ in range(2):
        x, y = tlm.pattern_batch(rng, LM_B, LM_T, VOCAB)
        batches.append((x, y))
        with mx.autograd.record():
            loss = ce(jnet(mx.nd.array(x, dtype="int32"),
                           mx.nd.array(pos, dtype="int32")).reshape(
                               (-1, VOCAB)),
                      mx.nd.array(y.astype(np.float32)).reshape((-1,))).mean()
        loss.backward()
        trainer.step(1)
        steps.append((float(_f64(loss).sum()), {
            n: _f64(p.grad()) for n, p in jnet.collect_params().items()}))
    states = trainer._updaters[0].states
    masters = {n: _f64(states[i][1])
               for i, n in enumerate(jnet.collect_params())}
    weights = {n: _f64(p.data()) for n, p in jnet.collect_params().items()}
    return arrays, batches, pos, steps, masters, weights


def _lm_step(net, x, y, pos):
    """The example's forward, loss (mean over tokens) and backward."""
    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(
            net(torch.from_numpy(x), torch.from_numpy(pos)).reshape(-1, VOCAB),
            torch.from_numpy(y.astype(np.float32)).reshape(-1)).mean()
    loss.backward()
    return loss


def _attention_fp64(q, k, v, causal, scale):
    """The plain attention without its fp32 cast of the scores."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    rows = torch.arange(q.shape[2])[:, None]
    s = s.masked_fill(torch.arange(k.shape[2])[None, :] > rows, -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


def _port_lm(arrays):
    return load_mxnet_params(_lm_pair()[1], arrays)


def test_lm_bf16_multi_precision_adam_matches_jax(jax_bf16_lm):
    arrays, batches, pos, steps, masters, weights = jax_bf16_lm
    tnet = _port_lm(arrays).cast("bfloat16")
    trainer = gluon.Trainer(tnet.named_parameters(), "adam", {
        "learning_rate": LM_LR, "multi_precision": True})
    names = {n: mxnet_to_torch_name(tnet, n) for n in arrays}
    params = dict(tnet.named_parameters())
    seen = []
    for (x, y), (jloss, jgrads) in zip(batches, steps):
        loss = _lm_step(tnet, x, y, pos)
        assert loss.dtype == BF16
        assert abs(loss.item() - jloss) <= 2 * LM_LOSS_FP64
        grads = {n: _f64(params[names[n]].grad) for n in arrays}
        for n, g in grads.items():
            assert _rel(g, jgrads[n]) <= 2 * LM_FP64_REL, n
        seen.append(grads)
        trainer.step(1)
    index = {name: i for i, name in enumerate(params)}
    for n in arrays:
        master = trainer._updater.states[index[names[n]]][1]
        param = params[names[n]].detach()
        assert master.dtype == torch.float32 and param.dtype == BF16
        assert torch.equal(param, master.to(BF16))
        gaps = [np.abs(g[n] - js[1][n]) for g, js in zip(seen, steps)]
        bound = (LM_RTOL * np.abs(masters[n]) + LM_ATOL
                 + _adam_gap_bound([js[1][n] for js in steps], gaps, LM_LR))
        assert np.all(np.abs(_f64(master) - masters[n]) <= bound), n
        assert np.all(np.abs(_f64(param) - weights[n])
                      <= bound + BF16_STEP * np.abs(weights[n])), n
    assert trainer._optimizer.num_update == 2


def test_lm_bf16_gradients_are_as_accurate_as_jax(jax_bf16_lm, monkeypatch):
    """Why the LM's bounds: against the port's fp64 step from the same
    bf16-rounded weights, both packages' bf16 loss and step-1 gradients
    lie within LM_LOSS_FP64 and LM_FP64_REL."""
    arrays, batches, pos, steps, _, _ = jax_bf16_lm
    tnet = _port_lm(arrays).cast("bfloat16")
    x, y = batches[0]
    loss = _lm_step(tnet, x, y, pos).item()
    monkeypatch.setattr(cuda_ops, "_attention_reference", _attention_fp64)
    t64 = _port_lm(arrays).cast("bfloat16").cast("float64")
    loss64 = _lm_step(t64, x, y, pos).item()
    assert abs(loss - loss64) <= LM_LOSS_FP64
    assert abs(steps[0][0] - loss64) <= LM_LOSS_FP64
    port, exact = dict(tnet.named_parameters()), dict(t64.named_parameters())
    for n in arrays:
        key = mxnet_to_torch_name(tnet, n)
        truth = _f64(exact[key].grad)
        assert _rel(_f64(port[key].grad), truth) <= LM_FP64_REL, n
        assert _rel(steps[0][1][n], truth) <= LM_FP64_REL, n


# --------------------------------------------------- carried bf16 arrays

def test_converter_carries_bf16_and_fp16_arrays_bit_for_bit(jax_bf16_lm):
    """The JAX package's ``asnumpy()`` of a cast block gives ``ml_dtypes``
    bfloat16 arrays (and numpy float16 ones): they arrive bit for bit, in
    a cast model and, widened exactly, in an fp32 one."""
    arrays = jax_bf16_lm[0]
    jnet, _ = _lm_pair()
    for dtype in ("bfloat16", "float16"):
        jnet.cast("float32")
        for p, a in zip(jnet.collect_params().values(), arrays.values()):
            p.set_data(mx.nd.array(a))
        jnet.cast(dtype)
        low = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
        assert {a.dtype.name for a in low.values()} == {dtype}
        cast = load_mxnet_params(_lm_pair()[1].cast(dtype), low)
        wide = load_mxnet_params(_lm_pair()[1], low)
        cast_params, wide_params = (dict(cast.named_parameters()),
                                    dict(wide.named_parameters()))
        for n, a in low.items():
            key = mxnet_to_torch_name(cast, n)
            got = cast_params[key].detach()
            assert _dtype_name(got) == dtype
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  a.view(np.int16)), n
            assert torch.equal(wide_params[key].detach(), got.float()), n
