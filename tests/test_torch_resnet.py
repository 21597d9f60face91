"""mxnet_tpu_torch's ResNet model zoo, weight converter and ``fit_gluon``
loop against the JAX package's.

For the forward and converter tests the JAX model is built with a fixed
``mx.random.seed`` and Xavier, its BatchNorm arrays replaced by seeded
random values, and its arrays carried into the port with
``convert.load_mxnet_params``.  The ``fit_gluon`` parity runs both
packages' loops from the same ``mx.random.seed``: the same weights and
the same shuffled batches, drawn by each package itself.

- Forward, outside ``record()`` (running statistics): rtol/atol 1e-4, the
  bound tests/test_gluon.py pins for one model across layouts.
- ``fit_gluon``, two SGD steps of ``resnet50_v1`` at the example's defaults
  (lr 0.1, momentum 0.9, wd 1e-4) on 2 x 3 x 64 x 64 batches of the
  example's synthetic set, against the JAX ``gluon.Trainer`` loop run as
  ``common.py``'s ``fit_gluon`` runs it.  ResNet-50 v1's training step is
  ill-conditioned in fp32 at this size: its last stage normalizes 8 values
  a channel (2 x 2 x 2), and each package's step-1 gradient lies up to 4%
  of a leaf's norm from an fp64 run of the port (``test_resnet50_fp32_
  gradients_are_as_accurate_as_jax``; FP64_REL = 0.05 over the worst
  measured: the JAX package 0.041 from seed 0's weights, 0.030 from the
  carried ones with random BatchNorm arrays; ResNet-18's
  lies within 1e-5).  So the step-1
  gradients are held per leaf at GRAD_REL = 2 x FP64_REL of the leaf's
  norm, plus GRAD_ABS for the conv biases that feed a BatchNorm, whose
  exact gradient is 0.  Step 1's loss: the port's within LOSS_BOUND of an
  fp64 run of the port, and within JAX_LOSS_BOUND = 2 x LOSS_BOUND of the
  JAX package's.  Seed 0's logits reach 9, and each fp32 loss lies about
  LOSS_BOUND from fp64 (measured: the port's 8.05e-5, the JAX package's
  1.28e-4), so two of them may lie twice that apart (measured: 1.07e-4).
  SGD is linear in the gradient: the weights and
  momenta after two steps are held at what the update makes of the
  measured per-element gradient gaps, plus fp32 rounding.  The running
  statistics after the second step come from weights the first step put
  apart, and are held at a quarter of their scale.
- Training-mode forward of the channel-last model against the
  channel-first one at 64 x 64: TRAIN_FWD_BOUND, 3x the fp32 logits' gap
  to fp64 there (3.2e-4 on logits up to 4.8); at 32 x 32 the last stage
  normalizes 2 values a channel, and an fp32 run's last-stage features lie
  38% from an fp64 run's.
"""
import argparse
import functools
import importlib.util
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import MXNetError, autograd, gluon, io, metric
from mxnet_tpu_torch.convert import load_mxnet_params, mxnet_pairs
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.models import image_classification as ic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_RTOL = FWD_ATOL = 1e-4          # tests/test_gluon.py:329
LOSS_BOUND = 1e-4
JAX_LOSS_BOUND = 2 * LOSS_BOUND   # measured 1.07e-4 at FIT_SEED
FP64_REL = 0.05     # worst leaf measured: JAX 0.030, port 0.024-0.028
GRAD_REL, GRAD_ABS = 2 * FP64_REL, 1e-3
TRAIN_FWD_BOUND = 1e-3
W_RTOL, W_ATOL = 1e-5, 1e-6
LR, MOM, WD = 0.1, 0.9, 1e-4        # common.py's defaults


@pytest.fixture(autouse=True)
def _two_threads():
    """The CPU training steps here run beside the suite's other workers;
    two intra-op threads keep them from crowding those workers' timed
    tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _example_common():
    """example/image-classification/common.py, under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "image_classification_common",
        os.path.join(REPO, "example", "image-classification", "common.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_model(name, size, seed=0, training=False, forward=True, **kw):
    """The JAX model, Xavier from ``seed``, with random BatchNorm arrays.
    Its deferred initialization runs a forward of a batch of two (in
    training mode with ``training``), the batch and mode of the forwards
    that the tests then take, whose operations it compiles.  Without
    ``forward`` the deferred shapes are set from the port's model instead
    (its own first call fills them; the two list their arrays in one
    order), and nothing is compiled for a forward the test does not
    take."""
    mx.random.seed(seed)
    net = jvision.get_model(name, **kw)
    if not forward:
        for p, shape in zip(net.collect_params().values(),
                            port_shapes(name, **kw)):
            p.shape = shape
    net.initialize(mx.init.Xavier())
    shape = (2, size, size, 3) if kw.get("layout") == "NHWC" \
        else (2, 3, size, size)
    if forward:
        with mx.autograd.train_mode() if training \
                else mx.autograd.predict_mode():
            net(mx.nd.zeros(shape))   # finish deferred init
    rng = np.random.RandomState(seed + 1)
    for pname, p in net.collect_params().items():
        if pname.endswith(("gamma", "running_var")):
            p.set_data(mx.nd.array(rng.uniform(0.5, 1.5, p.shape)))
        elif pname.endswith(("beta", "running_mean")):
            p.set_data(mx.nd.array(rng.uniform(-0.5, 0.5, p.shape)))
    return net


@functools.lru_cache(maxsize=None)
def _shared_jax_model(name, size, classes, layout, thumbnail):
    return jax_model(name, size, classes=classes, layout=layout,
                     thumbnail=thumbnail)


def shared_jax_model(name, size, classes=1000, layout="NCHW",
                     thumbnail=False):
    """:func:`jax_model` built once per module for the tests that only run
    it in inference or read its arrays: none of them changes it."""
    return _shared_jax_model(name, size, classes, layout, thumbnail)


@pytest.fixture(autouse=True, scope="module")
def _release_shared_jax_models():
    yield
    _shared_jax_model.cache_clear()


def port_shapes(name, **kw):
    """The shapes of the port model's arrays, in order, once its first call
    has filled the deferred ones."""
    net = vision.get_model(name, device="cpu", **kw)
    net.initialize(tmx.init.Zero())
    size = 16 if kw.get("thumbnail") else 32
    shape = (1, size, size, 3) if kw.get("layout") == "NHWC" \
        else (1, 3, size, size)
    with torch.no_grad():
        net(torch.zeros(shape))
    return [p.shape for p in net.collect_params().values()]


def arrays_of(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def port_model(name, arrays, **kw):
    return load_mxnet_params(vision.get_model(name, device="cpu", **kw),
                             arrays)


@pytest.mark.parametrize("name,classes,layout", [
    ("resnet18_v1", 10, "NCHW"), ("resnet50_v1", 1000, "NCHW"),
    ("resnet18_v2", 10, "NCHW"), ("resnet18_v2", 10, "NHWC")])
def test_forward_matches_jax(name, classes, layout):
    jnet = shared_jax_model(name, 32, classes=classes, layout=layout)
    tnet = port_model(name, arrays_of(jnet), classes=classes, layout=layout)
    x = np.random.RandomState(2).uniform(-1, 1, (2, 3, 32, 32)).astype(
        np.float32)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    want = jnet(mx.nd.array(x)).asnumpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, classes)
    assert np.allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL), \
        np.abs(got - want).max()


def test_nhwc_matches_nchw_in_the_port():
    """The channel-last resnet50_v1 with the channel-first one's weights
    (conv weights permuted to (O, kH, kW, I)) on the permuted input, in
    inference and in training (batch statistics, their running fold)."""
    cf = port_model("resnet50_v1",
                    arrays_of(shared_jax_model("resnet50_v1", 32)))
    cl = vision.resnet50_v1(layout="NHWC", device="cpu")
    # the same structural names; loading fills cl's deferred shapes
    cl.load_state_dict({name: a.permute(0, 2, 3, 1) if a.dim() == 4 else a
                        for name, a in cf.state_dict().items()})
    rng = np.random.RandomState(3)
    for size, training, bound in ((32, False, FWD_ATOL),
                                  (64, True, TRAIN_FWD_BOUND)):
        x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, size, size)).astype(
            np.float32))
        xl = x.permute(0, 2, 3, 1).contiguous()
        with torch.no_grad(), autograd.train_mode() if training \
                else autograd.predict_mode():
            a, b = cf(x), cl(xl)
        assert torch.allclose(a, b, rtol=bound, atol=bound), \
            (a - b).abs().max()
    for (name, a), b in zip(cf.named_buffers(), cl.buffers()):
        assert torch.allclose(a, b, rtol=FWD_RTOL, atol=FWD_ATOL), name


def test_converter_round_trip_resnet50_v1():
    """299 arrays: 53 conv weights, 32 conv biases, 53 x 4 BatchNorm
    arrays and the dense pair; 193 of them train."""
    arrays = arrays_of(shared_jax_model("resnet50_v1", 32))
    tnet = port_model("resnet50_v1", arrays)
    state = tnet.state_dict()
    assert len(arrays) == len(state) == 299
    assert sum(p.requires_grad for p in tnet.parameters()) == 193
    pairs = mxnet_pairs(tnet, arrays)
    kinds = [n.rsplit("_", 1)[-1] for n in arrays]
    assert kinds.count("bias") == 33 and kinds.count("weight") == 54
    for name, key in pairs.items():
        assert np.array_equal(state[key].numpy(), arrays[name]), name


@pytest.mark.parametrize("name,layout", [("resnet18_v1", "NHWC"),
                                         ("resnet34_v2", "NCHW")])
def test_converter_carries_each_version_and_layout(name, layout):
    arrays = arrays_of(jax_model(name, 32, layout=layout, forward=False))
    tnet = port_model(name, arrays, layout=layout)
    state = tnet.state_dict()
    assert len(state) == len(arrays)
    for a, (key, b) in zip(arrays.values(), state.items()):
        assert np.array_equal(a, b.numpy()), key


def test_converter_raises_on_missing_extra_or_misshaped_arrays():
    arrays = arrays_of(jax_model("resnet18_v1", 32, forward=False))
    tnet = vision.resnet18_v1(device="cpu")
    missing = dict(arrays)
    del missing[next(n for n in arrays
                     if n.endswith("stage2_batchnorm1_running_mean"))]
    with pytest.raises(MXNetError, match=r"missing arrays \['stage2_"
                                         r"batchnorm1_running_mean'\]"):
        load_mxnet_params(tnet, missing)
    last = dict(arrays)
    del last[next(n for n in reversed(list(arrays)))]
    with pytest.raises(MXNetError, match=r"missing arrays \['dense0_bias'\]"):
        load_mxnet_params(tnet, last)
    extra = dict(arrays, resnetv10_dense1_weight=np.zeros((4, 4)))
    with pytest.raises(MXNetError, match="extra array "
                                         "'resnetv10_dense1_weight'"):
        load_mxnet_params(tnet, extra)
    misshaped = dict(arrays)
    conv = next(n for n in arrays if n.endswith("stage3_conv2d0_weight"))
    misshaped[conv] = misshaped[conv][:, :, :2]
    with pytest.raises(MXNetError, match="stage3_conv2d0_weight.*shape"):
        load_mxnet_params(tnet, misshaped)
    # names that cannot agree (another model's prefix): paired by position
    renamed = {"other_" + n.split("_", 1)[1]: a for n, a in arrays.items()}
    state = load_mxnet_params(vision.resnet18_v1(device="cpu"),
                              renamed).state_dict()
    for a, (key, b) in zip(arrays.values(), state.items()):
        assert np.array_equal(a, b.numpy()), key
    # channel-first arrays into a channel-last model
    with pytest.raises(MXNetError, match="conv2d0_weight.*does not pair"):
        load_mxnet_params(vision.resnet18_v1(layout="NHWC", device="cpu"),
                          arrays)


def test_get_model_and_pretrained():
    net = vision.get_model("ResNet18_V2", classes=7, device="cpu")
    assert isinstance(net, vision.ResNetV2) and net.output.weight.shape \
        == (7, 512)
    with pytest.raises(ValueError, match="(?s)Model vgg17 is not supported. "
                                         "Available options are.*resnet50_v1"
                                         ".*vgg16"):
        vision.get_model("vgg17", device="cpu")
    with pytest.raises(NotImplementedError, match="pretrained"):
        vision.resnet18_v1(pretrained=True, device="cpu")
    with pytest.raises(ValueError, match="Invalid number of layers"):
        vision.get_resnet(1, 20, device="cpu")


def test_thumbnail_model_matches_jax():
    jnet = shared_jax_model("resnet18_v1", 16, classes=10, thumbnail=True)
    tnet = port_model("resnet18_v1", arrays_of(jnet), classes=10,
                      thumbnail=True)
    x = np.random.RandomState(4).uniform(-1, 1, (2, 3, 16, 16)).astype(
        np.float32)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert np.allclose(got, jnet(mx.nd.array(x)).asnumpy(), rtol=FWD_RTOL,
                       atol=FWD_ATOL)


def test_constructors_need_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        vision.resnet18_v1()
    with pytest.raises(MXNetError, match="no CUDA device"):
        ic.main(["--network", "resnet18_v1", "--num-classes", "10",
                 "--image-shape", "3,32,32"])


def test_xavier_draws_channel_last_weights_in_canonical_order():
    cf = vision.resnet18_v1(device="cpu")
    cl = vision.resnet18_v1(layout="NHWC", device="cpu")
    for net, shape in ((cf, (1, 3, 16, 16)), (cl, (1, 16, 16, 3))):
        tmx.random.seed(3)
        net.initialize(tmx.init.Xavier())
        with torch.no_grad():
            net(torch.zeros(shape))   # draws the deferred weights
    for (name, a), b in zip(cf.state_dict().items(),
                            cl.state_dict().values()):
        assert torch.equal(a.permute(0, 2, 3, 1) if a.dim() == 4 else a,
                           b), name
    bn = cf.features[1]
    assert torch.equal(bn.running_var, torch.ones(64))
    assert torch.equal(bn.running_mean, torch.zeros(64))


# ------------------------------------------------------------ training

def _args(**kw):
    args = dict(network="resnet50_v1", num_classes=1000, num_epochs=1, lr=LR,
                optimizer="sgd", mom=MOM, wd=WD, batch_size=2,
                kv_store="device", disp_batches=1, dtype="float32")
    args.update(kw)
    return argparse.Namespace(**args)


def test_synthetic_set_is_the_examples():
    """The example's arrays, shuffled by each package's ``NDArrayIter``
    from the same seed: the same batches in the same order, padded from
    the start at the end of each epoch, and reshuffled by ``reset``."""
    args = _args(batch_size=12, num_classes=10)
    mx.random.seed(5)
    tmx.random.seed(5)
    jit = _example_common().get_synthetic_iter(args, (3, 8, 8))
    tit = ic.get_synthetic_iter(args, (3, 8, 8), "cpu")
    assert isinstance(tit, io.NDArrayIter)
    assert tit.provide_data[0].shape == (12, 3, 8, 8)
    for epoch in range(2):
        jb, tb = list(jit), list(tit)
        assert len(tb) == len(jb) == 27
        for j, t in zip(jb, tb):
            assert t.pad == j.pad
            assert np.array_equal(t.data[0].asnumpy(), j.data[0].asnumpy())
            assert np.array_equal(t.label[0].asnumpy(),
                                  j.label[0].asnumpy())
        assert tb[-1].pad == 4
        jit.reset()
        tit.reset()


def synthetic_batches(args, image_shape, n):
    """The first ``n`` batches of the example's synthetic set, in the
    order it was drawn, as (data, label) tensors."""
    it = ic.get_synthetic_iter(args, image_shape, "cpu")
    (_, X), (_, Y) = it.data[0], it.label[0]
    B = args.batch_size
    return [(X[i * B:(i + 1) * B], Y[i * B:(i + 1) * B]) for i in range(n)]


class FirstBatches(io.DataIter):
    """``fit_gluon``'s iterator over fewer batches than an epoch: the
    first ``n`` batches of ``source`` (an ``io.DataIter``, reset with it)
    or the (data, label) tensors given."""

    def __init__(self, source, n=None):
        super().__init__()
        if isinstance(source, list):
            n = len(source)
            source = [io.DataBatch([tmx.nd.NDArray(x)], [tmx.nd.NDArray(y)])
                      for x, y in source]
        self._source, self._n, self._i = source, n, 0

    def next(self):
        if self._i == self._n:
            raise StopIteration
        self._i += 1
        if isinstance(self._source, list):
            return self._source[self._i - 1]
        return self._source.next()

    def reset(self):
        self._i = 0
        if not isinstance(self._source, list):
            self._source.reset()


def _jax_step(net, x, y, trainer=None):
    """The JAX loop's forward and backward, and its update if a
    ``trainer`` is given; returns the per-sample loss."""
    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
            net(mx.nd.array(x.numpy())), mx.nd.array(y.numpy()))
    loss.backward()
    if trainer is not None:
        trainer.step(x.shape[0])
    return loss.asnumpy()


FIT_SEED = 0


@pytest.fixture(scope="module")
def jax_fit():
    """The JAX loop as ``common.py``'s ``fit_gluon`` runs it, from
    ``mx.random.seed(FIT_SEED)``: the example's shuffled synthetic set (B =
    2, 64 x 64), Xavier, one batch to fill the deferred shapes, ``reset``,
    then two SGD steps at the example's defaults through the Gluon
    Trainer; recorded once for the tests that hold the port to it, keyed by
    structural name: the starting arrays, the batches, and after each step
    its loss, the gradients and every array; the momenta at the end."""
    mx.random.seed(FIT_SEED)
    it = _example_common().get_synthetic_iter(_args(), (3, 64, 64))
    jnet = jvision.get_model("resnet50_v1")
    jnet.initialize(mx.init.Xavier())
    jnet(it.next().data[0])
    it.reset()
    names = {p.name: key
             for key, p in jnet._collect_params_with_prefix().items()}

    def arrays():
        return {names[n]: a for n, a in arrays_of(jnet).items()}

    start = arrays()
    jtrainer = mx.gluon.Trainer(jnet.collect_params(), "sgd",
                                {"learning_rate": LR, "momentum": MOM,
                                 "wd": WD})
    jparams = jnet.collect_params()
    trainable = [names[n] for n, p in jparams.items()
                 if p.grad_req != "null"]
    steps, batches = [], []
    for _ in range(2):
        batch = it.next()
        x, y = (torch.from_numpy(np.array(a[0].asnumpy()))
                for a in (batch.data, batch.label))
        batches.append((x, y))
        loss = _jax_step(jnet, x, y, jtrainer)
        steps.append((loss, {names[n]: p.grad().asnumpy()
                             for n, p in jparams.items()
                             if names[n] in trainable}, arrays()))
    states = jtrainer._updaters[0].states
    momenta = {names[n]: states[i].asnumpy()
               for i, n in enumerate(jparams) if names[n] in trainable}
    return start, batches, trainable, steps, momenta


def test_fit_gluon_two_steps_match_jax_trainer(monkeypatch, jax_fit):
    """The port's ``fit_gluon`` from the same seed draws the JAX loop's
    weights and batches itself (bit for bit), and its two steps match."""
    start, batches, trainable, steps, jmomenta = jax_fit
    seen, train_step = [], ic.train_step

    def recording_step(net, trainer, loss_fn, metric_, x, y, batch_size):
        if not seen:
            state = net.state_dict()
            for n, a in start.items():
                assert np.array_equal(state[n].numpy(), a), n
        assert torch.equal(x, batches[len(seen)][0])
        assert torch.equal(y, batches[len(seen)][1])
        loss = train_step(net, trainer, loss_fn, metric_, x, y, batch_size)
        seen.append((loss.detach().numpy(), trainer, {
            n: p.grad.clone() for n, p in net.named_parameters()
            if p.requires_grad}))
        return loss

    monkeypatch.setattr(ic, "train_step", recording_step)
    tmx.random.seed(FIT_SEED)
    train_iter = FirstBatches(
        ic.get_synthetic_iter(_args(), (3, 64, 64), "cpu"), 2)
    tnet = vision.resnet50_v1(device="cpu")
    assert ic.fit_gluon(_args(), tnet, train_iter) is tnet
    assert len(seen) == 2
    grad_gaps, jax_weights = [], []
    # step 1's loss: the port's within LOSS_BOUND of an fp64 run's, and
    # within JAX_LOSS_BOUND of the JAX package's
    loss64 = _fp64_loss(start, batches[0])
    for step, (jloss, jgrads, jarrays) in enumerate(steps):
        tloss, _, tgrads = seen[step]
        if step == 0:
            print("step-1 loss gaps: port-fp64 %.3g, JAX-fp64 %.3g, "
                  "port-JAX %.3g" % tuple(np.abs(a - b).max() for a, b in (
                      (tloss, loss64), (jloss, loss64), (tloss, jloss))))
            assert np.abs(tloss - loss64).max() < LOSS_BOUND
            assert np.abs(tloss - jloss).max() < JAX_LOSS_BOUND
        else:
            assert np.all(np.isfinite(tloss))
        gaps = {}
        for n in trainable:
            want = jgrads[n]
            got = tgrads[n].numpy()
            gaps[n] = np.abs(got.astype(np.float64) - want)
            if step == 0:
                gap = np.linalg.norm(got - want)
                assert gap <= GRAD_REL * np.linalg.norm(want) + GRAD_ABS, (
                    n, gap, np.linalg.norm(want))
        grad_gaps.append(gaps)
        jax_weights.append({n: a.astype(np.float64)
                            for n, a in jarrays.items()})
    # SGD with momentum: mom_t = MOM mom_{t-1} - LR (g_t / B + WD w_{t-1}),
    # w_t = w_{t-1} + mom_t.  A gap d_t in the summed gradient moves mom_t
    # by LR d_t / B and w_t with it, carried forward by MOM
    trainer = seen[-1][1]
    # the Trainer indexes every parameter, as the JAX one does
    tindex = {n: i for i, n in enumerate(tnet._collect_params_with_prefix())}
    state = tnet.state_dict()
    final = steps[-1][2]
    for n in trainable:
        d1, d2 = (gaps[n] / len(batches[0][0]) for gaps in grad_gaps)
        w1 = jax_weights[0][n]
        mom_bound = LR * (MOM * d1 + d2) + LR * WD * LR * d1
        w_bound = LR * d1 + mom_bound
        want_w = final[n]
        got_w = state[n].numpy()
        assert np.all(np.abs(got_w - want_w)
                      <= w_bound + W_RTOL * np.abs(want_w) + W_ATOL), n
        want_m = jmomenta[n]
        got_m = trainer._updater.states[tindex[n]].numpy()
        assert np.all(np.abs(got_m - want_m)
                      <= mom_bound + W_RTOL * np.abs(w1) + W_ATOL), n
    for n, want in final.items():
        if n.endswith(("running_mean", "running_var")):
            got = state[n].numpy()
            assert np.all(np.isfinite(got))
            assert np.abs(got - want).max() <= 0.25 * np.abs(want).max(), n


def _fp64_loss(arrays, batch):
    """The per-sample loss of the port's resnet50_v1 in fp64 from
    ``arrays`` (structural names) on ``batch``, in training mode."""
    net = vision.resnet50_v1(device="cpu")
    net.load_state_dict({n: torch.from_numpy(a) for n, a in arrays.items()})
    x, y = batch
    with torch.no_grad(), autograd.train_mode():
        loss = SoftmaxCrossEntropyLoss()(net.double()(x.double()),
                                         y.double())
    return loss.numpy()


def test_resnet50_fp32_gradients_are_as_accurate_as_jax(jax_fit):
    """Why GRAD_REL: against an fp64 run of the port, both packages' fp32
    step-1 gradients lie within FP64_REL of it, leaf by leaf, and the
    port's median leaf is no farther than twice the JAX package's."""
    start, batches, _, steps, _ = jax_fit
    tnet = vision.resnet50_v1(device="cpu")
    tnet.load_state_dict({n: torch.from_numpy(a) for n, a in start.items()})
    jgrads = steps[0][1]
    x, y = batches[0]
    t64 = vision.resnet50_v1(device="cpu")
    t64.load_state_dict(tnet.state_dict())
    t64.double()

    def port_grads(net, dtype):
        with autograd.record():
            loss = SoftmaxCrossEntropyLoss()(net(x.to(dtype)), y.to(dtype))
        loss.backward(torch.ones_like(loss))
        return {n: p.grad.double() for n, p in net.named_parameters()
                if p.requires_grad}

    g32, g64 = port_grads(tnet, torch.float32), port_grads(t64, torch.float64)
    port_rel, jax_rel = {}, {}
    for n, jgrad in jgrads.items():
        if n.endswith("bias") and not n.startswith("output"):
            continue
        truth = g64[n]
        scale = truth.norm().item()
        jax_rel[n] = np.linalg.norm(jgrad - truth.numpy()) / scale
        port_rel[n] = (g32[n] - truth).norm().item() / scale
    print("worst leaf: port %.3g (%s), JAX %.3g (%s); median: port %.3g, "
          "JAX %.3g" % (
              max(port_rel.values()), max(port_rel, key=port_rel.get),
              max(jax_rel.values()), max(jax_rel, key=jax_rel.get),
              np.median(list(port_rel.values())),
              np.median(list(jax_rel.values()))))
    assert max(port_rel.values()) <= FP64_REL
    assert max(jax_rel.values()) <= FP64_REL
    assert np.median(list(port_rel.values())) \
        <= 2 * np.median(list(jax_rel.values()))


def test_train_step_accumulates_accuracy_and_moves_running_stats():
    net = vision.resnet18_v1(classes=10, device="cpu")
    net.initialize(tmx.init.Xavier())
    batch = ic.get_synthetic_iter(_args(batch_size=4, num_classes=10),
                                  (3, 16, 16), "cpu").next()
    x, y = batch.data[0]._data, batch.label[0]._data
    net(x)   # fills the deferred shapes
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": LR, "momentum": MOM, "wd": WD})
    acc = metric.Accuracy()
    before = net.features[1].running_mean.clone()
    loss = ic.train_step(net, trainer, SoftmaxCrossEntropyLoss(), acc, x, y,
                         4)
    assert loss.shape == (4,) and acc.num_inst == 4
    assert not torch.equal(before, net.features[1].running_mean)


def test_main_trains_on_the_cpu(caplog):
    caplog.set_level(logging.INFO)
    net = ic.main(["--device", "cpu", "--network", "resnet18_v1",
                   "--num-classes", "10", "--image-shape", "3,32,32",
                   "--disp-batches", "5"])
    assert all(torch.isfinite(t).all() for t in net.state_dict().values())
    text = caplog.text
    assert "Epoch[0] Batch [10] Speed:" in text
    assert "Epoch[0] done in" in text and "accuracy=" in text
