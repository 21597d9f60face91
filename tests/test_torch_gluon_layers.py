"""The Gluon layers and losses added to mxnet_tpu_torch, against the JAX
package's.

- The three faults repaired: ``mx.gluon`` resolves in both packages, a
  loss takes ``prefix``/``params``, and a loss called on Symbols returns
  the JAX package's graph (string-equal JSON, built in a fresh
  ``NameManager`` in both).
- Each new layer (``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``Swish``,
  ``GELU``, ``InstanceNorm``, ``ReflectionPad2D``, ``Sequential``,
  ``Lambda``, ``HybridLambda``) and each loss: the output, the input's
  gradient and the parameters' gradients at ``tests/test_gluon.py``'s and
  ``tests/test_loss.py``'s bounds (``TOL``), from seeded numpy inputs and
  seeded head gradients.
- ``CTCLoss`` per sample and its gradient against the JAX op, with and
  without lengths.
- The transposed convolutions and the 1-D and 3-D pools: output and
  gradients at ``TOL``, graph JSON string-equal; ``Block.summary``'s table
  equal; ``Parameter.list_data``/``list_grad``/``list_ctx``;
  ``gluon.Constant`` (and where it diverges, deliberately).
"""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu_torch import gluon as tgluon

TOL = dict(rtol=1e-5, atol=1e-6)


def _rng(seed=0):
    return np.random.RandomState(seed)


def test_mx_gluon_resolves_in_both_packages():
    assert tmx.gluon.nn.Dense is tgluon.nn.Dense
    assert mx.gluon.nn.Dense is jgluon.nn.Dense
    assert tmx.gluon.loss.L2Loss.__name__ == mx.gluon.loss.L2Loss.__name__


def test_losses_take_prefix_and_params():
    for package in (mx, tmx):
        loss = package.gluon.loss.SoftmaxCrossEntropyLoss(prefix="ce_")
        assert loss.prefix == "ce_"
        shared = package.gluon.loss.L2Loss(prefix="l2_")
        other = package.gluon.loss.L2Loss(prefix="l2b_",
                                          params=shared.params)
        assert other.prefix == "l2b_"


LOSS_SYMBOLS = {
    "SoftmaxCrossEntropyLoss": (lambda g: g.loss.SoftmaxCrossEntropyLoss(),
                                2),
    "SoftmaxCE_dense": (lambda g: g.loss.SoftmaxCrossEntropyLoss(
        sparse_label=False, weight=0.5), 2),
    "L2Loss": (lambda g: g.loss.L2Loss(), 2),
    "L1Loss": (lambda g: g.loss.L1Loss(weight=2.0), 3),
    "SigmoidBCELoss": (lambda g: g.loss.SigmoidBCELoss(), 2),
    "KLDivLoss": (lambda g: g.loss.KLDivLoss(from_logits=False), 2),
    "HuberLoss": (lambda g: g.loss.HuberLoss(rho=0.5), 2),
    "HingeLoss": (lambda g: g.loss.HingeLoss(), 2),
    "SquaredHingeLoss": (lambda g: g.loss.SquaredHingeLoss(), 2),
    "LogisticLoss": (lambda g: g.loss.LogisticLoss(), 2),
    "TripletLoss": (lambda g: g.loss.TripletLoss(), 3),
    "CTCLoss": (lambda g: g.loss.CTCLoss(), 2),
}


@pytest.mark.parametrize("name", sorted(LOSS_SYMBOLS))
def test_loss_on_symbols_is_the_jax_graph(name):
    build, n_in = LOSS_SYMBOLS[name]
    out = {}
    for package in (mx, tmx):
        with package.name.NameManager():
            loss = build(package.gluon)
            args = [package.sym.var(v) for v in ("p", "l", "w")[:n_in]]
            out[package] = loss(*args)
    assert isinstance(out[tmx], tmx.sym.Symbol)
    assert out[tmx].list_arguments() == out[mx].list_arguments()
    assert out[tmx].tojson() == out[mx].tojson()


def _run(package, block, inputs, head, grad_inputs=(0,)):
    """``block(*inputs)`` recorded in train mode, backward with ``head``;
    the output, the gradients of ``grad_inputs`` and of the parameters
    (by structural name)."""
    if package is mx:
        arrays = [mx.nd.array(a) for a in inputs]
    else:
        arrays = [tmx.nd.array(a, ctx=tmx.cpu()) for a in inputs]
    for i in grad_inputs:
        arrays[i].attach_grad()
    with package.autograd.record():
        out = block(*arrays)
    out.backward(package.nd.array(head) if package is mx
                 else tmx.nd.array(head, ctx=tmx.cpu()))
    grads = [arrays[i].grad.asnumpy() for i in grad_inputs]
    pgrads = {k: p.grad().asnumpy() if package is mx else
              p.grad().asnumpy()
              for k, p in block._collect_params_with_prefix().items()
              if p.grad_req != "null"}
    return out.asnumpy(), grads, pgrads


def _pair(build, inputs, grad_inputs=(0,), seed=3, init=None):
    results = []
    for package in (mx, tmx):
        package.random.seed(seed)
        scope = tmx.cpu() if package is tmx else contextlib.nullcontext()
        with package.name.NameManager(), scope:
            block = build(package.gluon.nn, package)
        if package is tmx:
            block.initialize(init(package) if init else None, ctx=tmx.cpu())
        else:
            block.initialize(init(package) if init else None)
        results.append(block)
    jblock, tblock = results
    # fill deferred shapes with one forward in each
    if inputs and any(p._deferred_init for p in jblock.collect_params()
                      .values()):
        jblock(*[mx.nd.array(a) for a in inputs])
        tblock(*[tmx.nd.array(a, ctx=tmx.cpu()) for a in inputs])
    head_shape = jblock(*[mx.nd.array(a) for a in inputs]).shape
    head = _rng(9).normal(0, 1, head_shape).astype(np.float32)
    want = _run(mx, jblock, inputs, head, grad_inputs)
    got = _run(tmx, tblock, inputs, head, grad_inputs)
    return got, want


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, **TOL)
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], **TOL)


def _x(*shape, seed=1):
    return _rng(seed).uniform(-2, 2, shape).astype(np.float32)


LAYERS = {
    "LeakyReLU": (lambda nn, m: nn.LeakyReLU(0.1), [_x(3, 4)]),
    "PReLU": (lambda nn, m: nn.PReLU(), [_x(2, 3, 4)]),
    "PReLU_init": (lambda nn, m: nn.PReLU(m.init.Constant(0.4)),
                   [_x(2, 5)]),
    "ELU": (lambda nn, m: nn.ELU(0.7), [_x(3, 4)]),
    "SELU": (lambda nn, m: nn.SELU(), [_x(3, 4)]),
    "Swish": (lambda nn, m: nn.Swish(1.5), [_x(3, 4)]),
    "GELU": (lambda nn, m: nn.GELU(), [_x(3, 4)]),
    "InstanceNorm": (lambda nn, m: nn.InstanceNorm(scale=True),
                     [_x(2, 3, 4, 5)]),
    "InstanceNorm_axis": (lambda nn, m: nn.InstanceNorm(
        axis=2, center=False, scale=True, in_channels=4), [_x(2, 4, 4, 5)]),
    "ReflectionPad2D": (lambda nn, m: nn.ReflectionPad2D(2),
                        [_x(2, 3, 5, 6)]),
    "Sequential": (lambda nn, m: _seq(nn), [_x(2, 7)]),
    "HybridLambda_str": (lambda nn, m: nn.HybridLambda("tanh"),
                         [_x(3, 4)]),
    "HybridLambda_fn": (lambda nn, m: nn.HybridLambda(
        lambda F, x: F.relu(x) * 2 + F.sigmoid(x)), [_x(3, 4)]),
    "Lambda_str": (lambda nn, m: nn.Lambda("tanh"), [_x(3, 4)]),
    "Lambda_fn": (lambda nn, m: nn.Lambda(
        lambda x: m.nd.relu(x) + x * 0.5), [_x(3, 4)]),
}
# the transposed convolutions and the 1-D and 3-D pools
CONV_POOL = {
    "Conv1DTranspose": (lambda nn, m: nn.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1), [_x(2, 3, 7)]),
    "Conv2DTranspose": (lambda nn, m: nn.Conv2DTranspose(
        6, (3, 2), strides=(2, 1), padding=(1, 0), output_padding=(1, 0),
        dilation=(1, 2), groups=2, in_channels=4, activation="relu"),
        [_x(2, 4, 5, 6)]),
    "Conv2DTranspose_nobias": (lambda nn, m: nn.Conv2DTranspose(
        3, 3, use_bias=False), [_x(2, 2, 4, 4)]),
    "Conv3DTranspose": (lambda nn, m: nn.Conv3DTranspose(
        2, 2, strides=2, in_channels=3), [_x(1, 3, 3, 4, 3)]),
    "MaxPool1D": (lambda nn, m: nn.MaxPool1D(3, 2, 1, ceil_mode=True),
                  [_x(2, 3, 8)]),
    "MaxPool3D": (lambda nn, m: nn.MaxPool3D(2), [_x(2, 2, 4, 5, 4)]),
    "AvgPool1D": (lambda nn, m: nn.AvgPool1D(3, 2, 1,
                                             count_include_pad=False),
                  [_x(2, 3, 9)]),
    "AvgPool3D": (lambda nn, m: nn.AvgPool3D((2, 3, 2), ceil_mode=True),
                  [_x(2, 2, 5, 7, 4)]),
    "GlobalMaxPool1D": (lambda nn, m: nn.GlobalMaxPool1D(), [_x(2, 3, 6)]),
    "GlobalMaxPool3D": (lambda nn, m: nn.GlobalMaxPool3D(),
                        [_x(2, 3, 3, 4, 2)]),
    "GlobalAvgPool1D": (lambda nn, m: nn.GlobalAvgPool1D(), [_x(2, 3, 6)]),
    "GlobalAvgPool3D": (lambda nn, m: nn.GlobalAvgPool3D(),
                        [_x(2, 3, 3, 4, 2)]),
}
LAYERS.update(CONV_POOL)


def _seq(nn):
    net = nn.Sequential()
    with net.name_scope():
        net.add(nn.Dense(5, activation="tanh"))
        net.add(nn.LeakyReLU(0.2))
        net.add(nn.Dense(3))
    return net


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_output_and_gradients_are_the_jax_layers(name):
    build, inputs = LAYERS[name]
    got, want = _pair(build, inputs,
                      init=lambda m: m.init.Uniform(0.5))
    _assert_close(got, want)


def test_sequential_slices_and_hybridize_warning():
    with tmx.cpu():
        net = _seq(tgluon.nn)
    assert len(net) == 3 and isinstance(net[1], tgluon.nn.LeakyReLU)
    head = net[:2]
    assert isinstance(head, tgluon.nn.Sequential) and len(head) == 2
    with pytest.warns(UserWarning, match="HybridSequential"):
        net.hybridize()


def _loss_inputs(name):
    rng = _rng(4)
    pred = rng.uniform(-2, 2, (4, 6)).astype(np.float32)
    if name.startswith("SoftmaxCE") and "dense" not in name:
        label = rng.randint(0, 6, (4,)).astype(np.float32)
    elif name in ("HingeLoss", "SquaredHingeLoss", "LogisticLoss"):
        label = np.sign(rng.uniform(-1, 1, (4, 6))).astype(np.float32)
    elif name.startswith("SigmoidBCE") or name.startswith("KLDiv") or \
            "dense" in name:
        label = rng.uniform(0.05, 0.95, (4, 6)).astype(np.float32)
    else:
        label = rng.uniform(-2, 2, (4, 6)).astype(np.float32)
    return pred, label


LOSSES = {
    "SoftmaxCE": (lambda g: g.loss.SoftmaxCrossEntropyLoss(), 0),
    "SoftmaxCE_dense": (lambda g: g.loss.SoftmaxCrossEntropyLoss(
        sparse_label=False), 0),
    "SoftmaxCE_weighted": (lambda g: g.loss.SoftmaxCrossEntropyLoss(
        weight=0.5), 1),
    "L2Loss": (lambda g: g.loss.L2Loss(), 1),
    "L1Loss": (lambda g: g.loss.L1Loss(weight=2.0), 0),
    "SigmoidBCE": (lambda g: g.loss.SigmoidBCELoss(), 1),
    "SigmoidBCE_from_sigmoid": (lambda g: g.loss.SigmoidBCELoss(
        from_sigmoid=True), 0),
    "KLDiv": (lambda g: g.loss.KLDivLoss(from_logits=False), 0),
    "KLDiv_logits": (lambda g: g.loss.KLDivLoss(), 1),
    "HuberLoss": (lambda g: g.loss.HuberLoss(rho=0.7), 1),
    "HingeLoss": (lambda g: g.loss.HingeLoss(), 0),
    "SquaredHingeLoss": (lambda g: g.loss.SquaredHingeLoss(margin=0.5), 1),
    "LogisticLoss": (lambda g: g.loss.LogisticLoss(), 1),
    "LogisticLoss_binary": (lambda g: g.loss.LogisticLoss(
        label_format="binary"), 0),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_values_and_gradients_are_the_jax_losses(name):
    build, with_sample_weight = LOSSES[name]
    pred, label = _loss_inputs(name)
    if name == "SigmoidBCE_from_sigmoid":
        pred = 1 / (1 + np.exp(-pred))
    inputs = [pred, label]
    if with_sample_weight:
        inputs.append(_rng(6).uniform(0, 1, (4, 1)).astype(np.float32))
    got, want = _pair(lambda nn, m: build(m.gluon), inputs)
    _assert_close(got, want)


def test_sigmoid_bce_pos_weight_and_triplet_loss():
    pred, label = _loss_inputs("SigmoidBCE")
    pos_weight = _rng(7).uniform(0.5, 2, (1, 6)).astype(np.float32)
    for from_sigmoid in (False, True):
        p = 1 / (1 + np.exp(-pred)) if from_sigmoid else pred
        got, want = _pair(lambda nn, m: _PosWeight(
            m.gluon.loss.SigmoidBCELoss(from_sigmoid=from_sigmoid)),
            [p, label, pos_weight])
        _assert_close(got, want)
    rng = _rng(8)
    trip = [rng.uniform(-1, 1, (4, 5)).astype(np.float32) for _ in range(3)]
    got, want = _pair(lambda nn, m: m.gluon.loss.TripletLoss(margin=0.5),
                      trip, grad_inputs=(0, 1, 2))
    _assert_close(got, want)


class _PosWeight:
    """A loss called with ``pos_weight`` by keyword, as a block."""

    def __init__(self, loss):
        self._loss = loss

    def __call__(self, pred, label, pos_weight):
        return self._loss(pred, label, None, pos_weight)

    def initialize(self, *args, **kwargs):
        pass

    def collect_params(self):
        return {}

    def _collect_params_with_prefix(self):
        return {}


@pytest.mark.parametrize("lengths", [False, True])
def test_ctc_loss_and_its_gradient_are_the_jax_ops(lengths):
    rng = _rng(5)
    T, N, C = 12, 3, 6
    pred = rng.uniform(-1, 1, (N, T, C)).astype(np.float32)
    label = np.array([[1, 2, 2, -1], [3, 0, 4, 1], [2, -1, -1, -1]],
                     np.float32)
    inputs = [pred, label]
    if lengths:
        inputs += [np.array([12, 9, 7], np.float32),
                   np.array([3, 4, 1], np.float32)]
    got, want = _pair(lambda nn, m: _Lengths(m.gluon.loss.CTCLoss(),
                                             lengths), inputs)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1][0], want[1][0], rtol=1e-4, atol=1e-6)


class _Lengths(_PosWeight):
    def __init__(self, loss, lengths):
        super().__init__(loss)
        self._lengths = lengths

    def __call__(self, pred, label, *lengths):
        return self._loss(pred, label, *lengths)


@pytest.mark.parametrize("name", sorted(CONV_POOL))
def test_conv_and_pool_layers_trace_the_jax_graph(name):
    build, _ = CONV_POOL[name]
    out = {}
    for package in (mx, tmx):
        scope = tmx.cpu() if package is tmx else contextlib.nullcontext()
        with package.name.NameManager(), scope:
            block = build(package.gluon.nn, package)
            out[package] = block(package.sym.var("data"))
    assert out[tmx].list_arguments() == out[mx].list_arguments()
    assert out[tmx].tojson() == out[mx].tojson()


def test_transposed_conv_refuses_channels_last_as_jax():
    for package in (mx, tmx):
        scope = tmx.cpu() if package is tmx else contextlib.nullcontext()
        with package.gluon.nn.channels_last(), scope:
            with pytest.raises(ValueError, match="channel-last"):
                package.gluon.nn.Conv2DTranspose(4, 3)


def _summary(package, capsys):
    package.random.seed(0)
    scope = tmx.cpu() if package is tmx else contextlib.nullcontext()
    with package.name.NameManager(), scope:
        net = package.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(package.gluon.nn.Conv2D(4, 3, in_channels=3),
                    package.gluon.nn.BatchNorm(),
                    package.gluon.nn.Conv2DTranspose(2, 2, in_channels=4),
                    package.gluon.nn.Dense(5))
    net.initialize()
    net.summary()
    return capsys.readouterr().out


def test_block_summary_prints_the_jax_table(capsys):
    want = _summary(mx, capsys)
    got = _summary(tmx, capsys)
    assert "Total params" in want
    assert got == want


def test_list_data_grad_and_ctx():
    with tmx.cpu():
        net = tgluon.nn.Dense(3, in_units=4)
    net.initialize()
    x = tmx.nd.array(_x(2, 4), ctx=tmx.cpu())
    with tmx.autograd.record():
        loss = net(x).sum()
    loss.backward()
    for p in net.collect_params().values():
        data, grad, ctx = p.list_data(), p.list_grad(), p.list_ctx()
        assert len(data) == len(grad) == len(ctx) == 1
        assert data[0]._data is p._check_and_get()
        assert grad[0]._data is p._check_and_get().grad
        assert ctx == [torch.device("cpu")]
    jnet = jgluon.nn.Dense(3, in_units=4)
    jnet.initialize()
    jp = jnet.collect_params()[jnet.prefix + "weight"]
    assert len(jp.list_data()) == len(jp.list_grad()) == 1
    with tmx.cpu():
        deferred = tgluon.nn.Dense(3)
    deferred.initialize()
    w = deferred.collect_params()[deferred.prefix + "weight"]
    assert w.list_ctx() == [torch.device("cpu")]
    bn = tgluon.nn.BatchNorm(in_channels=2, device="cpu")
    bn.initialize()
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        bn.collect_params()[bn.prefix + "running_mean"].list_grad()


def _constant_block(package, name):
    value = np.arange(6, dtype=np.float32).reshape(2, 3)

    class WithConstant(package.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.c = self.params.get_constant(name, value)
                self.dense = package.gluon.nn.Dense(3, in_units=3)

        def hybrid_forward(self, F, x, c):
            return self.dense(x) + c

    scope = tmx.cpu() if package is tmx else contextlib.nullcontext()
    with package.name.NameManager(), scope:
        return WithConstant(prefix="b_"), value


def test_constant_is_set_kept_and_traced_as_jax():
    out = {}
    for package in (mx, tmx):
        block, value = _constant_block(package, "const_weight")
        package.random.seed(1)
        block.initialize()
        const = block.collect_params()["b_const_weight"]
        assert const.grad_req == "null"
        assert const is block.params.get_constant("const_weight")
        trainer = package.gluon.Trainer(block.collect_params(), "sgd",
                                        {"learning_rate": 1.0})
        x = package.nd.array(_x(2, 3), ctx=package.cpu())
        with package.autograd.record():
            y = block(x)
            loss = (y * y).sum()
        loss.backward()
        trainer.step(1)
        np.testing.assert_array_equal(const.data().asnumpy(), value)
        out[package] = (y.asnumpy(), block(package.sym.var("data")).tojson())
    np.testing.assert_allclose(out[tmx][0], out[mx][0], **TOL)
    assert out[tmx][1] == out[mx][1]


def test_constant_named_without_a_weight_suffix_initializes():
    """A deliberate divergence: the JAX Constant's initializer keeps the
    base class's _init_default, which raises for a name that is not a
    weight; the port's copies the value, as MXNet's Constant does."""
    block, value = _constant_block(mx, "const")
    with pytest.raises(NotImplementedError):
        block.initialize()
    block, value = _constant_block(tmx, "const")
    block.initialize()
    np.testing.assert_array_equal(
        block.collect_params()["b_const"].data().asnumpy(), value)
