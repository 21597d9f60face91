"""mxnet_tpu_torch's Gluon conv, pooling, activation, BatchNorm and Flatten
layers, and ``metric.Accuracy``, against the JAX package's.

The same seeded numpy inputs and weights go through both layers.  Bounds:
1e-5 on O(1) outputs of one fp32 layer (sums taken in another order;
observed ~1e-6), BatchNorm's running statistics at rtol 1e-5 / atol 1e-6.
A BatchNorm that folded torch's unbiased variance (a factor n/(n-1), 2.6%
at the 40 values a channel here) or torch's momentum (1 - m) fails them.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import autograd, metric
from mxnet_tpu_torch.gluon import nn

BOUND = 1e-5
BN_RTOL, BN_ATOL = 1e-5, 1e-6


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _copy_params(jblock, tblock):
    """Carry the JAX layer's arrays into the port's, in order."""
    with torch.no_grad():
        for jp, (name, tp) in zip(jblock.collect_params().values(),
                                  tblock.state_dict(keep_vars=True).items()):
            assert jp.name.endswith(name), (jp.name, name)
            tp.copy_(torch.tensor(jp.data().asnumpy()))


CONVS = [  # (class, channels, kernel, strides, padding, dilation, groups,
           #  layout, use_bias, input shape)
    ("Conv2D", 6, 3, 2, 1, 1, 1, "NCHW", True, (2, 4, 9, 8)),
    ("Conv2D", 6, 3, 2, 1, 1, 1, "NHWC", True, (2, 9, 8, 4)),
    ("Conv2D", 8, (3, 1), (1, 2), (2, 0), 2, 2, "NCHW", False, (2, 4, 9, 8)),
    ("Conv2D", 4, 1, 1, 0, 1, 1, "NHWC", False, (2, 5, 5, 6)),
    ("Conv2D", 6, 7, 2, 3, 1, 1, "NCHW", True, (1, 3, 16, 16)),
    ("Conv1D", 5, 3, 2, 1, 1, 1, "NCW", True, (2, 4, 11)),
    ("Conv1D", 5, 3, 1, 1, 1, 1, "NWC", True, (2, 11, 4)),
    ("Conv3D", 3, 2, 1, 1, 1, 1, "NCDHW", True, (1, 2, 4, 5, 3)),
    ("Conv3D", 3, 2, 2, 0, 1, 1, "NDHWC", False, (1, 4, 5, 3, 2)),
]


@pytest.mark.parametrize("cls,channels,kernel,strides,padding,dilation,"
                         "groups,layout,use_bias,shape", CONVS)
def test_conv_matches_jax(cls, channels, kernel, strides, padding, dilation,
                          groups, layout, use_bias, shape):
    in_channels = shape[1] if layout.startswith("NC") else shape[-1]
    kw = dict(strides=strides, padding=padding, dilation=dilation,
              groups=groups, layout=layout, use_bias=use_bias,
              in_channels=in_channels)
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, shape).astype(np.float32)
    jconv = getattr(mx.gluon.nn, cls)(channels, kernel, **kw)
    jconv.initialize(mx.init.Xavier())
    if use_bias:
        jconv.bias.set_data(mx.nd.array(rng.normal(0, 1, (channels,))))
    want = jconv(mx.nd.array(x)).asnumpy()
    tconv = getattr(nn, cls)(channels, kernel, device="cpu", **kw)
    assert tconv.weight.shape == jconv.weight.shape
    _copy_params(jconv, tconv)
    got = tconv(_t(x)).detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < BOUND


def test_conv_with_activation_and_without_in_channels():
    x = np.random.RandomState(1).normal(0, 1, (2, 3, 6, 6)).astype(
        np.float32)
    jconv = mx.gluon.nn.Conv2D(4, 3, padding=1, activation="relu",
                               in_channels=3)
    jconv.initialize(mx.init.Xavier())
    tconv = nn.Conv2D(4, 3, padding=1, activation="relu", in_channels=3,
                      device="cpu")
    _copy_params(jconv, tconv)
    got = tconv(_t(x)).detach().numpy()
    assert np.abs(got - jconv(mx.nd.array(x)).asnumpy()).max() < BOUND
    assert got.min() == 0.0
    with pytest.raises(ValueError, match="in_channels must be given"):
        nn.Conv2D(4, 3, device="cpu")


def test_channels_last_scope_sets_layout_and_batchnorm_axis():
    with nn.channels_last():
        conv = nn.Conv2D(4, 3, in_channels=2, device="cpu")
        pool = nn.MaxPool2D()
        bn = nn.BatchNorm(in_channels=4, device="cpu")
        explicit = nn.Conv2D(4, 3, in_channels=2, layout="NCHW",
                             device="cpu")
    assert conv.weight.shape == (4, 3, 3, 2)
    assert pool._layout == "NHWC" and bn._axis == -1
    assert explicit.weight.shape == (4, 2, 3, 3)
    assert nn.Conv2D(4, 3, in_channels=2, device="cpu").weight.shape \
        == (4, 2, 3, 3)


POOLS = [  # (class, kwargs, input shape NCHW)
    ("MaxPool2D", dict(pool_size=3, strides=2, padding=1), (2, 3, 9, 8)),
    ("MaxPool2D", dict(), (2, 3, 8, 8)),
    ("MaxPool2D", dict(pool_size=3, strides=2, ceil_mode=True),
     (2, 3, 8, 9)),
    ("MaxPool2D", dict(pool_size=2, strides=1, padding=(1, 0)),
     (1, 2, 5, 4)),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1), (2, 3, 9, 8)),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1,
                       count_include_pad=False), (2, 3, 9, 8)),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1, ceil_mode=True),
     (2, 3, 8, 9)),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1, ceil_mode=True,
                       count_include_pad=False), (2, 3, 8, 9)),
    ("AvgPool2D", dict(pool_size=2, strides=3, padding=(1, 0)),
     (1, 2, 7, 6)),
    ("GlobalAvgPool2D", dict(), (2, 5, 7, 6)),
    ("GlobalMaxPool2D", dict(), (2, 5, 7, 6)),
]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("cls,kwargs,shape", POOLS)
def test_pooling_matches_jax(cls, kwargs, shape, layout):
    x = np.random.RandomState(2).normal(0, 1, shape).astype(np.float32)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    want = getattr(mx.gluon.nn, cls)(layout=layout, **kwargs)(
        mx.nd.array(x)).asnumpy()
    got = getattr(nn, cls)(layout=layout, **kwargs)(_t(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < BOUND


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation_matches_jax(act):
    x = np.random.RandomState(3).normal(0, 3, (4, 7)).astype(np.float32)
    want = mx.gluon.nn.Activation(act)(mx.nd.array(x)).asnumpy()
    got = nn.Activation(act)(_t(x)).numpy()
    assert np.abs(got - want).max() < BOUND


def test_activation_rejects_unknown_type():
    with pytest.raises(ValueError, match="unknown act_type gelu"):
        nn.Activation("gelu")


def test_flatten_matches_jax():
    x = np.random.RandomState(4).normal(0, 1, (3, 2, 4, 5)).astype(
        np.float32)
    want = mx.gluon.nn.Flatten()(mx.nd.array(x)).asnumpy()
    got = nn.Flatten()(_t(x)).numpy()
    assert got.shape == want.shape == (3, 40)
    assert np.array_equal(got, want)


# ------------------------------------------------------------ BatchNorm

def _bn_pair(axis, C, rng, **kw):
    """The JAX BatchNorm with random gamma, beta and running statistics,
    and the port's with the same arrays."""
    jbn = mx.gluon.nn.BatchNorm(axis=axis, in_channels=C, **kw)
    jbn.initialize()
    for p in jbn.collect_params().values():
        low = 0.5 if p.name.endswith(("running_var", "gamma")) else -1.0
        p.set_data(mx.nd.array(rng.uniform(low, 1.5, (C,))))
    tbn = nn.BatchNorm(axis=axis, in_channels=C, device="cpu", **kw)
    _copy_params(jbn, tbn)
    return jbn, tbn


def _assert_stats_match(jbn, tbn):
    for name in ("running_mean", "running_var"):
        want = getattr(jbn, name).data().asnumpy()
        got = getattr(tbn, name).numpy()
        assert np.allclose(got, want, rtol=BN_RTOL, atol=BN_ATOL), (
            name, np.abs(got - want).max())


@pytest.mark.parametrize("axis,shape", [(1, (2, 3, 4, 5)), (-1, (2, 4, 5, 3))])
def test_batchnorm_training_matches_jax_over_two_recorded_calls(axis,
                                                                shape):
    """Batch statistics under record(); after each call the running
    statistics hold the fold of the biased batch variance at momentum
    0.9.  Gradients of x, gamma and beta agree too."""
    rng = np.random.RandomState(5)
    C = shape[axis]
    jbn, tbn = _bn_pair(axis, C, rng)
    for call in range(2):
        x = rng.normal(call, 2, shape).astype(np.float32)
        dy = rng.normal(0, 1, shape).astype(np.float32)
        jx = mx.nd.array(x)
        jx.attach_grad()
        with mx.autograd.record():
            jy = jbn(jx)
        jy.backward(mx.nd.array(dy))
        tx = _t(x, True)
        with autograd.record():
            ty = tbn(tx)
        ty.backward(_t(dy))
        assert np.abs(ty.detach().numpy() - jy.asnumpy()).max() < BOUND
        _assert_stats_match(jbn, tbn)
        assert np.abs(tx.grad.numpy() - jx.grad.asnumpy()).max() < BOUND
        for name in ("gamma", "beta"):
            want = getattr(jbn, name).grad().asnumpy()
            got = getattr(tbn, name).grad.numpy()
            assert np.abs(got - want).max() < 1e-4 * max(
                1.0, np.abs(want).max()), name
            getattr(tbn, name).grad = None


def test_batchnorm_folds_a_constant_channel_as_the_reference_does():
    """The reference folds ``1/invstd**2 - eps`` of the batch variance, not
    the variance itself: on a constant channel (variance 0) that is one
    bit of eps below zero, -9.09e-13, and on a channel whose variance is
    far below eps it keeps only multiples of eps's last bit (1.164e-10
    where the variance is 1.176e-10).  After 400 recorded calls the port's
    running statistics hold the same values at BN_RTOL, with no absolute
    slack: folding the variance itself leaves channel 1 1% away."""
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (4, 3, 5, 5)).astype(np.float32)
    x[:, 0] = 0.5
    x[:, 1] = 0.5 + 1e-5 * x[:, 1]
    jbn = mx.gluon.nn.BatchNorm(in_channels=3)
    jbn.initialize()
    tbn = nn.BatchNorm(in_channels=3, device="cpu")
    _copy_params(jbn, tbn)
    jx, tx = mx.nd.array(x), _t(x)
    for _ in range(400):
        with mx.autograd.record():
            jbn(jx)
        with autograd.record():
            tbn(tx)
    for name in ("running_mean", "running_var"):
        want = getattr(jbn, name).data().asnumpy()
        got = getattr(tbn, name).numpy()
        np.testing.assert_allclose(got, want, rtol=BN_RTOL, atol=0,
                                   err_msg=name)
    assert tbn.running_var[0] < 0 < tbn.running_var[1]


def test_batchnorm_inference_uses_running_stats_outside_record():
    rng = np.random.RandomState(6)
    jbn, tbn = _bn_pair(1, 3, rng)
    x = rng.normal(0, 2, (2, 3, 4, 5)).astype(np.float32)
    before = tbn.running_mean.clone(), tbn.running_var.clone()
    got = tbn(_t(x)).detach().numpy()
    assert np.abs(got - jbn(mx.nd.array(x)).asnumpy()).max() < BOUND
    assert torch.equal(before[0], tbn.running_mean)
    assert torch.equal(before[1], tbn.running_var)
    # train_mode without recording still takes batch statistics
    with autograd.train_mode():
        tbn(_t(x))
    assert not torch.equal(before[0], tbn.running_mean)


def test_batchnorm_use_global_stats_under_record():
    rng = np.random.RandomState(7)
    jbn, tbn = _bn_pair(1, 3, rng, use_global_stats=True)
    x = rng.normal(0, 2, (2, 3, 4, 5)).astype(np.float32)
    with mx.autograd.record():
        want = jbn(mx.nd.array(x)).asnumpy()
    with autograd.record():
        got = tbn(_t(x)).detach().numpy()
    assert np.abs(got - want).max() < BOUND
    _assert_stats_match(jbn, tbn)


def test_batchnorm_without_scale_or_center():
    """fix_gamma: gamma (set to non-ones here) is read as ones; gamma and
    beta stay parameters without gradients (grad_req='null')."""
    rng = np.random.RandomState(8)
    jbn, tbn = _bn_pair(1, 3, rng, scale=False, center=False)
    assert not tbn.gamma.requires_grad and not tbn.beta.requires_grad
    assert [n for n, _ in tbn.named_parameters()] == ["gamma", "beta"]
    x = rng.normal(0, 2, (2, 3, 4, 5)).astype(np.float32)
    with mx.autograd.record():
        want = jbn(mx.nd.array(x)).asnumpy()
    with autograd.record():
        got = tbn(_t(x)).detach().numpy()
    assert np.abs(got - want).max() < BOUND
    _assert_stats_match(jbn, tbn)
    scaled = nn.BatchNorm(in_channels=3, device="cpu")
    assert scaled.gamma.requires_grad and scaled.beta.requires_grad
    assert [n for n, _ in scaled.named_buffers()] == ["running_mean",
                                                       "running_var"]


# ------------------------------------------------------------- Accuracy

def test_accuracy_matches_jax_metric():
    rng = np.random.RandomState(9)
    jm, tm = mx.metric.Accuracy(), metric.Accuracy()
    assert np.isnan(tm.get()[1])
    for N in (6, 5):
        pred = rng.normal(0, 1, (N, 4)).astype(np.float32)
        label = rng.randint(0, 4, N).astype(np.float32) + 0.7  # truncates
        jm.update([mx.nd.array(label)], [mx.nd.array(pred)])
        tm.update([_t(label)], [_t(pred)])
        assert tm.get() == jm.get()
    decided = rng.randint(0, 4, 5).astype(np.float32)   # label-shaped
    jm.update([mx.nd.array(decided)], [mx.nd.array(decided[::-1].copy())])
    tm.update([_t(decided)], [_t(decided[::-1].copy())])
    assert tm.get() == jm.get() and tm.num_inst == 16
    tm.reset()
    assert tm.num_inst == 0 and tm.sum_metric == 0.0
    with pytest.raises(ValueError, match="does not match"):
        tm.update([_t(decided)], [])
