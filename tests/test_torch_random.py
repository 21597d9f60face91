"""mxnet_tpu_torch's random draws against the JAX package's.

- The threefry block function and ``split`` in torch integer ops equal the
  numpy ones (and so ``jax.random``'s), for host keys and for device-tensor
  keys; ``random_bits``, ``uniform``, ``bernoulli``, ``randint``,
  ``permutation`` and ``categorical`` equal ``jax.random``'s bit for bit;
  ``normal`` is within ``NORMAL_RTOL`` (2 ulp measured: XLA's ``log1p``
  is not torch's) and ``exponential`` within ``EXP_RTOL`` (1 ulp measured).
- Every ported ``nd.random`` sampler draws what the JAX package's draws
  from one ``mx.random.seed``, and the rejection samplers raise.
- ``Dropout`` masks are the JAX package's bit for bit from one seed: eager
  (one key a call), hybridized (one key a call, split inside the graph),
  ``functional_call(rng_key=)`` (host words or a device-tensor key) and
  ``mode='always'``, with ``axes``, at p = 0.1 and 0.5; the gradient is
  the mask.

Each test seeds both packages itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.block import functional_call as jax_functional_call
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.block import functional_call
from mxnet_tpu_torch.ops import random_ops

NORMAL_RTOL = 2.0 ** -21    # 4 ulp
EXP_RTOL = 2.0 ** -22       # 2 ulp
SEEDS = (0, 42)


def _seed(seed):
    mx.random.seed(seed)
    tmx.random.seed(seed)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


# ---------------------------------------------------------------- the bits

@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
def test_torch_threefry_and_split_equal_numpy(seed):
    key = trandom.prng_key(seed)
    rng = np.random.RandomState(seed % 1000)
    x0 = rng.randint(0, 2 ** 32, 257, dtype=np.uint64).astype(np.uint32)
    x1 = rng.randint(0, 2 ** 32, 257, dtype=np.uint64).astype(np.uint32)
    want = trandom.threefry2x32(key, x0, x1)
    t0, t1 = (torch.from_numpy(a.view(np.int32).copy()) for a in (x0, x1))
    for k in (key, trandom.key_tensor(key, "cpu")):
        got = trandom.threefry2x32(k, t0.clone(), t1.clone())
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy().view(np.uint32), w)
    for num in (2, 5):
        host = trandom.split(key, num)
        dev = trandom.split(trandom.key_tensor(key, "cpu"), num)
        assert np.array_equal(dev.numpy().view(np.uint32), host)
        assert np.array_equal(host, _words(jax.random.split(_jkey(seed),
                                                            num)))


def test_next_key_under_a_tensor_override_equals_the_host_chain():
    base = trandom.prng_key(9)
    with trandom.key_override(base):
        host = [trandom.next_key() for _ in range(4)]
    with trandom.key_override(trandom.key_tensor(base, "cpu")):
        dev = [trandom.next_key() for _ in range(4)]
    for h, d in zip(host, dev):   # a device key is made when read
        assert np.array_equal(
            trandom.key_tensor(d, "cpu").numpy().view(np.uint32), h)


SHAPES = [(7,), (2, 3, 4), (4099,)]


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_and_bernoulli_equal_jax_random(seed):
    key = trandom.prng_key(seed)
    for shape in SHAPES:
        got = trandom.random_bits(key, shape, "cpu").numpy().view(np.uint32)
        want = np.asarray(jax.random.bits(_jkey(seed), shape, jnp.uint32))
        assert np.array_equal(got, want), shape
        for lo, hi in ((0.0, 1.0), (-3.0, 2.5), (0.125, 0.334)):
            got = random_ops.uniform(key, shape, minval=lo, maxval=hi,
                                     device="cpu").numpy()
            want = np.asarray(jax.random.uniform(_jkey(seed), shape,
                                                 minval=lo, maxval=hi))
            assert np.array_equal(got, want), (shape, lo, hi)
        for p in (0.1, 0.9):
            got = random_ops.bernoulli(key, p, shape, "cpu").numpy()
            want = np.asarray(jax.random.bernoulli(_jkey(seed), p, shape))
            assert np.array_equal(got, want), (shape, p)


@pytest.mark.parametrize("seed", SEEDS)
def test_half_precision_uniform_equals_jax_random(seed):
    key = trandom.prng_key(seed)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float16, jnp.float16)):
        got = random_ops.uniform(key, (4099,), dt, device="cpu")
        want = jax.random.uniform(_jkey(seed), (4099,), dtype=jdt)
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_permutation_and_categorical_equal_jax_random(seed):
    key = trandom.prng_key(seed)
    for lo, hi in ((0, 10), (-5, 1000), (0, 2 ** 31 - 1),
                   (-2 ** 31, 2 ** 31 - 1), (3, 3)):
        got = random_ops.randint(key, (513,), lo, hi, device="cpu").numpy()
        want = np.asarray(jax.random.randint(_jkey(seed), (513,), lo, hi))
        assert np.array_equal(got, want), (lo, hi)
    for n in (1, 10, 1000, 70000):
        got = random_ops.permutation(key, torch.arange(n)).numpy()
        want = np.asarray(jax.random.permutation(_jkey(seed), jnp.arange(n)))
        assert np.array_equal(got, want), n
    x = np.arange(24).reshape(6, 4)
    got = random_ops.permutation(key, torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jax.random.permutation(
        _jkey(seed), jnp.asarray(x))))
    logits = np.log(np.random.RandomState(seed).dirichlet(
        np.ones(6), size=3)).astype(np.float32)
    got = random_ops.categorical(key, torch.from_numpy(logits)[:, None, :],
                                 (3, 300)).numpy()
    want = np.asarray(jax.random.categorical(
        _jkey(seed), jnp.asarray(logits)[:, None, :], axis=-1,
        shape=(3, 300)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_and_exponential_within_their_ulp_bounds(seed):
    key = trandom.prng_key(seed)
    shape = (200000,)
    got = random_ops.normal(key, shape, device="cpu").numpy()
    want = np.asarray(jax.random.normal(_jkey(seed), shape))
    np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=0)
    got = random_ops.exponential(key, shape, device="cpu").numpy()
    want = np.asarray(jax.random.exponential(_jkey(seed), shape))
    np.testing.assert_allclose(got, want, rtol=EXP_RTOL, atol=0)


# ------------------------------------------------------------ nd.random

def _nd_pair(fn_port, fn_jax, seed=5):
    _seed(seed)
    with tmx.cpu():
        got = fn_port(tmx)
    want = fn_jax(mx)
    return got, want


def _np(x):
    return [v.asnumpy() for v in x] if isinstance(x, (list, tuple)) \
        else x.asnumpy()


SAMPLERS = {
    "uniform": (lambda m: m.nd.random.uniform(-2, 3, shape=(4, 5)), 0),
    "uniform_mx": (lambda m: m.random.uniform(0, 1, shape=(9,)), 0),
    "randint": (lambda m: m.nd.random.randint(-7, 50, shape=(3, 4)), 0),
    "normal": (lambda m: m.nd.random.normal(1.5, 2.0, shape=(64,)),
               NORMAL_RTOL),
    "randn": (lambda m: m.nd.random.randn(3, 4), NORMAL_RTOL),
    "exponential": (lambda m: m.nd.random.exponential(2.0, shape=(64,)),
                    EXP_RTOL),
    "sample_uniform": (lambda m: m.nd.random.uniform(
        m.nd.array(np.array([0.0, -1.0], np.float32)),
        m.nd.array(np.array([1.0, 4.0], np.float32)), shape=(3,)), 1e-6),
    "sample_normal": (lambda m: m.nd.random.normal(
        m.nd.array(np.array([0.0, 2.0], np.float32)),
        m.nd.array(np.array([1.0, 0.5], np.float32)), shape=(5,)),
        NORMAL_RTOL),
    "sample_exponential": (lambda m: m.nd.random.exponential(
        m.nd.array(np.array([1.0, 0.25], np.float32)), shape=(4,)),
        EXP_RTOL),
    "shuffle_1d": (lambda m: m.nd.random.shuffle(
        m.nd.array(np.arange(50, dtype=np.float32))), 0),
    "shuffle_2d": (lambda m: m.nd.random.shuffle(
        m.nd.array(np.arange(30, dtype=np.float32).reshape(10, 3))), 0),
    "multinomial": (lambda m: m.nd.random.multinomial(
        m.nd.array(np.array([[0.1, 0.6, 0.3], [0.5, 0.25, 0.25]],
                            np.float32)), shape=(7,), get_prob=True),
        1e-6),
    "multinomial_1d": (lambda m: m.nd.random.multinomial(
        m.nd.array(np.array([0.2, 0.2, 0.6], np.float32)), shape=(4, 2)),
        0),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_nd_random_samplers_draw_the_jax_values(name):
    fn, rtol = SAMPLERS[name]
    got, want = _nd_pair(fn, fn)
    got, want = _np(got), _np(want)
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if rtol:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-7)
        else:
            assert np.array_equal(g, w), name
    # the key after the draw is the JAX package's too
    assert np.array_equal(tmx.random.next_key(), _words(mx.random.next_key()))


def test_rejection_samplers_raise_naming_themselves():
    for call, name in ((lambda: tmx.nd.random.gamma(shape=(2,), ctx="cpu"),
                        "_random_gamma"),
                       (lambda: tmx.nd.random.negative_binomial(
                           shape=(2,), ctx="cpu"),
                        "_random_negative_binomial")):
        with pytest.raises(MXNetError, match=name):
            call()


# ---------------------------------------------------------------- Dropout

def _ones(package, shape):
    if package is mx:
        return mx.nd.ones(shape)
    return tmx.nd.ones(shape, ctx=tmx.cpu())


DROPOUT = [(0.1, ()), (0.5, ()), (0.5, (1,)), (0.1, (0, 2))]


@pytest.mark.parametrize("p,axes", DROPOUT)
def test_eager_dropout_masks_and_gradients_are_the_jax_ones(p, axes):
    shape = (4, 6, 5)
    outs = {}
    for package, nn in ((mx, jnn), (tmx, tnn)):
        package.random.seed(11)
        layer = nn.Dropout(p, axes=axes)
        got = []
        for _ in range(3):
            x = _ones(package, shape)
            x.attach_grad()
            with package.autograd.record():
                y = layer(x)
            y.backward()
            got.append((y.asnumpy(), x.grad.asnumpy()))
        with package.autograd.predict_mode():
            got.append((layer(_ones(package, shape)).asnumpy(), None))
        got.append((package.random.next_key(), None))
        outs[package] = got
    for (g, gg), (w, wg) in zip(outs[tmx][:-1], outs[mx][:-1]):
        assert np.array_equal(g, w)
        if wg is not None:
            assert np.array_equal(gg, wg) and np.array_equal(gg, g)
    assert np.array_equal(outs[tmx][-1][0], _words(outs[mx][-1][0]))


@pytest.mark.parametrize("p,axes", DROPOUT[1:3])
def test_hybridized_dropout_masks_are_the_jax_cached_ops(p, axes):
    shape = (3, 8, 4)
    outs = {}
    for package, nn in ((mx, jnn), (tmx, tnn)):
        package.random.seed(4)
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dropout(p, axes=axes))
            net.add(nn.Dropout(p))
        net.hybridize()
        with package.autograd.train_mode():
            outs[package] = [net(_ones(package, shape)).asnumpy()
                             for _ in range(3)]
    for g, w in zip(outs[tmx], outs[mx]):
        assert np.array_equal(g, w)
    assert not np.array_equal(outs[tmx][0], outs[tmx][1])


def test_functional_call_dropout_takes_host_and_tensor_keys():
    x = np.ones((4, 10), np.float32)
    for p in (0.1, 0.5):
        tlayer, jlayer = tnn.Dropout(p), jnn.Dropout(p)
        for seed in (0, 3):
            want = jax_functional_call(jlayer, {}, jnp.asarray(x),
                                       training=True,
                                       rng_key=_jkey(seed))[0][0]
            host = trandom.prng_key(seed)
            for key in (host, trandom.key_tensor(host, "cpu")):
                got = functional_call(tlayer, {}, torch.from_numpy(x),
                                      training=True, rng_key=key)[0][0]
                assert np.array_equal(got.numpy(), np.asarray(want))


def test_device_keys_split_lazily_to_the_host_chains_keys():
    """A tensor key scopes a hybridized block's nested draws (the card's
    path: keys split in torch ops, made only when a draw reads them) as a
    host key does."""
    with tmx.cpu():
        net = tnn.HybridSequential()
        with net.name_scope():
            net.add(tnn.Dense(6, in_units=5))
            net.add(tnn.Dropout(0.5))
            net.add(tnn.Dense(4, in_units=6))
            net.add(tnn.Dropout(0.5, axes=(1,)))
    net.initialize()
    net.hybridize()
    params = {n: p.data()._data for n, p in net.collect_params().items()}
    x = torch.ones(3, 5)
    host = trandom.prng_key(6)
    outs = [functional_call(net, params, x, training=True, rng_key=key)
            [0][0] for key in (host, trandom.key_tensor(host, "cpu"))]
    assert torch.equal(outs[0], outs[1])
    assert (outs[0] == 0).any()


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_mode_always_draws_outside_training(p):
    x = np.random.RandomState(2).uniform(-1, 1, (5, 7)).astype(np.float32)
    _seed(8)
    got = tmx.nd.Dropout(tmx.nd.array(x, ctx=tmx.cpu()), p=p,
                         mode="always").asnumpy()
    want = mx.nd.Dropout(mx.nd.array(x), p=p, mode="always").asnumpy()
    assert np.array_equal(got, want)
    assert (got == 0).any()
    # the default mode is the identity in prediction, and draws all the same
    _seed(8)
    got = tmx.nd.Dropout(tmx.nd.array(x, ctx=tmx.cpu()), p=p).asnumpy()
    want = mx.nd.Dropout(mx.nd.array(x), p=p).asnumpy()
    assert np.array_equal(got, x) and np.array_equal(want, x)
    assert np.array_equal(tmx.random.next_key(), _words(mx.random.next_key()))
