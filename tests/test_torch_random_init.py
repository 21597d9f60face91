"""mxnet_tpu_torch's seeded key, initializers and draw order against the
JAX package's.

- ``random.next_key()`` chains and ``split`` equal ``jax.random``'s words
  (threefry2x32 under ``jax_threefry_partitionable``, jax's default here),
  and ``derived_numpy_rng()`` gives the same numpy stream: bitwise.
- Every initializer fills the same ``InitDesc`` with the same values from
  the same seed: bitwise (both draw float64 numpy values, cast them to
  float32, and permute channel-last weights alike).
- Full-width ``resnet50_v1`` (NCHW and NHWC) and the bench-width
  TransformerLM (vocab 32768, dim 768, 12 layers, 12 heads), seeded,
  Xavier-initialized and called once on a tiny input (parameter shapes do
  not depend on the image size or the batch): every array bit-equal,
  keyed by ``_collect_params_with_prefix`` names.  This pins the order in
  which the two packages draw their keys.  The models build in threads
  at once (both layouts and both packages for one seed): each package
  keeps its key per thread, and each thread seeds its own.
- ``io.NDArrayIter``'s batch order, padding and reshuffle equal the JAX
  iterator's for every ``last_batch_handle``.

Each test seeds both packages itself (``tests/conftest.py`` seeds only the
JAX package).
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.models import transformer_lm as tlm

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "example", "gluon"))
from transformer_lm import TransformerLM as JaxLM  # noqa: E402
from test_torch_resnet import _two_threads  # noqa: E402,F401

SEEDS = (0, 7)
LAYOUTS = ("NCHW", "NHWC")
LM_WIDTHS = dict(dim=768, heads=12, depth=12, max_len=1024)
LM_VOCAB = 32768


def _words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_next_key_chains_equal_jax_random_split(seed):
    mx.random.seed(seed)
    tmx.random.seed(seed)
    for _ in range(10):
        assert np.array_equal(tmx.random.next_key(),
                              _words(mx.random.next_key()))
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(tmx.random.prng_key(seed), _words(key))
    for num in (2, 3, 5):
        assert np.array_equal(tmx.random.split(tmx.random.prng_key(seed),
                                               num),
                              _words(jax.random.split(key, num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_derived_numpy_rng_gives_the_jax_stream(seed):
    mx.random.seed(seed)
    tmx.random.seed(seed)
    for _ in range(3):
        want = mx.random.derived_numpy_rng().uniform(-1, 1, 64)
        got = tmx.random.derived_numpy_rng().uniform(-1, 1, 64)
        assert np.array_equal(got, want)
    base = np.array([3, 4], np.uint32)
    with mx.random.key_override(jax.random.wrap_key_data(base)
                                if hasattr(jax.random, "wrap_key_data")
                                else base), tmx.random.key_override(base):
        assert np.array_equal(tmx.random.next_key(),
                              _words(mx.random.next_key()))


def _initializers(init):
    return [
        ("zero", init.Zero(), "w_weight", (4, 5)),
        ("one", init.One(), "w_weight", (4, 5)),
        ("constant", init.Constant(0.25), "w_weight", (4, 5)),
        ("uniform", init.Uniform(0.3), "w_weight", (6, 7)),
        ("normal", init.Normal(0.2), "w_weight", (6, 7)),
        ("orthogonal", init.Orthogonal(), "w_weight", (6, 4)),
        ("orthogonal_normal", init.Orthogonal(rand_type="normal"),
         "w_weight", (4, 2, 3)),
        ("xavier", init.Xavier(), "w_weight", (8, 3, 3, 3)),
        ("xavier_gaussian_in", init.Xavier("gaussian", "in", 2), "w_weight",
         (8, 5)),
        ("xavier_out", init.Xavier(factor_type="out", magnitude=1.5),
         "w_weight", (8, 5, 2)),
        ("msraprelu", init.MSRAPrelu(), "w_weight", (8, 4, 3, 3)),
        ("bilinear", init.Bilinear(), "up_weight", (2, 1, 4, 4)),
        ("lstmbias", init.LSTMBias(2.0), "lstm_bias", (16,)),
        ("bias_gamma", init.Xavier(), "bn_gamma", (5,)),
        ("running_var", init.Uniform(), "bn_running_var", (5,)),
        ("mixed", init.Mixed([".*bias", ".*"],
                             [init.Zero(), init.Uniform(0.5)]),
         "w_weight", (3, 4)),
        ("load", init.Load({"arg:w_weight": np.full((2, 2), 3.0,
                                                    np.float32)}),
         "w_weight", (2, 2)),
        ("desc_attr", init.Uniform(), None, (3, 3)),
    ]


@pytest.mark.parametrize("case", range(len(_initializers(tmx.init))),
                         ids=[c[0] for c in _initializers(tmx.init)])
def test_every_initializer_fills_the_jax_values(case):
    seed = 11
    _, jinit, name, shape = _initializers(mx.init)[case]
    _, tinit, _, _ = _initializers(tmx.init)[case]
    if name is None:   # an InitDesc whose attribute names the initializer
        jdesc = mx.init.InitDesc("x_weight", {"__init__": mx.init.Normal(
            0.5).dumps()})
        tdesc = tmx.init.InitDesc("x_weight", {"__init__": tmx.init.Normal(
            0.5).dumps()})
    else:
        jdesc, tdesc = mx.init.InitDesc(name), tmx.init.InitDesc(name)
    mx.random.seed(seed)
    tmx.random.seed(seed)
    jarr = mx.nd.zeros(shape)
    tarr = tmx.nd.zeros(shape, ctx=tmx.cpu())
    jinit(jdesc, jarr)
    tinit(tdesc, tarr)
    assert tarr.dtype == jarr.dtype == np.float32
    np.testing.assert_array_equal(tarr.asnumpy(), jarr.asnumpy())


def test_create_registry_and_aliases():
    assert isinstance(tmx.init.create("zeros"), tmx.init.Zero)
    assert isinstance(tmx.init.create("Xavier", magnitude=2), tmx.init.Xavier)
    x = tmx.init.Xavier()
    assert tmx.init.create(x) is x
    assert tmx.init.Xavier(magnitude=2).dumps() \
        == mx.init.Xavier(magnitude=2).dumps()
    with pytest.raises(ValueError, match="Unknown initialization pattern"):
        tmx.init.Xavier()("w_foo", tmx.nd.zeros((2, 2), ctx=tmx.cpu()))


# ------------------------------------------------ full-width draw order

def _arrays(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _resnet_arrays(package, layout, seed):
    package.random.seed(seed)
    shape = (1, 3, 32, 32) if layout == "NCHW" else (1, 32, 32, 3)
    if package is mx:
        net = jvision.resnet50_v1(layout=layout)
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros(shape))
    else:
        net = tvision.resnet50_v1(layout=layout, device="cpu")
        net.initialize(tmx.init.Xavier())
        with torch.no_grad():
            net(torch.zeros(shape))
    return _arrays(net)


def _lm_arrays(package, seed):
    package.random.seed(seed)
    idx = np.zeros((1, 8), np.int32)
    pos = np.arange(8, dtype=np.int32)[None]
    if package is mx:
        net = JaxLM(LM_VOCAB, **LM_WIDTHS)
        net.initialize(mx.init.Xavier())
        net(mx.nd.array(idx, dtype="int32"), mx.nd.array(pos, dtype="int32"))
    else:
        net = tlm.TransformerLM(LM_VOCAB, device="cpu", **LM_WIDTHS)
        net.initialize(tmx.init.Xavier())
        with torch.no_grad():
            net(torch.from_numpy(idx), torch.from_numpy(pos))
    return _arrays(net)


def _port_and_jax(build, *args):
    """``build(package, *args)`` for the port and for the JAX package,
    each in a thread of its own (numpy's draws release the GIL)."""
    with ThreadPoolExecutor(2) as pool:
        got = pool.submit(build, tmx, *args)
        want = pool.submit(build, mx, *args)
        return got.result(), want.result()


def _assert_same(got, want, count):
    assert list(got) == list(want) and len(got) == count
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        assert np.array_equal(got[k], a), k


@pytest.fixture(scope="module")
def seeded_resnets():
    """``take(layout, seed)``: the port's and the JAX package's arrays.
    The first call for a seed builds both layouts in both packages in four
    threads at once; each pair is handed out once."""
    built = {}

    def take(layout, seed):
        if (layout, seed) not in built:
            with ThreadPoolExecutor(4) as pool:
                jobs = {(lay, pkg): pool.submit(_resnet_arrays, pkg, lay, seed)
                        for lay in LAYOUTS for pkg in (tmx, mx)}
                for lay in LAYOUTS:
                    built[lay, seed] = (jobs[lay, tmx].result(),
                                        jobs[lay, mx].result())
        return built.pop((layout, seed))

    yield take
    built.clear()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_seeded_resnet50_v1_has_the_jax_weights(layout, seed,
                                                seeded_resnets):
    _assert_same(*seeded_resnets(layout, seed), 299)


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_bench_width_lm_has_the_examples_weights(seed):
    _assert_same(*_port_and_jax(_lm_arrays, seed), 12 * 10 + 6)


# ------------------------------------------------------------ NDArrayIter

@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_ndarray_iter_yields_the_jax_batches(handle, shuffle):
    rng = np.random.RandomState(3)
    X = rng.uniform(-1, 1, (23, 2, 3)).astype(np.float32)
    Y = rng.randint(0, 5, 23).astype(np.float32)
    mx.random.seed(9)
    tmx.random.seed(9)
    jit = mx.io.NDArrayIter(X, Y, batch_size=5, shuffle=shuffle,
                            last_batch_handle=handle)
    tit = tmx.io.NDArrayIter(X, Y, batch_size=5, shuffle=shuffle,
                             last_batch_handle=handle, ctx=tmx.cpu())
    assert [tuple(d) for d in tit.provide_data] \
        == [tuple(d) for d in jit.provide_data]
    assert [tuple(d) for d in tit.provide_label] \
        == [tuple(d) for d in jit.provide_label]
    for _ in range(3):   # three epochs, each reshuffled by reset()
        jb, tb = list(jit), list(tit)
        assert len(tb) == len(jb) > 0
        for j, t in zip(jb, tb):
            assert t.pad == j.pad
            np.testing.assert_array_equal(t.data[0].asnumpy(),
                                          j.data[0].asnumpy())
            np.testing.assert_array_equal(t.label[0].asnumpy(),
                                          j.label[0].asnumpy())
        jit.reset()
        tit.reset()
