"""mxnet_tpu_torch.mod.Module on the CPU, held to the JAX package's Module.

The single-device tests of tests/test_module.py (bind and forward, fit
convergence, checkpoints, predict, LeNet), each run through both packages
from the same ``mx.random.seed``: the same Xavier weights, the same shuffled
batches, and parameters after the fit steps within tests/
test_module.py's own bound for two trajectories of one SGD run
(``rtol=2e-4, atol=2e-5``, its multi-device test).  Checkpoints cross
packages: a ``Module.save_checkpoint`` of either loads in the other
(``Module.load``) and predicts the same.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx

# tests/test_module.py::test_module_multi_device_training_matches_single
RTOL, ATOL = 2e-4, 2e-5
# tests/test_module.py's assert_almost_equal bound for one set of weights
PREDICT_RTOL = 1e-5


def _mlp(pkg):
    sym = pkg.sym
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data, name="fc1", num_hidden=32)
    act1 = sym.Activation(fc1, name="relu1", act_type="relu")
    fc2 = sym.FullyConnected(act1, name="fc2", num_hidden=10)
    return sym.SoftmaxOutput(fc2, name="softmax")


def _lenet(pkg):
    sym = pkg.sym
    data = sym.Variable("data")
    conv1 = sym.Convolution(data, name="conv1", kernel=(3, 3), num_filter=8)
    act1 = sym.Activation(conv1, act_type="relu")
    pool1 = sym.Pooling(act1, kernel=(2, 2), stride=(2, 2), pool_type="max")
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, name="fc1", num_hidden=10)
    return sym.SoftmaxOutput(fc1, name="softmax")


def _blobs(n=256, seed=0):
    """tests/test_module.py's linearly separable blobs."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-3, 3, (10, 16))
    labels = rng.randint(0, 10, n)
    data = centers[labels] + rng.normal(0, 0.3, (n, 16))
    return data.astype(np.float32), labels.astype(np.float32)


def _ctx(pkg):
    return pkg.cpu()


def _iter(pkg, data, labels, batch_size, shuffle=False):
    kw = {"ctx": tmx.cpu()} if pkg is tmx else {}
    return pkg.io.NDArrayIter(data, labels, batch_size=batch_size,
                              shuffle=shuffle, **kw)


def _params(mod):
    args, auxs = mod.get_params()
    return {k: v.asnumpy() for k, v in list(args.items())
            + list(auxs.items())}


def _fit(pkg, make, data, labels, epochs, seed, lr, batch_size, **kw):
    pkg.random.seed(seed)
    with pkg.name.NameManager():
        net = make(pkg)
    it = _iter(pkg, data, labels, batch_size, shuffle=True)
    mod = pkg.mod.Module(net, context=_ctx(pkg))
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": lr}, eval_metric="acc",
            initializer=pkg.init.Xavier(), **kw)
    it.reset()
    return mod, it


def test_module_bind_forward_matches_the_jax_module():
    x = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    outs = []
    for pkg in (mx, tmx):
        pkg.random.seed(3)
        with pkg.name.NameManager():
            net = _mlp(pkg)
        mod = pkg.mod.Module(net, context=_ctx(pkg))
        mod.bind(data_shapes=[("data", (8, 16))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params(initializer=pkg.init.Xavier())
        batch = pkg.io.DataBatch(
            data=[pkg.nd.array(x, ctx=_ctx(pkg))],
            label=[pkg.nd.zeros((8,), ctx=_ctx(pkg))])
        mod.forward(batch, is_train=False)
        outs.append((mod.get_outputs()[0].asnumpy(), _params(mod)))
    (jout, jparams), (out, params) = outs
    assert out.shape == (8, 10)
    for name in jparams:
        assert np.array_equal(params[name], jparams[name]), name
    np.testing.assert_allclose(out.sum(axis=1), np.ones(8), rtol=1e-4)
    np.testing.assert_allclose(out, jout, rtol=PREDICT_RTOL, atol=1e-7)


@pytest.mark.parametrize("compiled", [False, True],
                         ids=["eager", "compiled"])
def test_module_fit_converges_on_the_jax_trajectory(compiled):
    data, labels = _blobs(512)
    jmod, _ = _fit(mx, _mlp, data, labels, 2, 11, 0.1, 32,
                   compiled=compiled)
    mod, it = _fit(tmx, _mlp, data, labels, 2, 11, 0.1, 32,
                   compiled=compiled)
    assert (mod._compiled_step is not None) == compiled
    want, got = _params(jmod), _params(mod)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert mod.score(it, "acc")[0][1] > 0.9


def test_module_checkpoints_load_across_packages(tmp_path):
    data, labels = _blobs(64)
    x = data[:16]
    preds = {}
    for src, dst in ((tmx, mx), (mx, tmx)):
        it = _iter(src, data, labels, 16)
        src.random.seed(5)
        with src.name.NameManager():
            mod = src.mod.Module(_mlp(src), context=_ctx(src))
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(initializer=src.init.Xavier())
        mod.init_optimizer()
        prefix = str(tmp_path / src.__name__)
        mod.save_checkpoint(prefix, 1)
        loaded = dst.mod.Module.load(prefix, 1, context=_ctx(dst))
        dst_it = _iter(dst, data, labels, 16)
        loaded.bind(data_shapes=dst_it.provide_data,
                    label_shapes=dst_it.provide_label, for_training=False)
        for m, pkg in ((mod, src), (loaded, dst)):
            m.forward(pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=_ctx(pkg))],
                                       label=None), is_train=False)
        preds[src.__name__] = (mod.get_outputs()[0].asnumpy(),
                               loaded.get_outputs()[0].asnumpy())
        assert sorted(_params(loaded)) == sorted(_params(mod))
    for ref, got in preds.values():
        np.testing.assert_allclose(got, ref, rtol=PREDICT_RTOL, atol=1e-7)


def test_module_predict_matches_the_jax_module():
    data, labels = _blobs(64)
    outs = []
    for pkg in (mx, tmx):
        it = _iter(pkg, data, labels, 16)
        pkg.random.seed(7)
        with pkg.name.NameManager():
            mod = pkg.mod.Module(_mlp(pkg), context=_ctx(pkg))
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(initializer=pkg.init.Xavier())
        outs.append(mod.predict(it).asnumpy())
    assert outs[1].shape == (64, 10)
    np.testing.assert_allclose(outs[1], outs[0], rtol=PREDICT_RTOL,
                               atol=1e-7)


def test_module_lenet_conv_fit_matches_the_jax_module():
    """tests/test_module.py's LeNet on image-shaped synthetic data: 2
    epochs of SGD at lr 0.05, both packages from one seed."""
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (64, 1, 12, 12)).astype(np.float32)
    Y = rng.randint(0, 10, 64).astype(np.float32)
    jmod, _ = _fit(mx, _lenet, X, Y, 2, 13, 0.05, 16)
    mod, _ = _fit(tmx, _lenet, X, Y, 2, 13, 0.05, 16)
    assert mod._compiled_step is not None
    want, got = _params(jmod), _params(mod)
    assert not np.allclose(got["fc1_weight"], 0)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
