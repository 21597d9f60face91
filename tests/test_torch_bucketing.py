"""mxnet_tpu_torch's ``BucketingModule``, ``SequentialModule`` and
``PythonLossModule`` and ``models/lstm_bucketing.py`` against mxnet_tpu
and ``example/rnn/lstm_bucketing.py`` on the CPU.

From the same weights (the JAX module's, carried by
``convert.ndarrays_from_numpy``) and the same batches, both packages'
modules train a few steps over mixed buckets: outputs and parameters agree
to ``tests/test_rnn.py``'s rtol 1e-4 / atol 1e-5.
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import lstm_bucketing as tlb

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "example", "rnn"))
import lstm_bucketing as jlb  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)       # tests/test_rnn.py:129
WIDTHS = dict(num_hidden=8, num_layers=2, num_embed=6, vocab_size=12)
BUCKETS = [3, 5, 7]
BATCH = 4


def _params(mod):
    args, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}, \
        {k: v.asnumpy() for k, v in aux.items()}


def _jax_bucketing(fused, batches_per_bucket=2):
    jmx.random.seed(3)
    with jmx.name.NameManager():
        mod = jmx.mod.BucketingModule(
            jlb.sym_gen_factory(fused=fused, **WIDTHS),
            default_bucket_key=max(BUCKETS), context=jmx.cpu())
    it = jlb.BucketSeqIter(BUCKETS, BATCH, WIDTHS["vocab_size"],
                           batches_per_bucket=batches_per_bucket, seed=1)
    return mod, it


def _port_bucketing(fused, batches_per_bucket=2):
    with tmx.name.NameManager():
        mod = tmx.mod.BucketingModule(
            tlb.sym_gen_factory(fused=fused, **WIDTHS),
            default_bucket_key=max(BUCKETS), context=tmx.cpu())
    it = tlb.BucketSeqIter(BUCKETS, BATCH, WIDTHS["vocab_size"],
                           batches_per_bucket=batches_per_bucket, seed=1,
                           ctx=tmx.cpu())
    return mod, it


@pytest.mark.parametrize("fused", [True, False])
def test_bucketing_fit_matches_jax_from_the_same_weights(fused):
    """``fit`` with Adam over three buckets, a batch each, two epochs,
    from the JAX module's Xavier weights: one bound module a bucket, the
    perplexity after each batch and the final parameters agree."""
    jmod, jit = _jax_bucketing(fused, 1)
    jmod.bind(jit.provide_data, jit.provide_label)
    jmod.init_params(jmx.init.Xavier())
    start, _ = _params(jmod)
    kw = dict(num_epoch=2, optimizer="adam",
              optimizer_params={"learning_rate": 0.01})
    jmetric = jmx.metric.Perplexity(ignore_label=None)
    jppl, tppl = [], []
    jmod.fit(jit, eval_metric=jmetric, batch_end_callback=lambda p: jppl.append(
        p.eval_metric.get()[1]), force_init=True,
             arg_params={k: jmx.nd.array(v) for k, v in start.items()},
             aux_params={}, **kw)
    tmod, tit = _port_bucketing(fused, 1)
    tmod.fit(tit, eval_metric=tmx.metric.Perplexity(ignore_label=None),
             batch_end_callback=lambda p: tppl.append(
                 p.eval_metric.get()[1]),
             arg_params=convert.ndarrays_from_numpy(start, ctx=tmx.cpu()),
             aux_params={}, **kw)
    assert sorted(tmod._buckets) == sorted(jmod._buckets) == BUCKETS
    np.testing.assert_allclose(tppl, jppl, **TOL)
    (want, _), (got, _) = _params(jmod), _params(tmod)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    assert all(m._optimizer is tmod._curr_module._optimizer
               for m in tmod._buckets.values())


def test_bucketing_steps_share_parameters_across_buckets():
    """Hand-driven forward/backward/update over mixed buckets, SGD: after
    each update every bound bucket holds the same parameters, and the
    outputs agree with the JAX module's step by step."""
    mods = []
    for build, package in ((_jax_bucketing, jmx), (_port_bucketing, tmx)):
        mod, it = build(True)
        mod.bind(it.provide_data, it.provide_label)
        mods.append((package, mod, it))
    _, jmod, _ = mods[0]
    jmod.init_params(jmx.init.Xavier())
    start, _ = _params(jmod)
    tmod = mods[1][1]
    tmod.init_params(arg_params=convert.ndarrays_from_numpy(
        start, ctx=tmx.cpu()), aux_params={})
    outs = {}
    for package, mod, it in mods:
        mod.init_optimizer(optimizer="sgd", optimizer_params=(
            ("learning_rate", 0.5),))
        outs[package] = []
        for batch in it:
            mod.forward(batch, is_train=True)
            outs[package].append(mod.get_outputs()[0].asnumpy())
            mod.backward()
            mod.update()
    for g, w in zip(outs[tmx], outs[jmx]):
        np.testing.assert_allclose(g, w, **TOL)
    ref, _ = _params(tmod)
    for key, m in tmod._buckets.items():
        for k, v in m.get_params()[0].items():
            np.testing.assert_array_equal(v.asnumpy(), ref[k], err_msg=k)


def test_lstm_bucketing_main_trains_on_the_cpu(capsys):
    mod = tlb.main(["--device", "cpu", "--buckets", "4,6",
                    "--batches-per-bucket", "3", "--num-epochs", "2"])
    assert sorted(mod._buckets) == [4, 6]
    assert len(mod.epoch_perplexity) == 2
    assert np.isfinite(mod.epoch_perplexity).all()
    assert mod.epoch_perplexity[1] < mod.epoch_perplexity[0]
    assert "perplexity by epoch" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# SequentialModule and PythonLossModule

def _seq(package, head):
    sym = package.sym
    d = sym.Variable("data")
    body = sym.Activation(sym.FullyConnected(d, num_hidden=6, name="fc1"),
                          act_type="tanh")
    m1 = package.mod.Module(body, data_names=["data"], label_names=None,
                            context=package.cpu())
    seq = package.mod.SequentialModule()
    seq.add(m1)
    if head == "symbol":
        d2 = sym.Variable("data")
        out = sym.SoftmaxOutput(sym.FullyConnected(d2, num_hidden=3,
                                                   name="fc2"),
                                name="softmax")
        seq.add(package.mod.Module(out, data_names=["data"],
                                   context=package.cpu()),
                take_labels=True, auto_wiring=True)
    else:
        seq.add(package.mod.PythonLossModule(), take_labels=True,
                auto_wiring=True)
    return seq


@pytest.mark.parametrize("head", ["symbol", "python"])
def test_sequential_module_matches_jax(head):
    """Two modules chained (a symbolic or a PythonLossModule head): three
    SGD steps from the same weights, outputs and parameters."""
    rng = np.random.RandomState(5)
    X = rng.uniform(-1, 1, (4, 5)).astype(np.float32)
    Y = np.array([0, 2, 1, 2], np.float32)
    results = {}
    start = None
    for package in (jmx, tmx):
        with package.name.NameManager():
            seq = _seq(package, head)
        seq.bind(data_shapes=[("data", (4, 5))],
                 label_shapes=[("softmax_label", (4,))])
        if start is None:
            seq.init_params(jmx.init.Xavier())
            start = _params(seq)[0]
        else:
            seq.init_params(arg_params=convert.ndarrays_from_numpy(
                start, ctx=tmx.cpu()), aux_params={}, allow_missing=False)
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.1),))
        kw = {"ctx": tmx.cpu()} if package is tmx else {}
        batch = package.io.DataBatch(data=[package.nd.array(X, **kw)],
                                     label=[package.nd.array(Y, **kw)])
        outs = []
        for _ in range(3):
            seq.forward(batch, is_train=True)
            outs.append(seq.get_outputs()[0].asnumpy())
            seq.backward()
            seq.update()
        results[package] = (outs, _params(seq)[0])
    (jo, jp), (to, tp) = results[jmx], results[tmx]
    for g, w in zip(to, jo):
        np.testing.assert_allclose(g, w, **TOL)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], err_msg=k, **TOL)


@pytest.mark.parametrize("grad_func", [None, "custom"])
def test_python_loss_module_matches_jax(grad_func):
    rng = np.random.RandomState(6)
    scores = rng.uniform(-1, 1, (4, 3)).astype(np.float32)
    labels = np.array([0, 2, 1, 2], np.float32)
    got = {}
    for package in (jmx, tmx):
        kw = {"ctx": tmx.cpu()} if package is tmx else {}
        fn = None if grad_func is None else (lambda s, l: s * 2 + 7)
        m = package.mod.PythonLossModule(grad_func=fn)
        m.bind(data_shapes=[("data", (4, 3))],
               label_shapes=[("softmax_label", (4,))])
        m.init_params()
        m.forward(package.io.DataBatch(
            data=[package.nd.array(scores, **kw)],
            label=[package.nd.array(labels, **kw)]), is_train=True)
        out = m.get_outputs()[0].asnumpy()
        m.backward()
        got[package] = (out, m.get_input_grads()[0].asnumpy(),
                        m.output_shapes)
    np.testing.assert_array_equal(got[tmx][0], got[jmx][0])
    np.testing.assert_allclose(got[tmx][1], got[jmx][1], **TOL)
    assert got[tmx][2] == got[jmx][2]
