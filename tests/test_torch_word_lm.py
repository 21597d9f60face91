"""mxnet_tpu_torch's word-language-model Transformer
(``models/word_language_model.py``) against the example's
(``example/gluon/word_language_model.py``), with Dropout 0.1 in training.

At depth 2 and narrow widths, from one ``mx.random.seed``: the seeded
weights are the example's bit for bit; at each of two Adam steps the loss
agrees to ``LM_LOSS_BOUND`` and every gradient to ``LM_GRAD_ATOL``
(``tests/test_torch_training.py``'s LM bounds), eagerly and hybridized:
the Dropout masks, drawn in the two key schemes the JAX package uses
(one key an op eagerly, one key a call split per block when hybridized),
are the example's, so the losses agree as if there were no dropout.  The
example's ``main`` loop runs in the port.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models import word_language_model as twlm

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "example", "gluon"))
import word_language_model as jwlm  # noqa: E402

LM_LOSS_BOUND = 1e-4
LM_GRAD_ATOL = 1e-6
WIDTHS = dict(vocab=64, dim=32, heads=4, hidden=64, layers=2, max_len=32)
B, T = 4, 16


def _pair(seed):
    mx.random.seed(seed)
    tmx.random.seed(seed)
    with mx.name.NameManager():
        jnet = jwlm.TransformerLM(**WIDTHS)
    with tmx.name.NameManager():
        tnet = twlm.TransformerLM(device="cpu", **WIDTHS)
    jnet.initialize(mx.init.Xavier())
    tnet.initialize(tmx.init.Xavier())
    return jnet, tnet


def _step(package, net, x, y):
    nd = package.nd
    kw = {} if package is mx else {"ctx": tmx.cpu()}
    xs = nd.array(x, dtype="int32", **kw)
    ys = nd.array(y, **kw)
    loss_fn = package.gluon.loss.SoftmaxCrossEntropyLoss()
    with package.autograd.record():
        loss = loss_fn(net(xs), ys)
    loss.backward()
    grads = {k: p.grad().asnumpy()
             for k, p in net._collect_params_with_prefix().items()}
    return loss.asnumpy(), grads


@pytest.mark.parametrize("hybridize", [False, True])
def test_one_dropout_step_matches_the_example(hybridize):
    data, target = twlm.synthetic_data(WIDTHS["vocab"], T, n=2 * B)
    jnet, tnet = _pair(seed=3)
    # the first call fills the deferred shapes (and draws their weights)
    # in both; in prediction, so Dropout only takes its key
    jnet(mx.nd.array(data[:B], dtype="int32"))
    with torch.no_grad():
        tnet(torch.from_numpy(data[:B].astype(np.int32)))
    for k, p in jnet._collect_params_with_prefix().items():
        assert np.array_equal(
            tnet._collect_params_with_prefix()[k].data().asnumpy(),
            p.data().asnumpy()), k
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    trainers = [package.gluon.Trainer(net.collect_params(), "adam",
                                      {"learning_rate": 3e-3})
                for package, net in ((mx, jnet), (tmx, tnet))]
    for i in range(2):   # two steps: the second's masks are fresh
        x, y = data[i * B:(i + 1) * B], target[i * B:(i + 1) * B]
        want, want_grads = _step(mx, jnet, x, y)
        got, got_grads = _step(tmx, tnet, x, y)
        for trainer in trainers:
            trainer.step(B)
        assert np.abs(got - want).max() < LM_LOSS_BOUND, i
        assert list(got_grads) == list(want_grads)
        for k, w in want_grads.items():
            gap = np.abs(got_grads[k].astype(np.float64) - w).max()
            assert gap < LM_GRAD_ATOL, (i, k, gap)
    assert np.array_equal(tmx.random.next_key(),
                          np.asarray(mx.random.next_key()).astype(np.uint32))


def test_dropout_is_active_in_training_and_off_in_prediction():
    _, tnet = _pair(seed=0)
    x = torch.from_numpy(np.arange(2 * T, dtype=np.int32).reshape(2, T) % 64)
    with torch.no_grad():
        a = tnet(x)
        b = tnet(x)
        assert torch.equal(a, b)
        with tmx.autograd.train_mode():
            c = tnet(x)
            d = tnet(x)
    assert not torch.equal(a, c) and not torch.equal(c, d)
    assert isinstance(SoftmaxCrossEntropyLoss()(c, x.float()), torch.Tensor)


def test_main_runs_the_examples_loop(capsys):
    loss = twlm.main(["--device", "cpu", "--num-epochs", "1", "--dim", "32",
                      "--batch-size", "64"])
    assert np.isfinite(loss) and loss < np.log(64)
    assert "final loss" in capsys.readouterr().out
