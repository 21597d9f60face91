"""The LM's training step written in ``mx.nd`` ops, and Gluon's NDArray
boundary, against the JAX package and the port's Gluon path (CPU).

- ``models/transformer_lm_nd.train_step`` is one function of the package;
  it takes three Adam steps with ``mxnet_tpu`` and with
  ``mxnet_tpu_torch`` from the same seeded weights and batches, at vocab
  64, dim 64, 4 heads, depth 2, B = 2, T = 32.  Losses and the weights after three
  steps are held at tests/test_torch_training.py's LM bounds, the weights
  plus what Adam makes of each step's measured gradient gaps; the step-1
  gradients, taken at equal weights, at its 1e-6.  Later steps' gradients
  are taken at weights Adam has already put apart (up to 2.3e-5 after
  three steps at this size, where a gradient that cancels to ~0 meets
  Adam's 1/eps slope) and enter the weight bound instead.
- The nd forward equals the port's Gluon ``TransformerLM`` on the same
  weights, value and gradients (the check the chip run makes at full
  width).
- The port's LM and ``resnet18_v1`` called with NDArrays give what the
  same calls with tensors give, and ``loss.backward()`` on the NDArray
  loss reaches ``Trainer.step``.
"""
import numpy as np
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.models import transformer_lm_nd as lm_nd

from test_torch_training import (LM_ATOL, LM_GRAD_ATOL, initialized_lm,
                                 LM_LOSS_BOUND, LM_RTOL, _adam_gap_bound)

VOCAB, DIM, HEADS, DEPTH, B, T = 64, 64, 4, 2, 2, 32
LR = 3e-3
CPU = tmx.cpu()


def _weights(seed=7):
    """Xavier-uniform weights (zero biases, unit LayerNorm gains) drawn from
    a seeded RandomState, under the port's parameter names."""
    rng = np.random.RandomState(seed)
    net = initialized_lm(tlm.TransformerLM(VOCAB, DIM, HEADS, DEPTH, T,
                                           device="cpu"))
    out = {}
    for n, p in net.named_parameters():
        if n.endswith("gamma"):
            out[n] = np.ones(p.shape, np.float32)
        elif p.dim() == 1:
            out[n] = np.zeros(p.shape, np.float32)
        else:
            a = np.sqrt(6.0 / sum(p.shape))
            out[n] = rng.uniform(-a, a, p.shape).astype(np.float32)
    return out


def _batches(steps):
    rng = np.random.RandomState(0)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    return [tlm.pattern_batch(rng, B, T, VOCAB) + (pos,)
            for _ in range(steps)]


def _run(mx, weights, batches, ctx):
    params = {n: mx.nd.array(a, ctx=ctx) for n, a in weights.items()}
    for w in params.values():
        w.attach_grad()
    states = lm_nd.adam_states(mx, params)
    losses, grads = [], []
    for t, (x, y, pos) in enumerate(batches, start=1):
        loss = lm_nd.train_step(
            mx, params, states, t, mx.nd.array(x, ctx=ctx, dtype="int32"),
            mx.nd.array(y.astype(np.float32), ctx=ctx),
            mx.nd.array(pos, ctx=ctx, dtype="int32"), HEADS, LR)
        losses.append(float(loss.asnumpy()[0]))
        grads.append({n: w.grad.asnumpy() for n, w in params.items()})
    return losses, grads, {n: w.asnumpy() for n, w in params.items()}


def test_nd_lm_steps_match_jax():
    weights = _weights()
    batches = _batches(3)
    want_losses, want_grads, want = _run(jmx, weights, batches, jmx.cpu())
    got_losses, got_grads, got = _run(tmx, weights, batches, CPU)
    np.testing.assert_allclose(got_losses, want_losses, rtol=0,
                               atol=LM_LOSS_BOUND)
    gaps = {n: [] for n in weights}
    for step, (g_step, w_step) in enumerate(zip(got_grads, want_grads)):
        for n in weights:
            gap = np.abs(g_step[n].astype(np.float64) - w_step[n])
            if step == 0:   # the same weights: rounding alone
                assert gap.max() < LM_GRAD_ATOL, (n, gap.max())
            gaps[n].append(gap)
    for n in weights:
        bound = (LM_RTOL * np.abs(want[n]) + LM_ATOL + _adam_gap_bound(
            [g[n] for g in want_grads], gaps[n], LR))
        assert np.all(np.abs(got[n] - want[n]) <= bound), n


def _lm(seed=3):
    net = initialized_lm(tlm.TransformerLM(VOCAB, DIM, HEADS, DEPTH, T,
                                           device="cpu"))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    return net


def test_nd_forward_and_gradients_equal_the_gluon_lm():
    net = _lm()
    (x, y, pos), = _batches(1)
    params = {n: tmx.nd.array(p.detach(), ctx=CPU)
              for n, p in net.named_parameters()}
    for w in params.values():
        w.attach_grad()
    with autograd.record():
        nd_loss = lm_nd.loss(tmx.nd, lm_nd.forward(
            tmx.nd, params, tmx.nd.array(x, ctx=CPU),
            tmx.nd.array(pos, ctx=CPU), HEADS), tmx.nd.array(y, ctx=CPU))
    nd_loss.backward()
    with autograd.record():
        logits = net(torch.from_numpy(x), torch.from_numpy(pos))
        loss = SoftmaxCrossEntropyLoss()(
            logits.reshape(-1, VOCAB),
            torch.from_numpy(y.astype(np.float32)).reshape(-1)).mean()
    loss.backward()
    np.testing.assert_allclose(nd_loss.asnumpy(), [loss.item()], rtol=1e-6)
    for n, p in net.named_parameters():
        np.testing.assert_allclose(params[n].grad.asnumpy(), p.grad.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def _train_round(net, x, y, pos, wrap):
    """One recorded forward and loss, backward and ``Trainer.step``, with
    the inputs as NDArrays (``wrap``) or tensors."""
    trainer = gluon.Trainer(net.named_parameters(), "sgd",
                            {"learning_rate": 0.1})
    ce = SoftmaxCrossEntropyLoss()
    args = [tmx.nd.array(a, ctx=CPU) if wrap else torch.from_numpy(a)
            for a in (x, y) + ((pos,) if pos is not None else ())]
    with autograd.record():
        out = net(args[0], *args[2:])
        loss = ce(out.reshape((-1, out.shape[-1])) if wrap
                  else out.reshape(-1, out.shape[-1]), args[1].reshape(
                      (-1,)) if wrap else args[1].reshape(-1))
    if wrap:
        assert isinstance(out, tmx.nd.NDArray)
        assert isinstance(loss, tmx.nd.NDArray)
        loss.backward()
    else:
        loss.backward(torch.ones_like(loss))
    trainer.step(x.shape[0])
    return (out.asnumpy() if wrap else out.detach().numpy(),
            {n: p.detach().clone() for n, p in net.named_parameters()})


def test_gluon_lm_takes_ndarrays_and_trains_through_the_trainer():
    (x, y, pos), = _batches(1)
    y = y.astype(np.float32)
    runs = [_train_round(_lm(), x, y, pos, wrap) for wrap in (True, False)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    start = dict(_lm().named_parameters())
    for n, w in runs[1][1].items():
        assert torch.equal(runs[0][1][n], w), n
        assert not torch.equal(w, start[n].detach()), n


def test_resnet18_takes_ndarrays_as_it_takes_tensors():
    def net():
        torch.manual_seed(0)
        model = vision.resnet18_v1(classes=10, thumbnail=True, device="cpu")
        model.initialize()
        with torch.no_grad():
            model(torch.zeros(1, 3, 16, 16))   # fills the deferred shapes
        for p in model.parameters():
            torch.nn.init.normal_(p, 0.0, 0.1)
        return model
    rng = np.random.RandomState(2)
    x = rng.normal(0, 1, (2, 3, 16, 16)).astype(np.float32)
    y = np.array([1, 7], np.float32)
    with autograd.predict_mode():
        got = net()(tmx.nd.array(x, ctx=CPU))
        want = net()(torch.from_numpy(x))
    assert isinstance(got, tmx.nd.NDArray) and got.shape == (2, 10)
    np.testing.assert_array_equal(got.asnumpy(), want.detach().numpy())
    runs = [_train_round(net(), x, y, None, wrap) for wrap in (True, False)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    for n, w in runs[1][1].items():
        assert torch.equal(runs[0][1][n], w), n
