"""mxnet_tpu_torch training against the JAX package.

Same seeded numpy inputs and weights through both packages:

- flash attention's q/k/v gradients against ``jax.grad`` of the JAX
  entry (its ``custom_vjp`` backward is the reference's vjp), at
  tests/test_pallas.py's gradient bound, 1e-3;
- ``SoftmaxCrossEntropyLoss`` against the JAX Gluon loss at 1e-6 (fp32
  log-softmax of O(1) logits; observed agreement ~1e-7);
- ``Adam`` and ``SGD(momentum)`` against ``mx.optimizer.create`` over three
  steps, at rtol 1e-6 / atol 1e-7 (tests/test_multichip_topologies.py's
  Adam bound);
- the slice: the example's LM trained three Adam steps (default epsilon)
  by the JAX Trainer and by the port from the same weights and batches.
  Losses at 1e-4 (test_torch_transformer_lm.py's logits bound), each
  step's gradients at 1e-6, parameters at rtol 3e-5 / atol 3e-6
  (tests/test_compiled_fit.py's Adam bound) plus what Adam makes of the
  measured gradient gaps (see _adam_gap_bound);
- the Trainer's rules: ``grad_req='write'`` over two rounds, a frozen
  parameter, ``step(batch_size)`` rescaling, a step with no new backward,
  state files.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.pallas_ops import flash_attention as jax_flash
from mxnet_tpu_torch import MXNetError, autograd, gluon, lr_scheduler
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.convert import load_mxnet_params, mxnet_to_torch_name
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.ops import cuda_ops
from mxnet_tpu_torch.ops.cuda_ops import flash_attention

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "example", "gluon"))
from transformer_lm import TransformerLM as JaxLM  # noqa: E402
from transformer_lm import pattern_batch as jax_pattern_batch  # noqa: E402

GRAD_BOUND = 1e-3          # tests/test_pallas.py::test_flash_attention_grad
LOSS_BOUND = 1e-6
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
LM_LOSS_BOUND = 1e-4
LM_RTOL, LM_ATOL = 3e-5, 3e-6
# each package's fp32 LM gradients lie within 1e-6 of an fp64 gradient
# (test_lm_fp32_gradients_are_as_accurate_as_jax)
LM_GRAD_ATOL = 1e-6
VOCAB, DIM, HEADS, DEPTH, MAX_LEN = 16, 64, 4, 2, 64


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("B,H,T,Tk,D,causal", [(1, 1, 128, 128, 32, True),
                                                (1, 2, 100, 200, 32,
                                                 "bottom")])
def test_flash_attention_grads_match_jax(B, H, T, Tk, D, causal):
    rng = np.random.RandomState(1)
    q = rng.normal(0, 1, (B, H, T, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, H, Tk, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, H, Tk, D)).astype(np.float32)
    # jitted: one compile, not one per primitive of the eager reference
    ref = jax.jit(jax.grad(lambda a, b, c: jnp.sum(
        jax_flash(a, b, c, causal=causal) ** 2), argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    (flash_attention(tq, tk, tv, causal=causal) ** 2).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        assert got.shape == want.shape
        assert np.abs(got.numpy() - np.asarray(want)).max() < GRAD_BOUND


def test_flash_attention_grads_reach_the_projection_through_head_views():
    """The model hands the kernel strided views of one (B, T, 3C)
    projection; their gradients land in the projection's gradient."""
    B, T, Hh, Dk = 2, 24, 2, 16
    C = Hh * Dk
    x = np.random.RandomState(2).normal(0, 1, (B, T, 3 * C)).astype(
        np.float32)

    def loss(attn):
        qkv = _t(x, True)
        q, k, v = (t.view(B, T, Hh, Dk).transpose(1, 2)
                   for t in qkv.split(C, dim=-1))
        (attn(q, k, v) ** 2).sum().backward()
        return qkv.grad

    got = loss(lambda q, k, v: flash_attention(q, k, v, causal=True))
    want = loss(lambda q, k, v: cuda_ops._attention_reference(
        q, k, v, True, Dk ** -0.5))
    assert got.shape == (B, T, 3 * C)
    assert torch.equal(got, want)


def test_flash_attention_grad_only_for_inputs_that_need_it():
    q, k, v = (torch.randn(1, 1, 16, 16, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3))
    k.requires_grad_(True)
    flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is None and v.grad is None and k.grad.shape == k.shape


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("case", ["sparse", "dense", "weight",
                                  "sample_weight", "from_logits_axis1"])
def test_softmax_ce_matches_jax_loss(case):
    rng = np.random.RandomState(3)
    N, V = 6, 10
    pred = rng.normal(0, 2, (N, V)).astype(np.float32)
    label = rng.randint(0, V, N).astype(np.float32)
    kw, args = {}, [pred, label]
    if case == "dense":
        kw["sparse_label"] = False
        dense = rng.rand(N, V).astype(np.float32)
        args[1] = dense / dense.sum(-1, keepdims=True)
    elif case == "weight":
        kw["weight"] = 0.7
    elif case == "sample_weight":
        args.append(rng.rand(N, 1).astype(np.float32))
    elif case == "from_logits_axis1":
        # (N, V, 2) log-probabilities along axis 1, labels (N, 2)
        logp = rng.normal(0, 1, (N, V, 2)).astype(np.float32)
        logp -= np.log(np.exp(logp).sum(1, keepdims=True))
        args = [logp, rng.randint(0, V, (N, 2)).astype(np.float32)]
        kw.update(from_logits=True, axis=1)
    want = mx.gluon.loss.SoftmaxCrossEntropyLoss(**kw)(
        *[mx.nd.array(a) for a in args]).asnumpy()
    got = SoftmaxCrossEntropyLoss(**kw)(*[_t(a) for a in args]).numpy()
    assert got.shape == want.shape == (N,)
    assert np.abs(got - want).max() < LOSS_BOUND


def test_softmax_ce_rejects_a_non_numeric_weight():
    with pytest.raises(TypeError, match="number"):
        SoftmaxCrossEntropyLoss(weight=_t([1.0]))(_t([[0.0, 1.0]]),
                                                  _t([1.0]))


# ---------------------------------------------------------------- (c)

OPTIMIZERS = {
    "adam": {"learning_rate": 0.01, "wd": 0.1, "rescale_grad": 0.5,
             "clip_gradient": 0.3},
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.1,
            "rescale_grad": 0.5, "clip_gradient": 0.3},
}


def _run_optimizer(package, name, weights, grads, array, to_np):
    upd = package.get_updater(package.create(name, **OPTIMIZERS[name]))
    ws = [array(w) for w in weights]
    for step_grads in grads:
        for i, (w, g) in enumerate(zip(ws, step_grads)):
            upd(i, array(g), w)
    return [to_np(w) for w in ws]


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax_over_three_steps(name):
    rng = np.random.RandomState(4)
    weights = [rng.normal(0, 1, s).astype(np.float32) for s in ((5, 3), (7,))]
    # gradients of ~1 against clip 0.3 after rescale 0.5: most entries clip
    grads = [[rng.normal(0, 1, w.shape).astype(np.float32) for w in weights]
             for _ in range(3)]
    want = _run_optimizer(mx.optimizer, name, weights, grads, mx.nd.array,
                          lambda w: w.asnumpy())
    got = _run_optimizer(topt, name, weights, grads, torch.tensor,
                         lambda w: w.numpy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=OPT_RTOL, atol=OPT_ATOL)


def test_adam_clips_before_weight_decay_and_folds_bias_correction():
    """One Adam step by hand: clip(rescale * g) + wd * w, then MXNet's
    bias correction folded into lr, epsilon on the uncorrected sqrt(v).
    The JAX package clips before weight decay (MXNet 1.3 clips after); the
    port follows the JAX package."""
    w0 = np.array([1.0, -2.0, 0.5], np.float32)
    g0 = np.array([3.0, -0.1, 0.2], np.float32)
    p = OPTIMIZERS["adam"]
    w = torch.tensor(w0)
    topt.get_updater(topt.create("adam", **p))(0, torch.tensor(g0), w)
    g = np.clip(g0 * p["rescale_grad"], -p["clip_gradient"],
                p["clip_gradient"]) + p["wd"] * w0
    m, v = 0.1 * g, 0.001 * g * g
    lr = p["learning_rate"] * np.sqrt(1 - 0.999) / (1 - 0.9)
    np.testing.assert_allclose(w.numpy(), w0 - lr * m / (np.sqrt(v) + 1e-8),
                               rtol=OPT_RTOL, atol=OPT_ATOL)
    g_after = np.clip(g0 * p["rescale_grad"] + p["wd"] * w0,
                      -p["clip_gradient"], p["clip_gradient"])
    assert not np.allclose(g, g_after)


def test_lr_schedulers_match_jax():
    def make(mod):
        return [mod.FactorScheduler(step=3, factor=0.5, base_lr=0.1,
                                    warmup_steps=2),
                mod.MultiFactorScheduler(step=[2, 5], factor=0.3),
                mod.PolyScheduler(max_update=9, base_lr=0.2, pwr=2),
                mod.CosineScheduler(max_update=9, base_lr=0.2,
                                    warmup_steps=3, warmup_mode="constant")]
    for ours, theirs in zip(make(lr_scheduler), make(mx.lr_scheduler)):
        assert [ours(t) for t in range(12)] == [theirs(t) for t in range(12)]


def test_sgd_with_a_scheduler_and_multipliers_matches_jax():
    sched = {m: m.FactorScheduler(step=1, factor=0.5)
             for m in (lr_scheduler, mx.lr_scheduler)}
    rng = np.random.RandomState(5)
    w0 = rng.normal(0, 1, (4,)).astype(np.float32)
    gs = [rng.normal(0, 1, (4,)).astype(np.float32) for _ in range(3)]
    results = []
    for mod, sch, arr in ((topt, sched[lr_scheduler], torch.tensor),
                          (mx.optimizer, sched[mx.lr_scheduler],
                           mx.nd.array)):
        opt = mod.create("sgd", learning_rate=0.1, wd=0.05,
                         lr_scheduler=sch, param_idx2name={0: "fc_bias"})
        opt.set_lr_mult({"fc_bias": 2.0})
        upd, w = mod.get_updater(opt), arr(w0)
        for g in gs:
            upd(0, arr(g), w)
        results.append(np.asarray(w.numpy() if mod is topt
                                  else w.asnumpy()))
    np.testing.assert_allclose(*results, rtol=OPT_RTOL, atol=OPT_ATOL)


def test_multi_precision_is_not_ported_yet():
    """``multi_precision=True`` once raised here; it is ported now, and on
    fp32 weights it is the plain update, bit for bit
    (tests/test_torch_multi_precision.py holds it on bf16 weights)."""
    rng = np.random.RandomState(6)
    w0 = rng.normal(0, 1, (5, 3)).astype(np.float32)
    gs = [rng.normal(0, 1, w0.shape).astype(np.float32) for _ in range(3)]
    for name in sorted(OPTIMIZERS):
        results = []
        for mp in (False, True):
            upd = topt.get_updater(topt.create(name, multi_precision=mp,
                                               **OPTIMIZERS[name]))
            w = torch.tensor(w0)
            for g in gs:
                upd(0, torch.tensor(g), w)
            results.append(w)
        assert torch.equal(*results), name


# ---------------------------------------------------------------- (d)

def _lm_pair(seed=7):
    """The example's LM in the JAX package, Xavier from ``seed``, and the
    port's with its weights carried over."""
    mx.random.seed(seed)
    jnet = JaxLM(VOCAB, dim=DIM, heads=HEADS, depth=DEPTH, max_len=MAX_LEN)
    jnet.initialize(mx.init.Xavier())
    zeros = mx.nd.array(np.zeros((1, 4), np.int32), dtype="int32")
    jnet(zeros, zeros)   # finish deferred init
    tnet = load_mxnet_params(
        tlm.TransformerLM(VOCAB, dim=DIM, heads=HEADS, depth=DEPTH,
                          max_len=MAX_LEN, device="cpu"),
        {n: p.data().asnumpy() for n, p in jnet.collect_params().items()})
    return jnet, tnet


def initialized_lm(net, seed=0):
    """The port's LM ``net`` Xavier-initialized from ``tmx.random.seed(seed)``,
    its deferred shapes filled by one call."""
    tmx.random.seed(seed)
    net.initialize(tmx.init.Xavier())
    zeros = torch.zeros((1, 4), dtype=torch.int32)
    with torch.no_grad():
        net(zeros, zeros)
    return net


def _adam_gap_bound(grads, gaps, lr, beta1=0.9, beta2=0.999, eps=1e-8):
    """Per element, how far apart MXNet's Adam may leave two copies of the
    same weights when their gradients at step t are ``grads[t]`` and lie at
    most ``gaps[t]`` apart.  The update is ``lr_t * m / (sqrt(v) + eps)``;
    the bound follows the momenta's and the variances' gaps and the worst
    case of that quotient, step by step.  Where a gradient cancels to ~0
    the quotient's slope is ``1 / eps``: at step 1, ``lr * sqrt(1 - beta2)
    / eps`` = 9.5e3 at lr 3e-3, so rounding gaps of a few 1e-9 there
    become ~1e-5 in the weights.  Where the gradient is large the slope is
    ~``lr / |g|`` and the bound is tight."""
    bound = m = v = m_gap = v_gap = 0.0
    for t, (g, gap) in enumerate(zip(grads, gaps), start=1):
        g = np.abs(g.astype(np.float64))
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g * g
        m_gap = beta1 * m_gap + (1 - beta1) * gap
        v_gap = beta2 * v_gap + (1 - beta2) * (2 * g * gap + gap * gap)
        root = np.sqrt(v)
        # sqrt(v + d) - sqrt(v) <= min(d / (2 sqrt(v)), sqrt(d))
        root_gap = np.minimum(np.sqrt(v_gap), v_gap / np.maximum(
            2 * root, 1e-300))
        low = np.maximum(root - root_gap, 0.0) + eps
        lr_t = lr * np.sqrt(1 - beta2 ** t) / (1 - beta1 ** t)
        bound = bound + lr_t * (m_gap / low
                                + m * root_gap / ((root + eps) * low))
    return bound


def test_lm_training_matches_jax_trainer():
    """The example's Adam (default epsilon 1e-8).  Each step's gradients
    agree to LM_GRAD_ATOL; the weights after three steps agree to
    LM_RTOL/LM_ATOL plus what Adam makes of the measured gradient gaps
    (_adam_gap_bound)."""
    jnet, tnet = _lm_pair()
    assert all(p.requires_grad for p in tnet.parameters())
    lr = 3e-3
    jtrainer = mx.gluon.Trainer(jnet.collect_params(), "adam",
                                {"learning_rate": lr})
    ttrainer = gluon.Trainer(tnet.named_parameters(), "adam",
                             {"learning_rate": lr})
    jce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tce = SoftmaxCrossEntropyLoss()
    tparams = dict(tnet.named_parameters())
    names = {name: mxnet_to_torch_name(tnet, name)
             for name in jnet.collect_params()}
    grads = {name: [] for name in names}
    grad_gaps = {name: [] for name in names}
    B, T = 4, 64
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    rng_j, rng_t = np.random.RandomState(0), np.random.RandomState(0)
    for step in range(3):
        x, y = jax_pattern_batch(rng_j, B, T, VOCAB)
        xt, yt = tlm.pattern_batch(rng_t, B, T, VOCAB)
        assert np.array_equal(x, xt) and np.array_equal(y, yt)
        with mx.autograd.record():
            logits = jnet(mx.nd.array(x, dtype="int32"),
                          mx.nd.array(pos, dtype="int32"))
            jloss = jce(logits.reshape((-1, VOCAB)),
                        mx.nd.array(y.astype(np.float32)).reshape((-1,))
                        ).mean()
        jloss.backward()
        with autograd.record():
            logits = tnet(torch.from_numpy(x), torch.from_numpy(pos))
            tloss = tce(logits.reshape(-1, VOCAB),
                        torch.from_numpy(y.astype(np.float32)).reshape(-1)
                        ).mean()
        tloss.backward()
        assert abs(tloss.item() - float(jloss.asnumpy().sum())) \
            < LM_LOSS_BOUND, step
        for name, p in jnet.collect_params().items():
            gap = np.abs(tparams[names[name]].grad.numpy().astype(np.float64)
                         - p.grad().asnumpy())
            assert gap.max() < LM_GRAD_ATOL, (step, name, gap.max())
            grads[name].append(p.grad().asnumpy())
            grad_gaps[name].append(gap)
        jtrainer.step(1)
        ttrainer.step(1)
    for name, p in jnet.collect_params().items():
        want = p.data().asnumpy()
        got = tparams[names[name]].detach().numpy()
        bound = (LM_RTOL * np.abs(want) + LM_ATOL
                 + _adam_gap_bound(grads[name], grad_gaps[name], lr))
        worst = np.argmax(np.abs(got - want) - bound)
        assert np.all(np.abs(got - want) <= bound), (
            name, np.abs(got - want).flat[worst], bound.flat[worst])


# ---------------------------------------------------------------- (e)

def _dense_pair(rng):
    """The same two-layer MLP (5 -> 8 relu -> 3) in both packages."""
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(8, in_units=5, activation="relu"),
             mx.gluon.nn.Dense(3, in_units=8))
    jnet.initialize(mx.init.Xavier())
    tnet = gluon.nn.HybridSequential(
        gluon.nn.Dense(8, activation="relu", in_units=5, device="cpu"),
        gluon.nn.Dense(3, in_units=8, device="cpu"))
    with torch.no_grad():
        for jp, tp in zip(jnet.collect_params().values(),
                          tnet.parameters()):
            value = rng.normal(0, 0.5, tp.shape).astype(np.float32)
            jp.set_data(mx.nd.array(value))
            tp.copy_(torch.from_numpy(value))
    return jnet, tnet


def _round_jax(net, trainer, x, y, batch_size):
    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
            net(mx.nd.array(x)), mx.nd.array(y))
    loss.backward()
    trainer.step(batch_size)


def _round_port(net, trainer, x, y, batch_size):
    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(net(_t(x)), _t(y))
    loss.backward(torch.ones_like(loss))
    trainer.step(batch_size)


def test_trainer_rounds_match_jax_write_rule_frozen_param_and_rescale():
    rng = np.random.RandomState(6)
    jnet, tnet = _dense_pair(rng)
    frozen_j = list(jnet.collect_params().values())[1]   # first bias
    frozen_j.grad_req = "null"
    frozen_t = tnet[0].bias.requires_grad_(False)
    frozen_value = frozen_t.detach().clone()
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jtrainer = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    ttrainer = gluon.Trainer(tnet.named_parameters(), "sgd", dict(opt))
    for _ in range(2):   # grads are written each round, not added
        x = rng.normal(0, 1, (4, 5)).astype(np.float32)
        y = rng.randint(0, 3, 4).astype(np.float32)
        _round_jax(jnet, jtrainer, x, y, batch_size=4)
        _round_port(tnet, ttrainer, x, y, batch_size=4)
        assert ttrainer._optimizer.rescale_grad == 0.25
        for jp, tp in zip(jnet.collect_params().values(),
                          tnet.parameters()):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       jp.data().asnumpy(), rtol=OPT_RTOL,
                                       atol=OPT_ATOL)
            if tp is frozen_t:
                assert tp.grad is None
            else:   # the gradient written by this round's backward
                np.testing.assert_allclose(tp.grad.numpy(),
                                           jp.grad().asnumpy(),
                                           rtol=OPT_RTOL, atol=OPT_ATOL)
    assert torch.equal(frozen_t, frozen_value)


def test_trainer_steps_without_backward_match_jax():
    """A step before any backward applies a zero gradient (weight decay
    and momentum still move the weights); a step with no backward since
    the last one applies the held gradient again, as the JAX Trainer
    does.  ``torch.autograd.grad`` leaves the held gradient alone."""
    rng = np.random.RandomState(9)
    jnet, tnet = _dense_pair(rng)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}
    jtrainer = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    ttrainer = gluon.Trainer(tnet.named_parameters(), "sgd", dict(opt))
    x = rng.normal(0, 1, (4, 5)).astype(np.float32)
    y = rng.randint(0, 3, 4).astype(np.float32)

    def agree():
        for jp, tp in zip(jnet.collect_params().values(),
                          tnet.parameters()):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       jp.data().asnumpy(), rtol=OPT_RTOL,
                                       atol=OPT_ATOL)

    jtrainer.step(4)
    ttrainer.step(4)
    agree()
    _round_jax(jnet, jtrainer, x, y, batch_size=4)
    _round_port(tnet, ttrainer, x, y, batch_size=4)
    held = [p.grad.clone() for p in tnet.parameters()]
    torch.autograd.grad(SoftmaxCrossEntropyLoss()(tnet(_t(x)), _t(y)).sum(),
                        list(tnet.parameters()))
    assert all(torch.equal(p.grad, h) for p, h in zip(tnet.parameters(),
                                                       held))
    for _ in range(2):
        jtrainer.step(4)
        ttrainer.step(4)
        agree()


def test_trainer_states_round_trip(tmp_path):
    rng = np.random.RandomState(7)
    _, tnet = _dense_pair(rng)
    batches = [(rng.normal(0, 1, (4, 5)).astype(np.float32),
                rng.randint(0, 3, 4).astype(np.float32)) for _ in range(2)]
    trainer = gluon.Trainer(tnet.named_parameters(), "adam",
                            {"learning_rate": 0.01})
    _round_port(tnet, trainer, *batches[0], batch_size=4)
    after_one = {n: p.detach().clone() for n, p in tnet.named_parameters()}
    trainer.save_states(tmp_path / "adam.states")
    _round_port(tnet, trainer, *batches[1], batch_size=4)

    _, fresh = _dense_pair(np.random.RandomState(0))
    fresh.load_state_dict(after_one)
    resumed = gluon.Trainer(fresh.named_parameters(), "adam",
                            {"learning_rate": 0.01})
    resumed.load_states(tmp_path / "adam.states")
    assert resumed._optimizer.num_update == 1
    _round_port(fresh, resumed, *batches[1], batch_size=4)
    for (name, a), b in zip(tnet.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), name


def test_trainer_refuses_dist_kvstore_and_non_parameters():
    _, tnet = _dense_pair(np.random.RandomState(8))
    trainer = gluon.Trainer(list(tnet.parameters()), "sgd")
    with pytest.raises(MXNetError, match="not ported"):
        gluon.Trainer(tnet.parameters(), "sgd", kvstore="dist_sync")
    with pytest.raises(ValueError, match="Parameters"):
        gluon.Trainer([torch.zeros(3)], "sgd")
    trainer.set_learning_rate(0.5)
    assert trainer.learning_rate == 0.5


def test_record_and_pause_scopes():
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        assert torch.is_grad_enabled()
        with autograd.pause():
            assert not autograd.is_recording()
            assert not torch.is_grad_enabled()
        with autograd.predict_mode():
            assert autograd.is_recording() and not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training() and not autograd.is_recording()
    assert torch.is_grad_enabled()   # torch's own mode is put back
    assert not autograd.is_recording() and not autograd.is_training()


# ---------------------------------------------------------------- (f)

def test_main_lowers_the_loss_on_the_cpu(capsys):
    first, last, _ = tlm.main(["--device", "cpu", "--steps", "40"])
    assert last < first
    out = capsys.readouterr().out
    assert "step   0 loss" in out and "next-token accuracy" in out


def test_lm_fp32_gradients_are_as_accurate_as_jax(monkeypatch):
    """Why LM_GRAD_ATOL: the port's fp32 gradients of the example LM are
    as close to an fp64 gradient as the JAX package's are, so the ~1e-9
    disagreements that Adam's default epsilon magnifies are rounding on
    both sides, not a fault of either."""
    jnet, tnet = _lm_pair()
    x, y = tlm.pattern_batch(np.random.RandomState(0), 4, MAX_LEN, VOCAB)
    pos = np.tile(np.arange(MAX_LEN, dtype=np.int32), (4, 1))
    with mx.autograd.record():
        jloss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
            jnet(mx.nd.array(x, dtype="int32"),
                 mx.nd.array(pos, dtype="int32")).reshape((-1, VOCAB)),
            mx.nd.array(y.astype(np.float32)).reshape((-1,))).mean()
    jloss.backward()

    def port_grads(net):
        with autograd.record():
            loss = SoftmaxCrossEntropyLoss()(
                net(torch.from_numpy(x), torch.from_numpy(pos))
                .reshape(-1, VOCAB),
                torch.from_numpy(y.astype(np.float32)).reshape(-1)).mean()
        loss.backward()
        return {n: p.grad.double() for n, p in net.named_parameters()}

    g32 = port_grads(tnet)

    def attention_fp64(q, k, v, causal, scale):
        # the plain version without its fp32 cast of the scores
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
        rows = torch.arange(q.shape[2])[:, None]
        s = s.masked_fill(torch.arange(k.shape[2])[None, :] > rows, -1e30)
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)

    monkeypatch.setattr(cuda_ops, "_attention_reference", attention_fp64)
    tnet.zero_grad(set_to_none=True)
    g64 = port_grads(tnet.double())
    port_err = jax_err = 0.0
    for name, p in jnet.collect_params().items():
        truth = g64[mxnet_to_torch_name(tnet, name)].numpy()
        jax_err = max(jax_err, np.abs(p.grad().asnumpy() - truth).max())
        port_err = max(port_err, np.abs(
            g32[mxnet_to_torch_name(tnet, name)].numpy() - truth).max())
    assert jax_err < 1e-6
    assert port_err <= 1.5 * jax_err, (port_err, jax_err)
