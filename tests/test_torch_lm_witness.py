"""Loss curves of the example's TransformerLM trained by the JAX package and
by mxnet_tpu_torch from the same weights and batches, on the CPU.

    python tests/test_torch_lm_witness.py --vocab 32768 --dim 768 --heads 12 \\
        --depth 2 --seq-len 64 --batch-size 4 --steps 40 --lr 3e-3 3e-4

For each learning rate: the JAX example's model, Xavier from ``--seed``, and
the port's model with its weights carried over, each trained by its own
``gluon.Trainer`` with Adam on ``pattern_batch(RandomState(0), ...)``.  Prints
both losses at every step, then one JSON line per learning rate with both
curves, the largest gap between them and ln(vocab), the loss of a uniform
guess.  At the example's widths both curves fall; the script shows whether
the two packages also agree at other widths.  As a test it runs ten steps
at the example's widths.
"""
import argparse
import json
import math
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "example", "gluon"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu_torch import autograd, gluon  # noqa: E402
from mxnet_tpu_torch.convert import load_mxnet_params  # noqa: E402
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss  # noqa: E402
from mxnet_tpu_torch.models import transformer_lm as tlm  # noqa: E402
from transformer_lm import TransformerLM as JaxLM  # noqa: E402
from transformer_lm import pattern_batch  # noqa: E402


def curves(args, lr):
    """Both packages' per-step losses at learning rate ``lr``."""
    widths = dict(dim=args.dim, heads=args.heads, depth=args.depth,
                  max_len=args.seq_len)
    mx.random.seed(args.seed)
    jnet = JaxLM(args.vocab, **widths)
    jnet.initialize(mx.init.Xavier())
    zeros = mx.nd.array(np.zeros((1, 4), np.int32), dtype="int32")
    jnet(zeros, zeros)   # finish deferred init
    tnet = load_mxnet_params(
        tlm.TransformerLM(args.vocab, device="cpu", **widths),
        {n: p.data().asnumpy() for n, p in jnet.collect_params().items()})
    jtrainer = mx.gluon.Trainer(jnet.collect_params(), "adam",
                                {"learning_rate": lr})
    ttrainer = gluon.Trainer(tnet.named_parameters(), "adam",
                             {"learning_rate": lr})
    jce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tce = SoftmaxCrossEntropyLoss()
    B, T, V = args.batch_size, args.seq_len, args.vocab
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    rng = np.random.RandomState(0)
    losses = []
    for step in range(args.steps):
        x, y = pattern_batch(rng, B, T, V)
        with mx.autograd.record():
            logits = jnet(mx.nd.array(x, dtype="int32"),
                          mx.nd.array(pos, dtype="int32"))
            jloss = jce(logits.reshape((-1, V)),
                        mx.nd.array(y.astype(np.float32)).reshape((-1,))
                        ).mean()
        jloss.backward()
        jtrainer.step(1)
        with autograd.record():
            logits = tnet(torch.from_numpy(x), torch.from_numpy(pos))
            tloss = tce(logits.reshape(-1, V),
                        torch.from_numpy(y.astype(np.float32)).reshape(-1)
                        ).mean()
        tloss.backward()
        ttrainer.step(1)
        losses.append((float(jloss.asnumpy().sum()), tloss.item()))
        print("lr %g step %3d loss jax %.6f port %.6f"
              % (lr, step, *losses[-1]), flush=True)
    return losses


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vocab", type=int, default=16)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, nargs="+", default=[3e-3])
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def test_curves_agree_at_the_example_widths():
    """Ten Adam steps at lr 3e-3: the losses agree at
    test_torch_transformer_lm.py's bound, 1e-4, and fall."""
    losses = curves(parse(["--steps", "10"]), 3e-3)
    assert max(abs(a - b) for a, b in losses) < 1e-4
    assert losses[-1][1] < losses[0][1]


def main(argv=None):
    args = parse(argv)
    torch.set_num_threads(min(8, torch.get_num_threads()))
    for lr in args.lr:
        start = time.perf_counter()
        losses = curves(args, lr)
        jax_curve, port_curve = zip(*losses)
        print(json.dumps({
            "lr": lr, "widths": vars(args), "ln_vocab": math.log(args.vocab),
            "jax": jax_curve, "port": port_curve,
            "max_gap": max(abs(a - b) for a, b in losses),
            "seconds": time.perf_counter() - start}), flush=True)


if __name__ == "__main__":
    main()
