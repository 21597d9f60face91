"""Causal transformer LM (counterpart of ``example/gluon/transformer_lm.py``:
the model, :37-96, ``pattern_batch`` and the training loop ``main``,
:98-155).

A GPT-style decoder whose attention runs through the hand-written CUDA
flash-attention kernel (``ops.cuda_ops.flash_attention``; its plain version
when the model lies on the CPU).  It is built as the example builds it:
the same name scopes and Gluon names (``transformerlm0_block0_...``), the
embeddings' shapes known and the ``Dense`` and ``LayerNorm`` shapes left to
the first call, so ``mx.random.seed(n)``, ``initialize(mx.init.Xavier())``
and one call give the example's weights.  ``forward(idx, pos_idx)`` takes int32
(B, T) token and position ids and returns (B, T, vocab) logits, in the
parameters' dtype: ``net.cast("bfloat16")`` runs the whole model, and the
kernel, in bf16.

Train it on repeating k-grams, on the card by default:

    python -m mxnet_tpu_torch.models.transformer_lm --steps 240
    python -m mxnet_tpu_torch.models.transformer_lm --device cpu --steps 60

The example's ``--sequence-parallel`` check waits for the port of ring
attention.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import autograd, initializer
from ..context import resolve_device
from ..gluon import Trainer, block
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..gluon.nn import Dense, Embedding, HybridSequential, LayerNorm
from ..ops.cuda_ops import flash_attention

__all__ = ["CausalSelfAttention", "Block", "TransformerLM", "pattern_batch",
           "main"]


class CausalSelfAttention(block.HybridBlock):
    def __init__(self, dim, heads, device=None, **kwargs):
        super().__init__(**kwargs)
        if dim % heads:
            raise ValueError("dim %d is not a multiple of heads %d"
                             % (dim, heads))
        self._h = heads
        self._dk = dim // heads
        with self.name_scope():
            self.qkv = Dense(3 * dim, use_bias=False, flatten=False,
                             device=device)
            self.out = Dense(dim, use_bias=False, flatten=False,
                             device=device)

    def forward(self, x):
        # x: (B, T, C) -> q/k/v (B, H, T, Dk) -> fused causal attention
        B, T, C = x.shape
        q, k, v = self.qkv(x).split(C, dim=-1)

        def heads(t):
            # a strided view of the qkv projection: the kernel reads it
            # through its strides, so no copy is made
            return t.view(B, T, self._h, self._dk).transpose(1, 2)

        att = flash_attention(heads(q), heads(k), heads(v), causal=True)
        return self.out(att.transpose(1, 2).reshape(B, T, C))


class Block(block.HybridBlock):
    def __init__(self, dim, heads, device=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ln1 = LayerNorm(device=device)
            self.attn = CausalSelfAttention(dim, heads, device=device)
            self.ln2 = LayerNorm(device=device)
            self.mlp = HybridSequential(prefix="")
            self.mlp.add(Dense(4 * dim, activation="relu", flatten=False,
                               device=device))
            self.mlp.add(Dense(dim, flatten=False, device=device))

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class TransformerLM(block.HybridBlock):
    """Token + position embeddings, ``depth`` blocks, final LayerNorm and
    a vocab head, on ``device`` (default ``cuda:0``).  ``initialize`` draws
    the embeddings; the other layers draw at the first call, which fills
    their shapes (or take theirs from a load)."""

    def __init__(self, vocab, dim=64, heads=4, depth=2, max_len=256,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        device = resolve_device(device)
        with self.name_scope():
            self.tok = Embedding(vocab, dim, device=device)
            self.pos = Embedding(max_len, dim, device=device)
            self.blocks = HybridSequential(prefix="")
            for _ in range(depth):
                self.blocks.add(Block(dim, heads, device=device))
            self.ln_f = LayerNorm(device=device)
            self.head = Dense(vocab, flatten=False, device=device)

    def forward(self, idx, pos_idx):
        x = self.tok(idx) + self.pos(pos_idx)
        x = self.blocks(x)
        return self.head(self.ln_f(x))


def pattern_batch(rng, batch, T, vocab):
    """Repeating k-grams: the model must learn to copy with period k.
    Returns int32 (inputs, next-token targets), each (batch, T)."""
    x = np.zeros((batch, T + 1), np.int32)
    for i in range(batch):
        k = rng.randint(2, 6)
        motif = rng.randint(0, vocab, k)
        reps = -(-(T + 1) // k)
        x[i] = np.tile(motif, reps)[:T + 1]
    return x[:, :-1], x[:, 1:]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=16)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=None,
                    help="position table size (default: --seq-len)")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    net = TransformerLM(args.vocab, dim=args.dim, heads=args.heads,
                        depth=args.depth,
                        max_len=args.max_len or args.seq_len, device=dev)
    net.initialize(initializer.Xavier())
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": 3e-3})
    ce = SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(0)

    def positions(batch):
        return torch.arange(args.seq_len, dtype=torch.int32,
                            device=dev).expand(batch, args.seq_len)

    pos = positions(args.batch_size)
    first = last = None
    for step in range(args.steps):
        x_np, y_np = pattern_batch(rng, args.batch_size, args.seq_len,
                                   args.vocab)
        x = torch.from_numpy(x_np).to(dev)
        y = torch.from_numpy(y_np.astype(np.float32)).to(dev)
        with autograd.record():
            logits = net(x, pos)          # (B, T, V)
            loss = ce(logits.reshape(-1, args.vocab), y.reshape(-1)).mean()
        loss.backward()
        trainer.step(1)
        val = loss.item()
        first = val if first is None else first
        last = val
        if step % 20 == 0:
            print("step %3d loss %.4f" % (step, val), flush=True)

    # next-token accuracy on fresh patterns (after one full period the
    # continuation is determined)
    x_np, y_np = pattern_batch(rng, 16, args.seq_len, args.vocab)
    with autograd.pause():
        pred = net(torch.from_numpy(x_np).to(dev), positions(16))
    pred = pred.argmax(-1).cpu().numpy()
    acc = float((pred[:, 8:] == y_np[:, 8:]).mean())
    print("loss %.3f -> %.3f; next-token accuracy (t>8): %.3f"
          % (first, last, acc))
    if not last < first:
        raise AssertionError("training did not reduce the loss")
    return first, last, acc


if __name__ == "__main__":
    main(sys.argv[1:])
