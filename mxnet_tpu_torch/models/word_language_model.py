"""Transformer word-language model (counterpart of
``example/gluon/word_language_model.py``: ``MultiHeadSelfAttention``,
``TransformerBlock``, ``TransformerLM``, :25-82, and ``main``, :85-126).

Built as the example builds it: the same name scopes and Gluon names
(``transformerlm0_transformerblock0_...``), the embedding, position table
and LayerNorms with known shapes and the ``Dense`` layers left to the first
call, so ``mx.random.seed(n)``, ``initialize(mx.init.Xavier())`` and one
call give the example's weights.  Each block holds one ``Dropout(0.1)``,
applied twice, which draws its masks from the call's key (the JAX
package's masks, bit for bit, from one seed: ``random.py``).  Attention
runs through the ``_contrib_flash_attention`` op, the hand-written CUDA
kernel on the card (``ops/cuda_ops.py``) and its plain version on the CPU.
``forward(x)`` takes int32 (B, T) tokens and returns (B, T, vocab) logits.

Train it on the example's synthetic task (the next token is the token
plus one), on the card by default:

    python -m mxnet_tpu_torch.models.word_language_model
    python -m mxnet_tpu_torch.models.word_language_model --device cpu
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from .. import autograd, initializer
from .. import ndarray as nd
from ..context import resolve_device
from ..gluon import Trainer, block
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..gluon.nn import Dense, Dropout, Embedding, HybridSequential, LayerNorm
from ..ndarray.register import tensor_ops

__all__ = ["MultiHeadSelfAttention", "TransformerBlock", "TransformerLM",
           "synthetic_data", "main"]


class MultiHeadSelfAttention(block.HybridBlock):
    def __init__(self, dim, heads, device=None, **kwargs):
        super().__init__(**kwargs)
        if dim % heads:
            raise AssertionError("dim %d is not a multiple of heads %d"
                                 % (dim, heads))
        self._heads = heads
        self._dim = dim
        with self.name_scope():
            self.qkv = Dense(3 * dim, use_bias=False, flatten=False,
                             device=device)
            self.proj = Dense(dim, use_bias=False, flatten=False,
                              device=device)

    def forward(self, x):
        B, T, C = x.shape
        H = self._heads
        qkv = self.qkv(x).view(B, T, 3, H, C // H)
        # strided (B, H, T, D) views: the kernel reads them in place
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = tensor_ops._contrib_flash_attention(q, k, v, causal=True)
        return self.proj(out.transpose(1, 2).reshape(B, T, C))


class TransformerBlock(block.HybridBlock):
    def __init__(self, dim, heads, hidden, dropout=0.1, device=None,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ln1 = LayerNorm(in_channels=dim, device=device)
            self.attn = MultiHeadSelfAttention(dim, heads, device=device)
            self.ln2 = LayerNorm(in_channels=dim, device=device)
            self.ff1 = Dense(hidden, activation="relu", flatten=False,
                             device=device)
            self.ff2 = Dense(dim, flatten=False, device=device)
            self.drop = Dropout(dropout)

    def forward(self, x):
        x = x + self.drop(self.attn(self.ln1(x)))
        return x + self.drop(self.ff2(self.ff1(self.ln2(x))))


class TransformerLM(block.HybridBlock):
    """Token embeddings plus a learned position table (``pos_weight``),
    ``layers`` blocks, a final LayerNorm and a vocab head, on ``device``
    (default ``cuda:0``)."""

    def __init__(self, vocab, dim=64, heads=4, hidden=128, layers=2,
                 max_len=512, device=None, **kwargs):
        super().__init__(**kwargs)
        device = resolve_device(device)
        self._device = device
        with self.name_scope():
            self.embed = Embedding(vocab, dim, device=device)
            self.pos = self.params.get("pos_weight", shape=(max_len, dim))
            self.blocks = HybridSequential()
            for _ in range(layers):
                self.blocks.add(TransformerBlock(dim, heads, hidden,
                                                 device=device))
            self.ln_f = LayerNorm(in_channels=dim, device=device)
            self.head = Dense(vocab, flatten=False, device=device)

    def forward(self, x):
        T = x.shape[1]
        h = self.embed(x) + self.pos[:T].unsqueeze(0)
        return self.head(self.ln_f(self.blocks(h)))


def synthetic_data(vocab, seq_len, n=512, seed=0):
    """The example's copy-task data: ``n`` rows of random tokens and their
    targets, each token plus one (mod ``vocab``)."""
    rng = np.random.RandomState(seed)
    data = rng.randint(0, vocab, (n, seq_len))
    return data, (data + 1) % vocab


def main(argv=None):
    """The example's loop: Adam on ``SoftmaxCrossEntropyLoss`` over the
    synthetic data, a ``--batch-size`` slice at a time for
    ``--num-epochs``; returns the last epoch's mean loss."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--vocab", type=int, default=64)
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--heads", type=int, default=4)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--seq-len", type=int, default=32)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--num-epochs", type=int, default=3)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)

    data, target = synthetic_data(args.vocab, args.seq_len)
    net = TransformerLM(args.vocab, args.dim, args.heads,
                        layers=args.layers, device=dev)
    net.initialize(initializer.Xavier())
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": args.lr})
    loss_fn = SoftmaxCrossEntropyLoss()
    n = data.shape[0]
    total, count = 0.0, 0
    for epoch in range(args.num_epochs):
        total, count = 0.0, 0
        for i in range(0, n, args.batch_size):
            x = nd.array(data[i:i + args.batch_size], ctx=dev, dtype="int32")
            y = nd.array(target[i:i + args.batch_size], ctx=dev)
            with autograd.record():
                logits = net(x)
                loss = loss_fn(logits, y)
            loss.backward()
            trainer.step(x.shape[0])
            total += float(loss.mean().asscalar())
            count += 1
        logging.info("Epoch %d loss %.4f", epoch, total / count)
    print("final loss:", total / count)
    return total / count


if __name__ == "__main__":
    main(sys.argv[1:])
