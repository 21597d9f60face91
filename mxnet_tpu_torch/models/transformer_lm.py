"""Causal transformer LM (counterpart of ``example/gluon/transformer_lm.py``
``CausalSelfAttention``, ``Block`` and ``TransformerLM``, :37-96).

A GPT-style decoder whose attention runs through the hand-written CUDA
flash-attention kernel (``ops.cuda_ops.flash_attention``; its plain version
when the model lies on the CPU).  ``forward(idx, pos_idx)`` takes int32
(B, T) token and position ids and returns (B, T, vocab) logits.
"""
from __future__ import annotations

from torch import nn

from ..context import resolve_device
from ..gluon.nn import Dense, Embedding, HybridSequential, LayerNorm
from ..ops.cuda_ops import flash_attention

__all__ = ["CausalSelfAttention", "Block", "TransformerLM"]


class CausalSelfAttention(nn.Module):
    def __init__(self, dim, heads, device=None):
        super().__init__()
        if dim % heads:
            raise ValueError("dim %d is not a multiple of heads %d"
                             % (dim, heads))
        self._h = heads
        self._dk = dim // heads
        self.qkv = Dense(3 * dim, dim, use_bias=False, flatten=False,
                         device=device)
        self.out = Dense(dim, dim, use_bias=False, flatten=False,
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


class Block(nn.Module):
    def __init__(self, dim, heads, device=None):
        super().__init__()
        self.ln1 = LayerNorm(dim, device=device)
        self.attn = CausalSelfAttention(dim, heads, device=device)
        self.ln2 = LayerNorm(dim, device=device)
        self.mlp = HybridSequential(
            Dense(4 * dim, dim, activation="relu", flatten=False,
                  device=device),
            Dense(dim, 4 * dim, flatten=False, device=device))

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class TransformerLM(nn.Module):
    """Token + position embeddings, ``depth`` blocks, final LayerNorm and
    a vocab head.  Built on ``device`` (default ``cuda:0``); parameters are
    uninitialized until ``initializer.initialize`` or
    ``convert.load_mxnet_params`` fills them."""

    def __init__(self, vocab, dim=64, heads=4, depth=2, max_len=256,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.tok = Embedding(vocab, dim, device=device)
        self.pos = Embedding(max_len, dim, device=device)
        self.blocks = HybridSequential(
            *[Block(dim, heads, device=device) for _ in range(depth)])
        self.ln_f = LayerNorm(dim, device=device)
        self.head = Dense(vocab, dim, flatten=False, device=device)

    def forward(self, idx, pos_idx):
        x = self.tok(idx) + self.pos(pos_idx)
        x = self.blocks(x)
        return self.head(self.ln_f(x))
