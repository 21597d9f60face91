"""The causal transformer LM's training step written in ``mx.nd`` ops.

The same model as ``models/transformer_lm.py`` (and
``example/gluon/transformer_lm.py``), as an MXNet user writes it without
Gluon: the example's ``hybrid_forward`` with ``F = nd`` over a dict of
parameter NDArrays, the loss ``softmax_cross_entropy`` over the tokens,
``autograd.record()``/``backward()``, and one ``nd.adam_update`` a
parameter with MXNet's bias correction folded into ``lr``.  Attention runs
through ``nd._contrib_flash_attention``: on the card, the hand-written
CUDA kernel.

The functions take the package (``mx``, or its ``nd``) as an argument and
use nothing but its ``nd`` and ``autograd``, so they run unchanged on this
package and on any other with MXNet's imperative API.  Parameters are
named as the port's ``TransformerLM.named_parameters()`` names them
(``tok.weight``, ``blocks.0.attn.qkv.weight``, ...).
"""
from __future__ import annotations

import math

__all__ = ["forward", "loss", "adam_states", "train_step"]


def forward(F, params, idx, pos_idx, heads):
    """(B, T, vocab) logits of int32 (B, T) token and position ids."""
    p = params
    x = F.Embedding(idx, p["tok.weight"]) + F.Embedding(pos_idx,
                                                        p["pos.weight"])
    depth = sum(1 for n in p if n.endswith(".ln1.gamma"))
    for i in range(depth):
        b = "blocks.%d." % i
        h = F.LayerNorm(x, p[b + "ln1.gamma"], p[b + "ln1.beta"], axis=-1,
                        eps=1e-5)
        qkv = F.FullyConnected(h, p[b + "attn.qkv.weight"], no_bias=True,
                               flatten=False)
        q, k, v = F.split(qkv, num_outputs=3, axis=-1)

        def split_heads(t):
            return F.transpose(t.reshape((0, 0, heads, -1)),
                               axes=(0, 2, 1, 3))

        att = F._contrib_flash_attention(split_heads(q), split_heads(k),
                                         split_heads(v), causal=True)
        att = F.transpose(att, axes=(0, 2, 1, 3)).reshape((0, 0, -1))
        x = x + F.FullyConnected(att, p[b + "attn.out.weight"],
                                 no_bias=True, flatten=False)
        h = F.LayerNorm(x, p[b + "ln2.gamma"], p[b + "ln2.beta"], axis=-1,
                        eps=1e-5)
        h = F.Activation(F.FullyConnected(h, p[b + "mlp.0.weight"],
                                          p[b + "mlp.0.bias"],
                                          flatten=False), act_type="relu")
        x = x + F.FullyConnected(h, p[b + "mlp.1.weight"],
                                 p[b + "mlp.1.bias"], flatten=False)
    x = F.LayerNorm(x, p["ln_f.gamma"], p["ln_f.beta"], axis=-1, eps=1e-5)
    return F.FullyConnected(x, p["head.weight"], p["head.bias"],
                            flatten=False)


def loss(F, logits, labels):
    """Mean next-token cross-entropy: ``softmax_cross_entropy`` (a sum)
    over the number of tokens."""
    vocab = logits.shape[-1]
    n = labels.size
    return F.softmax_cross_entropy(logits.reshape((-1, vocab)),
                                   labels.reshape((-1,))) / n


def adam_states(mx, params):
    """Adam's zero mean and variance for each parameter."""
    def zeros(w):
        return mx.nd.zeros(w.shape, ctx=w.context, dtype=w.dtype)
    return {n: (zeros(w), zeros(w)) for n, w in params.items()}


def train_step(mx, params, states, t, x, y, pos, heads, lr, beta1=0.9,
               beta2=0.999, epsilon=1e-8):
    """One recorded forward and loss, ``backward``, and the ``t``-th Adam
    update of every parameter (each must have ``attach_grad()``).  Returns
    the loss NDArray, shape (1,).

    The update is written as the JAX package's Adam optimizer writes it,
    ``adam_update(w, g, m, v, out=[w, m, v])``: that package's op returns
    the states without writing them back, so naming all three outputs is
    what runs on both packages."""
    with mx.autograd.record():
        out = loss(mx.nd, forward(mx.nd, params, x, pos, heads), y)
    out.backward()
    lr_t = lr * math.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
    for name, w in params.items():
        m, v = states[name]
        mx.nd.adam_update(w, w.grad, m, v, out=[w, m, v], lr=lr_t,
                          beta1=beta1, beta2=beta2, epsilon=epsilon)
    return out
