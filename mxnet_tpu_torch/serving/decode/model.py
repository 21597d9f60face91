"""Decode-capable model contract + a self-contained reference LM
(counterpart of ``mxnet_tpu/serving/decode/model.py``).

The decode engine does not wrap arbitrary Gluon blocks: an autoregressive
step needs the model to read and write *paged* KV state, which is a
different calling convention from a stateless batch forward.  A decode
model is any object exposing:

* ``vocab_size`` / ``num_layers`` / ``num_heads`` / ``head_dim`` /
  ``max_len`` attributes (the KV pool geometry comes from these) and
  ``device`` (where its parameters live);
* ``param_dict()`` -> ``{name: tensor}`` — live parameter tensors, passed
  straight into the engine's CachedOps;
* ``prefill_fn(params, tokens, length, table, k_pool, v_pool)`` — tensors
  in, tensors out: tokens ``[1, Lb]`` int32 (padded to a prompt bucket),
  length ``[1]`` int32 (the real prompt length), table ``[1, W]`` int32
  page table.  Runs the whole prompt in one causal pass, writes every
  position's K/V into the sequence's pages **in place**, and returns
  ``(logits [1, V] for position length-1, k_pool, v_pool)`` — the same
  pool tensors it was given;
* ``decode_fn(params, tokens, positions, tables, k_pool, v_pool)`` — one
  token per slot: tokens ``[S]`` int32, positions ``[S]`` int32 (the cache
  index the new token's K/V lands at), tables ``[S, W]`` int32.  Returns
  ``(logits [S, V], k_pool, v_pool)``.

The JAX package's functions return new pools (``.at[].set``); here the
pools are state that a captured CUDA graph reads and writes where they
lie, so that a step moves no copy of a pool.  Every function is
capturable: shapes depend only on the input shapes, and every index is
read on the device (``index_select``/``gather``, never ``.item()``).
Indices are cast to int64 inside; out-of-range gathers are clamped, as
JAX clamps them.

Two optional entry points unlock chunked prefill and speculative decoding:

* ``chunk_prefill_fn(params, tokens, start, length, table, k_pool,
  v_pool)`` — one fixed-size prompt chunk: tokens ``[1, C]``, start ``[1]``
  (absolute position of the chunk's first token), length ``[1]`` (real
  tokens in this chunk).  Attends to cache positions ``0..start+i``
  through the page table (earlier chunks' K/V is READ from the pool, which
  is what makes cross-request prefix reuse bitwise-sound), writes this
  chunk's K/V, and returns logits for row ``length-1``.
* ``verify_fn(params, tokens, positions, valids, tables, k_pool,
  v_pool)`` — the speculative verify step: tokens ``[S, K+1]`` (the
  committed token followed by K draft proposals), positions ``[S]``,
  valids ``[S]`` (rows at or past ``valids[s]`` write to the trash block
  and are ignored).  Returns logits ``[S, K+1, V]``.

Exactness contract (what the engine's bitwise gates lean on): dead slots
and page-table padding use masks whose excluded weights are EXACTLY zero
(``exp(-inf) == 0``), and every per-slot computation is row-independent,
so a slot's logits are bit-identical whether its neighbours are live,
dead, or absent.  The decode step must also be bit-identical whatever
table width bucket the scheduler picked: the live engine picks the width
from its widest slot, ``DecodeEngine.generate_reference`` from its own
need.  On the card, a GEMM, ``sum`` or ``softmax`` over the table's
positions may reduce in an order that depends on that width.  So
``decode_fn`` reduces over positions (and over the head dimension) by
halving: the first half plus the second, repeated, over the length padded
to a power of two.  Trailing masked positions are exact zeros and fold
away, so the sum is the same bits at every width, on the card and on the
CPU.  The other functions run at one width per engine and use plain
``einsum`` and softmax.

``TinyCausalLM`` is the in-tree reference implementation: a small pre-norm
transformer (learned positions, weight-tied unembedding).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...context import resolve_device
from ...ndarray.ndarray import NDArray

__all__ = ["TinyCausalLM"]


def _rms(x):
    return x / torch.sqrt(torch.mean(torch.square(x), dim=-1, keepdim=True)
                          + 1e-6)


def _softmax(scores):
    """Max-shifted softmax over the last axis with exact-zero masking:
    ``exp(-inf - finite_max) == 0`` exactly, so masked positions contribute
    nothing to the normalizer regardless of the padded width."""
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    return e / torch.sum(e, dim=-1, keepdim=True)


def _halving_sum(x, dim):
    """Sum over ``dim`` as a fixed tree: pad the length to a power of two
    with zeros, add the upper half onto the lower, repeat.  Zeros at the
    end of ``dim`` fold away exactly, so the result does not depend on how
    many there are."""
    n = x.shape[dim]
    if n > 1:
        half = 1 << ((n - 1).bit_length() - 1)    # pow2 >= n, halved
        lo = x.narrow(dim, 0, half)
        hi = x.narrow(dim, half, n - half)
        if n - half < half:       # the padding's zeros: carry lo as is
            x = torch.cat([lo.narrow(dim, 0, n - half) + hi,
                           lo.narrow(dim, n - half, 2 * half - n)], dim)
        else:
            x = lo + hi
        n = half
        while n > 1:
            n //= 2
            x = x.narrow(dim, 0, n) + x.narrow(dim, n, n)
    return x.squeeze(dim)


def _take(table, idx):
    """``table[idx]`` along axis 0 with ``idx`` clamped into range (JAX's
    gather clamps); both int64."""
    return table[idx.clamp(0, table.shape[0] - 1)]


class TinyCausalLM:
    """Small causal transformer LM with paged-KV prefill/decode functions.

    ``device`` defaults to ``cuda:0`` (raises without CUDA); pass ``"cpu"``
    to run on the CPU.  The seeded weights are the JAX package's: the same
    ``np.random.RandomState(seed)`` normals in the same order.  ``params``
    takes ``{name: numpy array, tensor or NDArray}`` (the JAX package's
    weights carry across this way, and a checkpoint's ``arg_params`` from
    ``model.load_checkpoint``), validated against the geometry.
    """

    def __init__(self, vocab_size=48, hidden=32, num_layers=2, num_heads=2,
                 max_len=128, seed=0, eos_id=None, context_attention=None,
                 params=None, device=None):
        if hidden % num_heads:
            raise ValueError("hidden must divide into num_heads")
        if context_attention is not None:
            raise NotImplementedError(
                "context_attention (sequence-parallel prompt attention) "
                "needs serving.decode.sharding, which is not ported yet")
        self.context_attention = None
        self.vocab_size = int(vocab_size)
        self.hidden = int(hidden)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = self.hidden // self.num_heads
        self.max_len = int(max_len)
        self.eos_id = eos_id
        self.device = resolve_device(device)
        expected = {"embed": (self.vocab_size, self.hidden),
                    "pos": (self.max_len, self.hidden)}
        for l in range(self.num_layers):
            expected["l%d_wq" % l] = (self.hidden, self.hidden)
            expected["l%d_wk" % l] = (self.hidden, self.hidden)
            expected["l%d_wv" % l] = (self.hidden, self.hidden)
            expected["l%d_wo" % l] = (self.hidden, self.hidden)
            expected["l%d_w1" % l] = (self.hidden, 2 * self.hidden)
            expected["l%d_w2" % l] = (2 * self.hidden, self.hidden)
        if params is not None:
            # checkpoint-loaded weights: validate against the geometry
            # before anything can capture a graph over a half-shaped model
            if set(params) != set(expected):
                missing = sorted(set(expected) - set(params))
                extra = sorted(set(params) - set(expected))
                raise ValueError("params key mismatch: missing %r extra %r"
                                 % (missing, extra))
            loaded = {}
            for k, shape in expected.items():
                arr = params[k]
                if tuple(arr.shape) != shape:
                    raise ValueError("param %r has shape %r, expected %r"
                                     % (k, tuple(arr.shape), shape))
                if isinstance(arr, NDArray):
                    arr = arr._data
                if not isinstance(arr, torch.Tensor):
                    arr = torch.from_numpy(np.array(arr, np.float32))
                loaded[k] = arr.to(self.device, torch.float32)
            self._params = loaded
            return
        rng = np.random.RandomState(seed)
        scale = 1.0 / np.sqrt(self.hidden)

        def w(*shape):
            # the JAX package's expression, then nd.array's float32 cast
            a = np.asarray(rng.randn(*shape).astype(np.float32) * scale)
            return torch.from_numpy(a.astype(np.float32)).to(self.device)

        self._params = {k: w(*shape) for k, shape in expected.items()}

    def param_dict(self):
        return dict(self._params)

    def partition_specs(self):
        raise NotImplementedError(
            "weight sharding needs serving.decode.sharding, which is not "
            "ported yet")

    # ------------------------------------------------------------------
    def _qkv(self, p, l, x, n_rows):
        h, d = self.num_heads, self.head_dim
        q = (x @ p["l%d_wq" % l]).reshape(n_rows, h, d)
        k = (x @ p["l%d_wk" % l]).reshape(n_rows, h, d)
        v = (x @ p["l%d_wv" % l]).reshape(n_rows, h, d)
        return q, k, v

    def _mlp(self, p, l, h):
        # jax.nn.gelu's default is the tanh form
        return h + F.gelu(_rms(h) @ p["l%d_w1" % l],
                          approximate="tanh") @ p["l%d_w2" % l]

    def prefill_fn(self, p, tokens, length, table, k_pool, v_pool):
        """Causal pass over one padded prompt; writes K/V into pages."""
        dev = tokens.device
        bs = k_pool.shape[2]
        L = tokens.shape[1]
        t = tokens[0].long()
        h = p["embed"][t] + p["pos"][:L]                       # [L, H]
        idx = torch.arange(L, device=dev)
        blk = _take(table[0].long(), idx // bs)
        off = idx % bs
        # causal mask: position i attends j <= i; prompt padding sits at
        # j >= length > i for every real row, so it is excluded for free
        causal = idx[None, :] <= idx[:, None]                  # [L, L]
        scale = math.sqrt(float(self.head_dim))
        for l in range(self.num_layers):
            q, k, v = self._qkv(p, l, _rms(h), L)
            # pad-row K/V lands in the trash block / the tail of the
            # sequence's own last block — positions the attention mask
            # never admits before a decode write overwrites them
            k_pool[l, blk, off] = k
            v_pool[l, blk, off] = v
            scores = torch.einsum("ihd,jhd->hij", q, k) / scale
            scores = scores.masked_fill(~causal[None], float("-inf"))
            w = _softmax(scores)
            att = torch.einsum("hij,jhd->ihd", w, v).reshape(L, self.hidden)
            h = h + att @ p["l%d_wo" % l]
            h = self._mlp(p, l, h)
        last = _rms(h.index_select(0, length.long() - 1))      # [1, H]
        logits = last @ p["embed"].T
        return logits, k_pool, v_pool

    def decode_fn(self, p, tokens, positions, tables, k_pool, v_pool):
        """One fixed-shape decode step for every slot (live or dead), with
        the width-independent reductions of the module docstring."""
        dev = tokens.device
        bs = k_pool.shape[2]
        S = tokens.shape[0]
        W = tables.shape[1]
        T = W * bs
        nh, d = self.num_heads, self.head_dim
        pos = positions.long()
        tab = tables.long()
        h = p["embed"][tokens.long()] + _take(p["pos"], pos)      # [S, H]
        blk = tab.gather(1, (pos // bs).clamp(0, W - 1)[:, None])[:, 0]
        off = pos % bs
        # valid cache positions: 0..positions[s] inclusive (the new token
        # attends to itself); excluded weights are EXACTLY zero, so table
        # padding and stale pool contents cannot perturb live slots
        mask = torch.arange(T, device=dev)[None, :] <= pos[:, None]
        scale = math.sqrt(float(d))
        for l in range(self.num_layers):
            q, k, v = self._qkv(p, l, _rms(h), S)
            k_pool[l, blk, off] = k
            v_pool[l, blk, off] = v
            kseq = k_pool[l][tab].reshape(S, T, nh, d)
            vseq = v_pool[l][tab].reshape(S, T, nh, d)
            scores = _halving_sum(q[:, None] * kseq, 3) / scale  # [S, T, h]
            scores = scores.masked_fill(~mask[:, :, None], float("-inf"))
            e = torch.exp(scores - torch.amax(scores, dim=1, keepdim=True))
            w = e / _halving_sum(e, 1)[:, None]
            att = _halving_sum(w[..., None] * vseq, 1)          # [S, h, d]
            h = h + att.reshape(S, self.hidden) @ p["l%d_wo" % l]
            h = self._mlp(p, l, h)
        logits = _rms(h) @ p["embed"].T
        return logits, k_pool, v_pool

    def chunk_prefill_fn(self, p, tokens, start, length, table, k_pool,
                         v_pool):
        """One prompt chunk at absolute positions start..start+C-1.

        Earlier chunks are consumed through the page table (gathered from
        the pool, not recomputed), so a chunk run on top of another
        request's shared prefix pages produces bit-identical K/V and
        logits to a private from-scratch chunked run — the property the
        copy-on-write prefix cache banks on.
        """
        dev = tokens.device
        bs = k_pool.shape[2]
        C = tokens.shape[1]
        W = table.shape[1]
        T = W * bs
        t = tokens[0].long()
        tab = table[0].long()
        ar = torch.arange(C, device=dev)
        pos = start.long() + ar                                # absolute
        h = p["embed"][t] + _take(p["pos"], pos)
        valid = ar < length.long()
        blk = _take(tab, pos // bs)
        blk = torch.where(valid, blk, torch.zeros_like(blk))   # pad -> trash
        off = pos % bs
        # pad rows clamp to position 0 (attend j <= 0): finite garbage,
        # the same dead-slot discipline as decode_fn.  An all-False mask
        # row would softmax to NaN and poison the trash block.
        epos = torch.where(valid, pos, torch.zeros_like(pos))
        mask = torch.arange(T, device=dev)[None, :] <= epos[:, None]
        scale = math.sqrt(float(self.head_dim))
        for l in range(self.num_layers):
            q, k, v = self._qkv(p, l, _rms(h), C)
            k_pool[l, blk, off] = k
            v_pool[l, blk, off] = v
            kseq = k_pool[l][tab].reshape(T, self.num_heads, self.head_dim)
            vseq = v_pool[l][tab].reshape(T, self.num_heads, self.head_dim)
            scores = torch.einsum("ihd,jhd->hij", q, kseq) / scale
            scores = scores.masked_fill(~mask[None], float("-inf"))
            w = _softmax(scores)
            att = torch.einsum("hij,jhd->ihd", w, vseq).reshape(
                C, self.hidden)
            h = h + att @ p["l%d_wo" % l]
            h = self._mlp(p, l, h)
        last = _rms(h.index_select(0, length.long() - 1))
        logits = last @ p["embed"].T
        return logits, k_pool, v_pool

    def verify_fn(self, p, tokens, positions, valids, tables, k_pool,
                  v_pool):
        """Speculative verify: K+1 tokens per slot in one fixed-shape call.

        Row ``i`` of slot ``s`` is the committed/proposed token at cache
        position ``positions[s] + i``; rows at or past ``valids[s]`` write
        to the trash block and attend position 0 only (finite garbage —
        see chunk_prefill_fn).  Per-row outputs depend only on that row's
        token, its position, and masked pool content, so a verify call
        with one valid row reproduces ``generate_reference`` bitwise and
        extra proposal rows never perturb the accepted prefix.
        """
        dev = tokens.device
        bs = k_pool.shape[2]
        S, K1 = tokens.shape
        W = tables.shape[1]
        T = W * bs
        nh, d = self.num_heads, self.head_dim
        tab = tables.long()
        ar = torch.arange(K1, device=dev)
        pos = positions.long()[:, None] + ar[None, :]          # [S, K1]
        valid = ar[None, :] < valids.long()[:, None]
        h = p["embed"][tokens.long()] + _take(p["pos"], pos)      # [S, K1, H]
        blk = tab.gather(1, (pos // bs).clamp(0, W - 1))
        blk = torch.where(valid, blk, torch.zeros_like(blk))   # -> trash
        off = pos % bs
        epos = torch.where(valid, pos, torch.zeros_like(pos))
        mask = torch.arange(T, device=dev)[None, None, :] <= epos[:, :, None]
        scale = math.sqrt(float(d))
        for l in range(self.num_layers):
            x = _rms(h)
            q = (x @ p["l%d_wq" % l]).reshape(S, K1, nh, d)
            k = (x @ p["l%d_wk" % l]).reshape(S, K1, nh, d)
            v = (x @ p["l%d_wv" % l]).reshape(S, K1, nh, d)
            k_pool[l, blk, off] = k
            v_pool[l, blk, off] = v
            kseq = k_pool[l][tab].reshape(S, T, nh, d)
            vseq = v_pool[l][tab].reshape(S, T, nh, d)
            scores = torch.einsum("sihd,sjhd->shij", q, kseq) / scale
            scores = scores.masked_fill(~mask[:, None], float("-inf"))
            w = _softmax(scores)
            att = torch.einsum("shij,sjhd->sihd", w, vseq).reshape(
                S, K1, self.hidden)
            h = h + att @ p["l%d_wo" % l]
            h = self._mlp(p, l, h)
        logits = _rms(h) @ p["embed"].T                        # [S, K1, V]
        return logits, k_pool, v_pool

    def propose_fn(self, p, tokens, positions, tables, k_pool, v_pool,
                   num_tokens):
        """Greedy draft proposer: ``num_tokens`` unrolled decode steps with
        the argmax on the device, so one captured call yields K proposals.
        Returns (proposals ``[S, num_tokens]`` int32, k_pool, v_pool)."""
        cur = tokens
        pos = positions
        outs = []
        for _ in range(int(num_tokens)):
            logits, k_pool, v_pool = self.decode_fn(
                p, cur, pos, tables, k_pool, v_pool)
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
            outs.append(cur)
            pos = pos + 1
        return torch.stack(outs, dim=1), k_pool, v_pool
