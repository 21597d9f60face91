"""Gluon-block -> paged-KV decode-model adapter (counterpart of
``mxnet_tpu/serving/decode/adapter.py``).

The decode engine speaks the paged-KV contract (model.py), not the Gluon
batch-forward convention — a Gluon causal LM cannot serve as-is because
an autoregressive step must read and write paged pool state.  What a
trained block DOES carry is everything the contract functions need: the
weights.  :class:`GluonCausalLMAdapter` turns a live causal LM block of the
reference architecture into a full contract model:

* **role discovery** maps ``collect_params()`` names onto roles by
  suffix — ``embed_weight``, ``pos_weight`` and per-layer
  ``l{i}_{wq|wk|wv|wo|w1|w2}_weight`` (any block/name-scope prefix) — or
  through an explicit ``layer_map`` when a block names things its own
  way.  Missing or ambiguous roles raise ValueErrors naming the
  candidates, never a shape error inside a captured graph.
* **live handles**: ``param_dict()`` returns each parameter's own tensor,
  so the engine's CachedOps read the block's storage — no copies.
* **layout adaptation happens inside the forward**: Gluon ``Dense``
  stores ``[units, in_units]`` (FullyConnected computes ``x @ W.T``) while
  the contract functions take ``[in, out]``; the adapter hands them
  ``W.T``, a view the matmul reads transposed, so the block's storage is
  what the graph reads.
* the serving functions are ``TinyCausalLM``'s: the adapter delegates to
  its prefill/decode/chunk/verify/propose suite over the adapted weights,
  so the exactness contract (exact-zero masking, row-independence, fixed
  signatures, width-independent decode sums) holds by construction and
  the whole engine (prefix cache, CoW, chunked prefill, speculative
  verify, export/import handoff) applies unchanged.

``num_heads`` must be supplied — a weight file cannot reveal how a square
attention projection splits into heads.  Everything else (vocab/hidden/
layer count/max_len) is read off the discovered shapes.

:class:`TinyGluonLM` is the in-tree demo block: the same pre-norm
transformer as ``TinyCausalLM`` written as a ``HybridBlock`` (a batch
forward over tokens ``[B, T]``).

Not ported yet: serving an exported block (``SymbolBlock.imports``, which
waits for ``HybridBlock.export``) and ``partition_specs`` (sharding).
"""
from __future__ import annotations

import re

import torch
import torch.nn.functional as F

from ...context import resolve_device
from ...gluon.block import HybridBlock
from .model import TinyCausalLM, _rms

__all__ = ["GluonCausalLMAdapter", "TinyGluonLM", "discover_roles",
           "copy_reference_weights", "DENSE_ROLES"]

DENSE_ROLES = ("wq", "wk", "wv", "wo", "w1", "w2")

_LAYER_RE = re.compile(r"(?:^|_)l(\d+)_(wq|wk|wv|wo|w1|w2)_weight$")
_EMBED_RE = re.compile(r"(?:^|_)embed_weight$")
_POS_RE = re.compile(r"(?:^|_)pos_weight$")


def discover_roles(names, layer_map=None):
    """Map parameter names onto kernel roles by suffix.

    Returns ``{role: name}`` with roles ``embed``, ``pos`` and
    ``l{i}_{wq|...}``.  ``layer_map`` entries override discovery (and are
    checked against ``names``).  Raises ValueError naming every candidate
    on ambiguity and the missing role otherwise.
    """
    roles = {}
    for name in names:
        m = _LAYER_RE.search(name)
        if m:
            role = "l%d_%s" % (int(m.group(1)), m.group(2))
        elif _EMBED_RE.search(name):
            role = "embed"
        elif _POS_RE.search(name):
            role = "pos"
        else:
            continue
        if role in roles:
            raise ValueError(
                "GluonCausalLMAdapter: role %r is ambiguous: both %r and "
                "%r match; pass layer_map={...} to pick one"
                % (role, roles[role], name))
        roles[role] = name
    if layer_map:
        known = set(names)
        for role, name in layer_map.items():
            if name not in known:
                raise ValueError(
                    "GluonCausalLMAdapter: layer_map maps role %r to %r, "
                    "which is not among the block's parameters"
                    % (role, name))
            roles[role] = name
    for role in ("embed", "pos"):
        if role not in roles:
            raise ValueError(
                "GluonCausalLMAdapter: no parameter matches role %r "
                "(expected a name ending in %r_weight); found %r"
                % (role, role, sorted(names)))
    return roles


class GluonCausalLMAdapter:
    """Serve a Gluon causal LM through the paged-KV decode contract."""

    # dense roles live in Gluon's [units, in] layout (the transpose of the
    # contract's [in, units])
    param_layout = "gluon"

    def __init__(self, block, num_heads, eos_id=None, layer_map=None):
        params = {name: p for name, p in block.collect_params().items()}
        roles = discover_roles(list(params), layer_map)

        layers = set()
        for role in roles:
            m = re.match(r"l(\d+)_", role)
            if m:
                layers.add(int(m.group(1)))
        num_layers = (max(layers) + 1) if layers else 0
        if not num_layers:
            raise ValueError(
                "GluonCausalLMAdapter: no l{i}_{wq|wk|wv|wo|w1|w2}_weight "
                "layer parameters found; found %r" % (sorted(params),))
        for l in range(num_layers):
            for r in DENSE_ROLES:
                if "l%d_%s" % (l, r) not in roles:
                    raise ValueError(
                        "GluonCausalLMAdapter: layer %d is missing role %r "
                        "(layers must be contiguous and complete; found %r)"
                        % (l, r, sorted(roles)))

        self._role_params = {role: params[name]
                             for role, name in roles.items()}
        self.role_names = dict(roles)

        embed = self._role_params["embed"]._check_and_get()
        pos = self._role_params["pos"]._check_and_get()
        if len(embed.shape) != 2 or len(pos.shape) != 2:
            raise ValueError(
                "GluonCausalLMAdapter: embed %r / pos %r must be rank-2 "
                "[vocab, hidden] / [max_len, hidden]"
                % (embed.shape, pos.shape))
        vocab_size, hidden = embed.shape
        if pos.shape[1] != hidden:
            raise ValueError(
                "GluonCausalLMAdapter: pos hidden size %d does not match "
                "embed hidden size %d" % (pos.shape[1], hidden))
        if hidden % int(num_heads):
            raise ValueError(
                "GluonCausalLMAdapter: hidden size %d is not divisible by "
                "num_heads %d" % (hidden, int(num_heads)))
        ff = None
        for l in range(num_layers):
            for r in ("wq", "wk", "wv", "wo"):
                shp = self._role_params["l%d_%s" % (l, r)]._check_and_get(
                ).shape
                if tuple(shp) != (hidden, hidden):
                    raise ValueError(
                        "GluonCausalLMAdapter: l%d_%s has shape %r, want "
                        "[hidden, hidden] = %r"
                        % (l, r, tuple(shp), (hidden, hidden)))
            w1 = self._role_params["l%d_w1" % l]._check_and_get().shape
            w2 = self._role_params["l%d_w2" % l]._check_and_get().shape
            if len(w1) != 2 or w1[1] != hidden:
                raise ValueError(
                    "GluonCausalLMAdapter: l%d_w1 has shape %r, want the "
                    "Gluon [ff, hidden] layout with hidden=%d"
                    % (l, tuple(w1), hidden))
            if ff is None:
                ff = w1[0]
            if tuple(w1) != (ff, hidden) or tuple(w2) != (hidden, ff):
                raise ValueError(
                    "GluonCausalLMAdapter: layer %d MLP shapes w1=%r w2=%r "
                    "are inconsistent with ff width %d"
                    % (l, tuple(w1), tuple(w2), ff))

        self.vocab_size = int(vocab_size)
        self.hidden = int(hidden)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = self.hidden // self.num_heads
        self.max_len = int(pos.shape[0])
        self.ff = int(ff)
        self.eos_id = eos_id
        self.device = embed.device
        # function skeleton: TinyCausalLM's fns read only geometry attrs
        # and the param dict they are handed, so a no-__init__ instance IS
        # the proven suite over the adapted weights
        kern = TinyCausalLM.__new__(TinyCausalLM)
        kern.vocab_size = self.vocab_size
        kern.hidden = self.hidden
        kern.num_layers = self.num_layers
        kern.num_heads = self.num_heads
        kern.head_dim = self.head_dim
        kern.max_len = self.max_len
        kern.eos_id = eos_id
        kern.context_attention = None
        kern._params = {}
        self._kern = kern

    # -- contract surface ------------------------------------------------
    def param_dict(self):
        """Live Gluon parameter storage, keyed by role."""
        return {role: p._check_and_get()
                for role, p in self._role_params.items()}

    def _contract(self, p):
        """Adapt Gluon-layout weights to the contract layout inside the
        forward: Dense weights are ``[units, in]`` (y = x @ W.T), the
        contract functions compute ``x @ W`` — hand them the transposed
        view, which the matmul reads as it lies."""
        out = {"embed": p["embed"], "pos": p["pos"]}
        for l in range(self.num_layers):
            for r in DENSE_ROLES:
                key = "l%d_%s" % (l, r)
                out[key] = p[key].T
        return out

    def prefill_fn(self, p, tokens, length, table, k_pool, v_pool):
        return self._kern.prefill_fn(self._contract(p), tokens, length,
                                     table, k_pool, v_pool)

    def decode_fn(self, p, tokens, positions, tables, k_pool, v_pool):
        return self._kern.decode_fn(self._contract(p), tokens, positions,
                                    tables, k_pool, v_pool)

    def chunk_prefill_fn(self, p, tokens, start, length, table, k_pool,
                         v_pool):
        return self._kern.chunk_prefill_fn(self._contract(p), tokens, start,
                                           length, table, k_pool, v_pool)

    def verify_fn(self, p, tokens, positions, valids, tables, k_pool,
                  v_pool):
        return self._kern.verify_fn(self._contract(p), tokens, positions,
                                    valids, tables, k_pool, v_pool)

    def propose_fn(self, p, tokens, positions, tables, k_pool, v_pool,
                   num_tokens):
        return self._kern.propose_fn(self._contract(p), tokens, positions,
                                     tables, k_pool, v_pool, num_tokens)

    def partition_specs(self):
        raise NotImplementedError(
            "weight sharding needs serving.decode.sharding, which is not "
            "ported yet")


# ---------------------------------------------------------------------------
# demo block
# ---------------------------------------------------------------------------

class TinyGluonLM(HybridBlock):
    """The ``TinyCausalLM`` architecture as a HybridBlock.

    Forward maps tokens ``[B, T]`` to logits ``[B, T, V]``.  Parameters
    carry the adapter's role names (Dense layout ``[units, in]``, created
    at their full shapes, so ``copy_reference_weights`` can fill them
    without ``initialize``).  The batch forward masks with -1e30 (exp
    underflows to exact zero after the max-shift), as the JAX package's
    does — serving exactness comes from the adapter's paged functions, not
    this forward.
    """

    def __init__(self, vocab_size=48, hidden=32, num_layers=2, num_heads=2,
                 max_len=128, prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        if hidden % num_heads:
            raise ValueError("hidden must divide into num_heads")
        self._device = resolve_device(device)
        self._vocab = int(vocab_size)
        self._hidden = int(hidden)
        self._layers = int(num_layers)
        self._heads = int(num_heads)
        self._max_len = int(max_len)
        shapes = {"embed_weight": (self._vocab, self._hidden),
                  "pos_weight": (self._max_len, self._hidden)}
        for l in range(self._layers):
            for r in ("wq", "wk", "wv", "wo"):
                shapes["l%d_%s_weight" % (l, r)] = (self._hidden,
                                                    self._hidden)
            shapes["l%d_w1_weight" % l] = (2 * self._hidden, self._hidden)
            shapes["l%d_w2_weight" % l] = (self._hidden, 2 * self._hidden)
        for name, shape in shapes.items():
            setattr(self, name, self.params.get(name, shape=shape))

    def forward(self, tokens):
        H, nh = self._hidden, self._heads
        d = H // nh
        B, T = tokens.shape
        w = {n: getattr(self, n) for n in self._reg_params}
        h = F.embedding(tokens.long(), w["embed_weight"]) \
            + w["pos_weight"][:T]                                # [B, T, H]
        ar = torch.arange(T, device=h.device)
        # attend where query position i >= key position j
        attend = (ar[:, None] >= ar[None, :]).to(h.dtype)
        negmask = (attend - 1.0) * 1e30                          # [T, T]
        for l in range(self._layers):
            x = _rms(h)
            q, k, v = (F.linear(x, w["l%d_%s_weight" % (l, r)]).reshape(
                B, T, nh, d).transpose(1, 2) for r in ("wq", "wk", "wv"))
            scores = q @ k.transpose(-1, -2) / float(d) ** 0.5
            att = torch.softmax(scores + negmask, dim=-1) @ v   # [B,nh,T,d]
            att = att.transpose(1, 2).reshape(B, T, H)
            h = h + F.linear(att, w["l%d_wo_weight" % l])
            g = F.linear(_rms(h), w["l%d_w1_weight" % l])
            h = h + F.linear(F.gelu(g, approximate="tanh"),
                             w["l%d_w2_weight" % l])
        return F.linear(_rms(h), w["embed_weight"])              # [B, T, V]


def copy_reference_weights(block, ref):
    """Load a ``TinyCausalLM``'s weights into a role-named Gluon block,
    transposing dense weights into the Gluon ``[units, in]`` layout.

    After this, ``GluonCausalLMAdapter(block, ref.num_heads)`` computes
    with value-identical arrays to ``ref`` (transpose of a transpose), so
    adapted serving reproduces the native model's streams exactly.
    """
    params = {name: p for name, p in block.collect_params().items()}
    roles = discover_roles(list(params))
    src = ref.param_dict()
    for role, name in roles.items():
        val = src[role]
        if role not in ("embed", "pos"):
            val = val.T
        params[name].set_data(val)
