"""Paged KV cache: a device-resident block pool + per-sequence page tables
(counterpart of ``mxnet_tpu/serving/decode/kv_cache.py``: the host ledger
is the same code, the pools are torch tensors).

The whole point of continuous batching collapses if KV memory is laid out
``[max_slots, max_len, ...]``: every slot then pays for the longest possible
sequence whether or not anything lives there, and the slot count — not the
token count — caps concurrency.  Instead the cache is a flat pool of
fixed-size **blocks** (``block_size`` tokens each), shared by every live
sequence, with a per-sequence **page table** mapping logical token index
``j`` to physical block ``table[j // block_size]``.  Memory then scales with
*live tokens*: a 3-token sequence next to a 100-token one holds 1 block, not
a max-length row.

Two-level accounting (all host-side, one lock):

* **reservation** — at admission the engine reserves the worst-case block
  count for the whole stream (``prompt + max_new`` tokens).  ``reserve()``
  refuses when the pool cannot cover every outstanding promise
  (``free + cached < reserved + n``) and the engine sheds the request with
  OVERLOADED — the "no blocks free" admission check.  Reserving up front
  means a sequence admitted once can ALWAYS grow: there is no mid-stream
  out-of-memory, no forced eviction of live pages, no deadlock between
  growing sequences.
* **allocation** — blocks are taken lazily (``grow()``), one at a time, as
  generation actually crosses block boundaries, so ``used`` tracks live
  tokens while the reservation only bounds the worst case.

Cross-request prefix sharing (copy-on-write) sits on top:

* every **full** prompt block registered via ``register_prefix`` gets a
  chain hash ``H_i = blake2b(H_{i-1} || tokens[(i-1)*bs : i*bs])`` — the
  chain encodes the ENTIRE preceding prompt, so a hash match means the
  block's K/V is a pure function of the same token prefix and (because
  chunked prefill reads earlier positions through the page table rather
  than recomputing them) bitwise-valid for any request sharing that
  prefix.  A partial tail block is registered under a **full-prompt** key
  ``(H_F, tail tokens)`` — exact-match only, so a non-block-aligned
  shared prefix can never hit (the hash-collision-on-partial-prefix miss
  the tests pin down).
* ``reserve(..., prompt=, align_tokens=)`` walks the chain, **attaches**
  the longest registered prefix (refcount +1 per sequence per block) and
  reserves only the blocks the sequence might still write — everything
  from the first recomputed chunk onward, so a later copy-on-write fork
  can never run out of memory mid-stream.
* blocks are **refcounted**: ``writable()`` returns the physical block for
  a logical index, forking it first (new private block, caller copies the
  device pages) when the refcount is > 1.  Refcount 1 writes in place —
  registered content below the registered length is append-only-immutable
  so the hash stays valid.
* when a sequence frees, each table entry is decref'd; registered blocks
  whose refcount hits zero are parked in an LRU **cached** pool (contents
  intact, attachable by future requests) and only evicted — registry
  entries dropped, block returned to the free list — when an allocation
  finds the free list empty.  Eviction draws from the cached pool ONLY,
  so a block with live references is never reclaimed.

``allocated_total``/``freed_total`` count per-sequence attach/detach
(attach = +1 allocated, detach = +1 freed, fork = detach old + attach new),
so the tier-1 leak gate ``allocated_total == freed_total`` keeps meaning
"no table retains pages" even when pages are shared.

Block 0 is the **trash block**: dead decode slots in the fixed-shape step
still execute and still scatter their (garbage) K/V somewhere — they all
point at block 0, which is never allocated to a sequence, so a dead slot can
never contaminate a live stream's pages.

The device half (``init_pools``) is a pair of zeros tensors
``[num_layers, num_blocks, block_size, num_heads, head_dim]`` for K and V.
The engine binds each pair to its CachedOps, whose captured graphs write
the pages in place; this object never holds them, so the accounting lock
is never held across a step.  Thread-safe: every mutable field is guarded
by ``_lock``.

Every accounting increment mirrors into the process-wide byte accountant
(``mxnet_tpu_torch.memory_accounting``) under the cache's
``account_region`` label (default: a unique ``"kv:N"``): attach/grow/
CoW-attach record ``block_bytes`` allocated, detach/free record it freed,
so the region's totals track ``stats()``'s allocated/freed counts.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

from ...base import MXNetError

__all__ = ["PagedKVCache", "ReserveResult"]

# the JAX package's seed: the same prompt hashes to the same chain keys
_CHAIN_SEED = b"mxnet-tpu-kv-prefix-v1"

_REGION_LOCK = threading.Lock()
_REGION_IDS = 0


def _next_account_region():
    """Unique default byte-accountant region label for a new cache."""
    global _REGION_IDS
    with _REGION_LOCK:
        _REGION_IDS += 1
        return "kv:%d" % _REGION_IDS


class ReserveResult:
    """Truthy result of a successful ``reserve`` with a prompt attached.

    ``prefix_tokens`` — prompt positions already materialized in attached
    shared pages; chunked prefill starts there (always a chunk boundary,
    always < len(prompt) so the engine recomputes at least the last chunk
    and owns first-token logits).  ``shared_blocks`` — number of attached
    shared pages.  ``full_hit`` — the entire prompt (including a partial
    tail block) matched; the recomputed last chunk then writes into shared
    pages and triggers copy-on-write forks while other holders are live.
    """

    __slots__ = ("prefix_tokens", "shared_blocks", "full_hit")

    def __init__(self, prefix_tokens=0, shared_blocks=0, full_hit=False):
        self.prefix_tokens = int(prefix_tokens)
        self.shared_blocks = int(shared_blocks)
        self.full_hit = bool(full_hit)

    def __bool__(self):
        return True

    def __repr__(self):
        return ("ReserveResult(prefix_tokens=%d, shared_blocks=%d, "
                "full_hit=%s)" % (self.prefix_tokens, self.shared_blocks,
                                  self.full_hit))


class PagedKVCache:
    def __init__(self, num_layers, num_blocks, block_size, num_heads,
                 head_dim, dtype="float32", account_region=None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the trash block)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        import numpy as np
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        # one logical block = a K page + a V page across every layer
        self.block_bytes = (2 * self.num_layers * self.block_size
                            * self.num_heads * self.head_dim
                            * np.dtype(dtype).itemsize)
        self.account_region = (str(account_region) if account_region
                               else _next_account_region())
        # re-entrant: the allocation helpers below guard themselves, and
        # the public operations call them with the lock already held
        self._lock = threading.RLock()
        # LIFO free list over allocatable ids 1..num_blocks-1 (0 = trash)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._tables = {}        # seq_id -> [block ids, logical order]
        self._reservations = {}  # seq_id -> blocks promised but not taken
        self._reserved = 0       # sum of _reservations values
        self._ref = {}           # block id -> live table references
        self._registry = {}      # chain/full key -> block id
        self._block_keys = {}    # block id -> [registry keys]
        self._cached = OrderedDict()  # ref==0 registered blocks, LRU order
        self._allocated_total = 0
        self._freed_total = 0
        self._peak_used = 0
        self._prefix_hits = 0
        self._prefix_blocks_shared = 0
        self._cow_forks = 0
        self._evictions = 0

    # -- device half ----------------------------------------------------
    def pool_shape(self):
        return (self.num_layers, self.num_blocks, self.block_size,
                self.num_heads, self.head_dim)

    def init_pools(self, device):
        """Fresh zeroed (k_pool, v_pool) tensor pair on ``device``."""
        import torch
        from ...base import as_dtype
        shape = self.pool_shape()
        dtype = as_dtype(self.dtype)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    # -- host accounting ------------------------------------------------
    def blocks_for_tokens(self, n_tokens):
        """Blocks covering ``n_tokens`` logical positions."""
        return max(1, -(-int(n_tokens) // self.block_size))

    def _chain_hashes(self, prompt):
        """Chain hash after each full block of ``prompt`` (list of F
        digests) plus the trailing partial-block tokens."""
        bs = self.block_size
        full = len(prompt) // bs
        h = hashlib.blake2b(_CHAIN_SEED, digest_size=16).digest()
        out = []
        for i in range(full):
            block = bytes(bytearray(
                b for t in prompt[i * bs:(i + 1) * bs]
                for b in int(t).to_bytes(4, "little", signed=False)))
            h = hashlib.blake2b(h + block, digest_size=16).digest()
            out.append(h)
        tail = tuple(int(t) for t in prompt[full * bs:])
        return out, tail

    def _account_alloc(self, nblocks=1):
        """Mirror ``nblocks`` page attachments into the byte accountant."""
        from ... import memory_accounting
        memory_accounting.record_alloc(self.block_bytes * nblocks,
                                       self.account_region, count=nblocks)

    def _account_free(self, nblocks=1):
        """Mirror ``nblocks`` page detachments into the byte accountant."""
        from ... import memory_accounting
        memory_accounting.record_free(self.block_bytes * nblocks,
                                      self.account_region, count=nblocks)

    def _take_block_locked(self):
        """Pop a free block, evicting the LRU cached block if none free.
        Eviction only ever touches the ref==0 cached pool, so shared pages
        (refcount >= 1) are never reclaimed."""
        with self._lock:
            if self._free:
                return self._free.pop()
            if not self._cached:
                raise MXNetError(
                    "KV pool exhausted (no free or cached blocks)")
            block, _ = self._cached.popitem(last=False)
            for key in self._block_keys.pop(block, ()):
                self._registry.pop(key, None)
            self._evictions += 1
            return block

    def _attach_locked(self, seq_id, block):
        """Add ``block`` to ``seq_id``'s table, incref, pull from cached."""
        with self._lock:
            ref = self._ref.get(block, 0)
            if ref == 0:
                self._cached.pop(block, None)
            self._ref[block] = ref + 1
            self._tables.setdefault(seq_id, []).append(block)
            self._allocated_total += 1
            self._account_alloc()

    def _used_locked(self):
        with self._lock:
            return ((self.num_blocks - 1) - len(self._free)
                    - len(self._cached))

    def _note_peak_locked(self):
        used = self._used_locked()
        if used > self._peak_used:
            self._peak_used = used

    def reserve(self, seq_id, n_blocks, prompt=None, align_tokens=None):
        """Promise ``n_blocks`` to ``seq_id``; False when the pool cannot
        honor every outstanding promise (the admission shed signal).

        With ``prompt`` (token id sequence) and ``align_tokens`` (the
        engine's chunk size, a multiple of ``block_size``), the call also
        attaches the longest registered shared prefix and returns a
        truthy :class:`ReserveResult` describing the hit; the reservation
        then covers only the writable region (first recomputed chunk
        onward) so shared pages cost no headroom but every potential
        copy-on-write fork is still guaranteed a block."""
        n_blocks = int(n_blocks)
        with self._lock:
            if seq_id in self._reservations or seq_id in self._tables:
                raise MXNetError("sequence %r already holds KV state"
                                 % (seq_id,))
            attach = []
            prefix_tokens = 0
            full_hit = False
            if prompt is not None and len(prompt) > 0:
                bs = self.block_size
                align = int(align_tokens or bs)
                L = len(prompt)
                hashes, tail = self._chain_hashes(prompt)
                matched = []
                for h in hashes:
                    b = self._registry.get(("blk", h))
                    if b is None:
                        break
                    matched.append(b)
                m = len(matched)
                last_chunk = ((L - 1) // align) * align
                if m == len(hashes):
                    tail_block = None
                    if tail:
                        tail_block = self._registry.get(
                            ("full", hashes[-1] if hashes else b"", tail))
                    if tail and tail_block is not None:
                        full_hit = True
                        attach = matched + [tail_block]
                        prefix_tokens = last_chunk
                    elif not tail and m > 0:
                        full_hit = True
                        attach = matched
                        prefix_tokens = last_chunk
                if not full_hit and m > 0:
                    t = min((m * bs // align) * align, last_chunk)
                    prefix_tokens = t
                    attach = matched[:t // bs]
            # reservation covers every block from the first recomputed
            # position onward: private growth AND forks of attached pages
            need = max(0, n_blocks - prefix_tokens // self.block_size)
            if len(self._free) + len(self._cached) - self._reserved < need:
                return False
            for b in attach:
                self._attach_locked(seq_id, b)
            self._reservations[seq_id] = need
            self._reserved += need
            self._note_peak_locked()
            if attach:
                self._prefix_hits += 1
                self._prefix_blocks_shared += len(attach)
            if prompt is not None:
                return ReserveResult(prefix_tokens, len(attach), full_hit)
            return True

    def grow(self, seq_id):
        """Convert one reserved block into an allocated page; returns the
        block id (appended to the sequence's page table)."""
        with self._lock:
            remaining = self._reservations.get(seq_id, 0)
            if remaining < 1:
                raise MXNetError("sequence %r grew past its reservation"
                                 % (seq_id,))
            block = self._take_block_locked()
            self._reservations[seq_id] = remaining - 1
            self._reserved -= 1
            self._tables.setdefault(seq_id, []).append(block)
            self._ref[block] = 1
            self._allocated_total += 1
            self._account_alloc()
            self._note_peak_locked()
            return block

    def ensure_capacity(self, seq_id, n_tokens):
        """Grow ``seq_id`` until its table covers ``n_tokens`` positions."""
        need = self.blocks_for_tokens(n_tokens)
        with self._lock:
            have = len(self._tables.get(seq_id, ()))
        while have < need:
            self.grow(seq_id)
            have += 1

    def writable(self, seq_id, logical_idx):
        """Physical block for ``seq_id``'s logical index, copy-on-write.

        Refcount 1: returns ``(block, None)`` — write in place.  Shared
        (refcount > 1): allocates a private replacement from the
        sequence's reservation, swaps the table entry, and returns
        ``(new_block, old_block)`` — the caller must copy the device
        pages ``old -> new`` before writing."""
        logical_idx = int(logical_idx)
        with self._lock:
            table = self._tables.get(seq_id)
            if table is None or logical_idx >= len(table):
                raise MXNetError("sequence %r has no block at index %d"
                                 % (seq_id, logical_idx))
            block = table[logical_idx]
            if self._ref.get(block, 0) <= 1:
                return block, None
            remaining = self._reservations.get(seq_id, 0)
            if remaining < 1:
                raise MXNetError("sequence %r fork exceeds its reservation"
                                 % (seq_id,))
            new = self._take_block_locked()
            self._reservations[seq_id] = remaining - 1
            self._reserved -= 1
            table[logical_idx] = new
            self._ref[block] -= 1
            self._ref[new] = 1
            self._freed_total += 1       # detached the shared page
            self._account_free()
            self._allocated_total += 1   # attached the private copy
            self._account_alloc()
            self._cow_forks += 1
            self._note_peak_locked()
            return new, block

    def register_prefix(self, seq_id, prompt):
        """Publish ``seq_id``'s prompt pages for cross-request reuse.

        Called once prefill has materialized the prompt's K/V.  Each full
        block gains a chain-hash entry (first writer wins — a duplicate
        recompute keeps its private pages unregistered); a partial tail
        block gains an exact-match full-prompt entry."""
        if prompt is None or len(prompt) == 0:
            return 0
        bs = self.block_size
        hashes, tail = self._chain_hashes(prompt)
        registered = 0
        with self._lock:
            table = self._tables.get(seq_id)
            if table is None:
                raise MXNetError("sequence %r holds no pages to register"
                                 % (seq_id,))
            for i, h in enumerate(hashes):
                key = ("blk", h)
                if key in self._registry:
                    continue
                block = table[i]
                self._registry[key] = block
                self._block_keys.setdefault(block, []).append(key)
                registered += 1
            if tail and hashes:
                key = ("full", hashes[-1], tail)
                block = table[len(hashes)]
                if key not in self._registry:
                    self._registry[key] = block
                    self._block_keys.setdefault(block, []).append(key)
                    registered += 1
        return registered

    def release(self, seq_id):
        """Drop the unconverted remainder of a reservation (request never
        joined, or finished early)."""
        with self._lock:
            self._reserved -= self._reservations.pop(seq_id, 0)

    def free_seq(self, seq_id):
        """Detach every block of ``seq_id`` and drop any remaining
        reservation; returns the number of blocks detached.  A block whose
        refcount drops to zero returns to the free list — unless it is
        registered for prefix reuse, in which case it parks in the cached
        pool (contents intact) until attached again or evicted."""
        with self._lock:
            blocks = self._tables.pop(seq_id, [])
            for block in reversed(blocks):
                ref = self._ref.get(block, 0) - 1
                if ref > 0:
                    self._ref[block] = ref
                    continue
                self._ref.pop(block, None)
                if self._block_keys.get(block):
                    self._cached[block] = True   # MRU end
                else:
                    self._free.append(block)
            self._freed_total += len(blocks)
            if blocks:
                self._account_free(len(blocks))
            self._reserved -= self._reservations.pop(seq_id, 0)
            return len(blocks)

    def blocks_of(self, seq_id):
        """The sequence's allocated page table, unpadded (the exact block
        ids holding its K/V, logical order) — what ``export_stream`` copies."""
        with self._lock:
            return list(self._tables.get(seq_id, ()))

    def ref_count(self, block):
        """Live table references to ``block`` (0 = free or cached)."""
        with self._lock:
            return self._ref.get(int(block), 0)

    def table(self, seq_id, width):
        """The sequence's page table padded to ``width`` entries with the
        trash block (0); entries past the live length are never unmasked."""
        with self._lock:
            blocks = list(self._tables.get(seq_id, ()))
        if len(blocks) > width:
            raise MXNetError("page table of %r (%d blocks) exceeds width %d"
                             % (seq_id, len(blocks), width))
        return blocks + [0] * (width - len(blocks))

    def used(self):
        """Blocks held by at least one live table (each counted once)."""
        with self._lock:
            return self._used_locked()

    def available_unreserved(self):
        """Blocks neither held by a table nor promised (the admission
        signal): free + evictable-cached - reserved.  Shared pages are
        held once no matter how many sequences reference them, so fleet
        headroom counts them once."""
        with self._lock:
            return len(self._free) + len(self._cached) - self._reserved

    def capacity(self):
        """Total allocatable blocks (trash block excluded)."""
        return self.num_blocks - 1

    def stats(self):
        with self._lock:
            shared_now = sum(1 for r in self._ref.values() if r > 1)
            return {
                "num_blocks": self.num_blocks - 1,   # allocatable
                "block_size": self.block_size,
                "block_bytes": self.block_bytes,
                "used": self._used_locked(),
                "free": len(self._free),
                "reserved": self._reserved,
                "live_sequences": len(self._tables),
                "allocated_total": self._allocated_total,
                "freed_total": self._freed_total,
                "peak_used": self._peak_used,
                "prefix_hits": self._prefix_hits,
                "prefix_blocks_shared": self._prefix_blocks_shared,
                "cow_forks": self._cow_forks,
                "cached_blocks": len(self._cached),
                "shared_blocks_now": shared_now,
                "evictions": self._evictions,
            }
