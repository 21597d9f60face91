"""DecodeEngine: continuous batching for autoregressive generation
(counterpart of ``mxnet_tpu/serving/decode/engine.py``: the scheduler, the
admission and the stream machinery are the same code; what runs on the
card is a set of ``CachedOp``\\s bound to the engine's K/V pools).

The MicroBatcher (batcher.py) batches at *request* granularity — right for
one-shot inference, wrong for generation, where requests are hundreds of
decode steps long and finish at different times: request-level batching
leaves slots idle from each sequence's last token until the batch's last.
This engine schedules at **iteration** granularity: every decode step,
finished sequences leave their slot and queued requests join, so the
fixed-shape step stays as full as admission allows.

Fixed shapes, zero captures after warmup (the CachedOp contract: one CUDA
graph per input signature):

* the decode step is always ``[max_slots]`` wide — join/leave changes slot
  *contents*, never the signature; dead slots compute garbage against the
  trash block and are masked host-side;
* the attention width (page-table columns) is bucketed: the scheduler picks
  the smallest warmed width covering the longest live sequence, so
  signatures = width buckets, all captured at load;
* prefill runs separately through a prompt-length bucket ladder
  (``buckets.BucketLadder``) — one ``[1, Lb]`` causal pass per joining
  request that fills its KV pages and yields the first token (the TTFT
  token), keeping long-prompt compute out of the per-token step.

The pools are state, not values.  The JAX package threads new pools
through every call; here each ``CachedOp``'s parameter dict holds the
model's tensors and one pair of pools, which its captured graphs read and
write in place, as they do a block's aux state.  A replayed decode step
therefore copies no pool: it copies its token, position and table inputs
in and its logits out.  The engine makes two pool sets: the live pair (and
the draft's), bound to the ops the worker replays and warmed by
``warmup()`` — whose inputs are all-zero tables, so it writes only the
trash block — and ``generate_reference``'s private pair, bound to its own
ops at its first call and zeroed at every call.  Page copies outside a
step (``_cow_pages``, ``import_stream``'s restore) run in place on the
worker thread's stream, ordered with its replays; ``export_stream`` reads
pages to host numpy after the parked worker synchronized its stream.

KV memory is a paged block pool (kv_cache.py): admission reserves the
worst-case block count (shedding OVERLOADED when the pool cannot honor
it), blocks are allocated lazily as sequences grow and freed the moment a
sequence finishes.

Four opt-in throughput multipliers stack on that core (each off by
default, leaving the base engine bit-identical):

* ``prefill_chunk=C`` — prompts prefill in fixed ``[1, C]`` chunks, ONE
  chunk per scheduler iteration, interleaved with decode steps: a long
  prompt no longer stalls live streams' TTFT.  One chunk signature
  replaces the prompt bucket ladder, and ``generate_reference`` chunks
  identically.
* ``prefix_cache=True`` (requires ``prefill_chunk``) — ``reserve()``
  attaches the longest registered shared prompt prefix (kv_cache.py chain
  hashes), prefill skips straight to the first unshared chunk, and writes
  into shared pages copy-on-write fork first (device pages copied, table
  entry swapped).  A shared system prompt costs one prefill.
* ``temperature``/``top_k``/``top_p``/``seed`` on ``submit()`` — seeded
  host-side sampling (sampling.py): greedy stays the default and sampled
  streams replay exactly (same seed => same tokens) across restarts and
  handoffs.
* ``spec_k=K, draft_model=...`` (requires ``prefill_chunk``) — a draft
  model proposes K greedy tokens in one unrolled call, ONE paged verify
  step scores K+1 positions, and the engine commits the longest agreeing
  prefix: up to K+1 tokens for two dispatches.  Emitted tokens depend
  only on the *target* logits chain, so speculative greedy output is
  bitwise-equal to the sequential reference no matter what the draft
  proposes.

``prefill_only=True`` (requires ``prefill_chunk``, excludes speculation)
turns the engine into the prefill tier of a disaggregated deployment: it
runs chunked prefill, emits the TTFT token, and then hands the stream off
through the sink installed with :meth:`set_handoff` (the same snapshot
dict ``export_stream`` produces: K/V pages, cursor, sampler state).

Every request is a :class:`DecodeStream` — tokens stream out as they are
produced (iterator and/or ``on_token`` callback), and the terminal state
is a status, never an exception: the same vocabulary as server.py
(OK / TIMEOUT / OVERLOADED / INVALID_INPUT / ERROR / UNAVAILABLE), with
the deadline, bounded-admission, and circuit-breaker machinery
(health.py) applied per-stream.

Not ported yet: a model sharded over a mesh (``sharding.py``).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np
import torch

from ... import autograd
from ... import faults
from ... import util
from ...base import MXNetError
from ...cached_op import CachedOp
from ...context import resolve_device
from ..buckets import BucketLadder
from ..health import CircuitBreaker, PROBE, REJECT
from ..server import (OK, TIMEOUT, OVERLOADED, INVALID_INPUT, ERROR,
                      UNAVAILABLE)
from .kv_cache import PagedKVCache
from .sampling import SamplingParams, StreamSampler
from .stats import DecodeStats

__all__ = ["DecodeEngine", "DecodeStream"]

# transient-retry envelope around one prefill/decode execution, matching
# ServableModel's policy
_EXEC_ATTEMPTS = 3
_EXEC_BACKOFF_S = 0.002

# the pools' names in a bound op's parameter dict
_K_POOL, _V_POOL = "__k_pool", "__v_pool"


class DecodeStream:
    """One autoregressive request: async handle + incremental token stream.

    Tokens arrive via :meth:`tokens` / iteration / the ``on_token``
    callback as the engine produces them; ``wait()`` blocks until the
    terminal status is set.  Because a stream is incremental, a TIMEOUT
    or UNAVAILABLE terminal keeps the tokens already emitted — the status
    says why the stream *ended*, not that its prefix is invalid.
    """

    def __init__(self, prompt, max_new_tokens, deadline=None, stats=None,
                 on_token=None, sampling=None):
        self.prompt = prompt                 # int32 numpy copy
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline             # monotonic seconds or None
        self.stats = stats                   # engine DecodeStats handle
        self.sampling = sampling             # SamplingParams or None=greedy
        self.seq_id = None                   # assigned at submission
        self.admitted = False
        self.t_submit = time.monotonic()
        self._on_token = on_token
        self._cond = threading.Condition()
        self._tokens = []
        self._owner = None          # fencing token; None = unfenced
        self._on_terminal = None    # router hook, fired once off-lock
        self.status = None
        self.error = None
        self.ttft_ms = None
        self.latency_ms = None

    def expired(self, now=None):
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                >= self.deadline)

    # -- fencing ---------------------------------------------------------
    def set_owner(self, token):
        """Install the fencing token (router: ``(rid, lease_generation)``).
        Emissions and owner-checked completions presenting a different
        token are refused — the zombie-replica double-emit guard."""
        with self._cond:
            self._owner = token

    def owner(self):
        with self._cond:
            return self._owner

    def on_terminal(self, cb):
        """Register a one-shot terminal hook ``cb(stream)``; fires off-lock
        right after the winning ``complete()`` — or immediately, if the
        stream is already terminal (registration/completion race-safe)."""
        with self._cond:
            if self.status is None:
                self._on_terminal = cb
                return
        cb(self)

    # -- engine side ----------------------------------------------------
    def _emit(self, token, owner=None):
        with self._cond:
            if self.status is not None:
                return          # terminal already claimed; drop the token
            if self._owner is not None and owner != self._owner:
                return          # fenced: only the owning engine may emit
            if self.ttft_ms is None:
                self.ttft_ms = (time.monotonic() - self.t_submit) * 1e3
            self._tokens.append(int(token))
            self._cond.notify_all()
        cb = self._on_token
        if cb is not None:
            # outside the lock: user code must not block token delivery or
            # nest our cond; a raising callback is disabled (the stream
            # keeps generating — delivery is best-effort, wait()/tokens()
            # stay authoritative)
            try:
                cb(int(token))
            except Exception:
                self._on_token = None

    def complete(self, status, error=None, owner=None):
        """First completion wins (engine finish vs teardown vs expiry).

        An *owner-checked* completion (``owner`` non-None on a fenced
        stream) is refused on mismatch — a stale engine draining after a
        handoff cannot terminate the stream out from under its new home.
        ``owner=None`` always passes: unfenced callers (direct engine use,
        client-side cancels) predate fencing and stay valid."""
        cb = None
        with self._cond:
            if self.status is not None:
                return False
            if (self._owner is not None and owner is not None
                    and owner != self._owner):
                return False    # fenced: a non-owner may not terminate
            self.error = error
            self.latency_ms = (time.monotonic() - self.t_submit) * 1e3
            # status last: it is the done flag every reader keys on
            self.status = status
            self._cond.notify_all()
            cb = self._on_terminal
            self._on_terminal = None
        if cb is not None:
            # off-lock, like on_token: the router's hook takes its own
            # lock and must never nest inside the stream's cond
            try:
                cb(self)
            except Exception:
                pass
        return True

    # -- client side ----------------------------------------------------
    def tokens(self):
        """Snapshot of the tokens emitted so far."""
        with self._cond:
            return list(self._tokens)

    def wait(self, timeout=None):
        """Block until terminal; returns True when a status is set."""
        with self._cond:
            return self._cond.wait_for(lambda: self.status is not None,
                                       timeout)

    def result(self):
        """Wait the stream out and return it (fluent blocking read)."""
        self.wait()
        return self

    def snapshot(self):
        """Atomic (status, tokens, ttft_ms, latency_ms, error)."""
        with self._cond:
            return (self.status, tuple(self._tokens), self.ttft_ms,
                    self.latency_ms, self.error)

    def __iter__(self):
        """Yield tokens as they arrive; stops when the stream is terminal
        and drained.  Check ``status`` afterwards for why it ended."""
        i = 0
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: len(self._tokens) > i or self.status is not None)
                if len(self._tokens) <= i:
                    return
                tok = self._tokens[i]
            i += 1
            yield tok

    def __repr__(self):
        status, toks, ttft, lat, err = self.snapshot()
        return ("DecodeStream(status=%s, tokens=%d%s%s)"
                % (status, len(toks),
                   ", ttft_ms=%.2f" % ttft if ttft is not None else "",
                   ", error=%r" % err if err else ""))


class _QEntry:
    """One queued admission: the stream, its fencing token, and — for
    streams entering via ``import_stream`` — the KV snapshot to restore
    at join instead of running a prefill."""

    __slots__ = ("stream", "gen", "snap")

    def __init__(self, stream, gen=None, snap=None):
        self.stream = stream
        self.gen = gen
        self.snap = snap


class _Seq:
    """Engine-private per-slot state for one live sequence."""

    __slots__ = ("stream", "seq_id", "position", "cur_token", "generated",
                 "gen", "snap", "prefill_pos", "sampler")

    def __init__(self, stream, gen=None, snap=None):
        self.stream = stream
        self.seq_id = stream.seq_id
        self.position = 0       # cache index the next K/V write lands at
        self.cur_token = 0      # last emitted token (next step's input)
        self.generated = 0
        self.gen = gen          # fencing token presented on emit/complete
        self.snap = snap        # pending import restore, cleared at resume
        self.prefill_pos = None  # next prompt position to chunk-prefill
        self.sampler = None     # StreamSampler when the stream samples



class _BoundOps:
    """The engine's CachedOps bound to one set of K/V pools.

    Each op's parameter dict holds the model's tensors and the pools, so a
    captured graph reads and writes the pools where they lie: a step moves
    no copy of a pool.  The pools therefore stay the same tensors for the
    ops' life (a CachedOp drops its captures when a parameter's storage
    changes)."""

    def __init__(self, engine, pools, dpools=None):
        self.pools = pools
        self.dpools = dpools
        self.params = dict(engine._params)
        self.params[_K_POOL], self.params[_V_POOL] = pools
        self.prefill = CachedOp(engine._prefill_forward, self.params)
        self.decode = CachedOp(engine._decode_forward, self.params)
        self.chunk = self.verify = self.draft = self.draft_chunk = None
        self.draft_params = None
        if engine.prefill_chunk is not None:
            self.chunk = CachedOp(engine._chunk_forward, self.params)
        if engine.spec_k > 0:
            self.verify = CachedOp(engine._verify_forward, self.params)
        if dpools is not None:
            self.draft_params = dict(engine._draft_params)
            self.draft_params[_K_POOL], self.draft_params[_V_POOL] = dpools
            self.draft = CachedOp(engine._draft_forward, self.draft_params)
            self.draft_chunk = CachedOp(engine._draft_chunk_forward,
                                        self.draft_params)

    def named_ops(self):
        """``(prefix, op)`` for every op, as ``cache_stats`` names them."""
        pairs = [("prefill", self.prefill), ("decode", self.decode)]
        if self.chunk is not None:
            pairs.append(("chunk", self.chunk))
        if self.verify is not None:
            pairs.append(("verify", self.verify))
        if self.draft is not None:
            pairs.extend([("draft", self.draft),
                          ("draft_chunk", self.draft_chunk)])
        return pairs


def _same_device(a, b):
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class DecodeEngine:
    """Continuous-batching decode loop over one decode-capable model.

    ``device`` defaults to the model's; the engine's pools, inputs and
    worker run there."""

    def __init__(self, model, name="decode", max_slots=8, block_size=8,
                 num_blocks=None, max_prompt_len=16, max_new_tokens=32,
                 max_queue=64, scheduling="continuous", width_blocks=None,
                 warmup=True, breaker_threshold=5, breaker_backoff_ms=50.0,
                 breaker_max_backoff_ms=2000.0, prefill_chunk=None,
                 prefix_cache=False, spec_k=0, draft_model=None,
                 prefill_only=False, generation=None, device=None):
        if scheduling not in ("continuous", "static"):
            raise ValueError("scheduling must be 'continuous' or 'static'")
        self.name = name
        self.model = model
        # weight generation tag: which checkpoint epoch this engine's
        # params came from.  None = untagged (standalone use).
        # import_stream refuses snapshots from a different generation — a
        # stream must finish against the weights it started on
        self.generation = generation
        self.scheduling = scheduling
        self.max_slots = int(max_slots)
        self.max_prompt_len = int(max_prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self._max_queue = int(max_queue)
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        self.prefix_cache = bool(prefix_cache)
        self.spec_k = int(spec_k)
        self.draft = draft_model
        self.prefill_only = bool(prefill_only)
        self._handoff_cb = None     # set_handoff sink (prefill_only)
        if self.prefill_only and self.prefill_chunk is None:
            raise ValueError("prefill_only requires prefill_chunk (the "
                             "prefill tier runs the chunked path)")
        if self.prefill_only and self.spec_k > 0:
            raise ValueError("prefill_only excludes speculative decoding "
                             "(no decode steps run on the prefill tier)")
        if self.prefill_chunk is not None:
            if self.prefill_chunk <= 0 \
                    or self.prefill_chunk % int(block_size):
                raise ValueError("prefill_chunk must be a positive multiple "
                                 "of block_size, got %r" % (prefill_chunk,))
        if self.prefix_cache and self.prefill_chunk is None:
            raise ValueError("prefix_cache requires prefill_chunk (shared "
                             "prefixes attach at chunk boundaries)")
        if (self.spec_k > 0) != (draft_model is not None):
            raise ValueError("speculative decoding needs both spec_k > 0 "
                             "and a draft_model")
        if self.spec_k > 0 and self.prefill_chunk is None:
            raise ValueError("speculative decoding requires prefill_chunk "
                             "(the draft prefills through the chunk path)")
        max_total = self.max_prompt_len + self.max_new_tokens
        if max_total > model.max_len:
            raise ValueError(
                "max_prompt_len + max_new_tokens = %d exceeds the model's "
                "max_len %d" % (max_total, model.max_len))
        if draft_model is not None:
            if draft_model.vocab_size != model.vocab_size:
                raise ValueError("draft vocab %d != target vocab %d"
                                 % (draft_model.vocab_size,
                                    model.vocab_size))
            if max_total > draft_model.max_len:
                raise ValueError("draft max_len %d cannot cover %d tokens"
                                 % (draft_model.max_len, max_total))
        self.device = self._engine_device(model, draft_model, device)
        # width ladder: page-table columns per decode signature.
        # ``width_blocks`` overrides the powers-of-2 default — e.g.
        # ``[engine.worst_case_width(...)]`` trades the narrow-width fast
        # path for a single decode signature
        max_width = self.worst_case_width(self.max_prompt_len,
                                          self.max_new_tokens, block_size)
        if self.spec_k > 0:
            # the draft's unrolled proposals write up to spec_k positions
            # past the committed cursor; the table must index them without
            # clamping into a neighbor's entry
            max_width += -(-self.spec_k // int(block_size))
        self._width_ladder = BucketLadder(max_width, width_blocks)
        if self._width_ladder.max_batch < max_width:
            raise ValueError("width_blocks %r cannot cover a worst-case "
                             "sequence (%d blocks)"
                             % (width_blocks, max_width))
        self._prompt_ladder = BucketLadder(self.max_prompt_len)
        if num_blocks is None:
            # full occupancy at worst case: admission is then slot-bound
            num_blocks = self.max_slots * max_width + 1
        self._cache = PagedKVCache(model.num_layers, num_blocks, block_size,
                                   model.num_heads, model.head_dim,
                                   account_region="kv:%s" % name)
        self._params = model.param_dict()
        self.tp_degree = int(getattr(model, "tp_degree", 1))
        self.stats = DecodeStats(name, kv_capacity=self._cache.capacity(),
                                 tp_degree=self.tp_degree)
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_threshold,
            backoff_s=breaker_backoff_ms / 1e3,
            max_backoff_s=breaker_max_backoff_ms / 1e3)
        retry = util.retry(attempts=_EXEC_ATTEMPTS, backoff=_EXEC_BACKOFF_S,
                           on_retry=lambda exc, i: self.stats.on_retry())
        self._prefill_exec = retry(self._prefill_once)
        self._decode_exec = retry(self._decode_once)
        self._chunk_exec = retry(self._chunk_once)
        self._verify_exec = retry(self._verify_once)
        self._draft_exec = retry(self._draft_once)
        self._draft_chunk_exec = retry(self._draft_chunk_once)
        self._draft_params = (draft_model.param_dict() if self.spec_k > 0
                              else None)
        # the live pools, bound for the engine's life to the ops the
        # worker replays; generate_reference binds its own at first use
        self._live = _BoundOps(
            self, self._init_pools(),
            self._draft_pools() if self.spec_k > 0 else None)
        self._ref = None
        self._ref_lock = threading.Lock()
        self.warmup_report = None
        if warmup:
            self.warmup()
        self._cond = threading.Condition()
        # guarded by _cond: queue, slots, lifecycle flags; seq ids come
        # from an itertools.count (atomic at the C level, no lock needed)
        self._queue = deque()      # of _QEntry
        self._slots = [None] * self.max_slots
        self._running = True
        self._closed = False
        self._draining = False     # admission closed, worker parking
        self._quiesced = threading.Event()  # worker parked, pools published
        self._pools = None         # (k_pool, v_pool) while quiesced
        self._seq_counter = itertools.count()
        self._thread = threading.Thread(
            target=self._run, name="mx-decode-%s" % name, daemon=True)
        self._thread.start()

    @staticmethod
    def _engine_device(model, draft_model, device):
        """The engine's device: ``device``, else the model's; the model
        (and the draft) must live there."""
        own = getattr(model, "device", None)
        dev = resolve_device(device if device is not None else own)
        for m in (model, draft_model):
            mdev = getattr(m, "device", None)
            if mdev is not None and not _same_device(mdev, dev):
                raise ValueError("model on %s cannot serve from an engine "
                                 "on %s" % (mdev, dev))
        return dev

    @staticmethod
    def worst_case_width(max_prompt_len, max_new_tokens, block_size):
        """Page-table width (blocks) covering a worst-case sequence plus
        the one-block write slack: a finished sequence's last token is
        never written, but a mid-stream one landing exactly on a block
        boundary needs the next block before its attention window does."""
        return -(-(int(max_prompt_len) + int(max_new_tokens))
                 // int(block_size)) + 1


    # -- CachedOp forwards (tensors in/out; the pools ride in params) ----
    @staticmethod
    def _split(params):
        p = dict(params)
        return p, p.pop(_K_POOL), p.pop(_V_POOL)

    def _prefill_forward(self, params, tokens, length, table):
        p, k_pool, v_pool = self._split(params)
        return self.model.prefill_fn(p, tokens, length, table, k_pool,
                                     v_pool)[0]

    def _decode_forward(self, params, tokens, positions, tables):
        p, k_pool, v_pool = self._split(params)
        return self.model.decode_fn(p, tokens, positions, tables, k_pool,
                                    v_pool)[0]

    # chunked prefill / speculative forwards: every one a FIXED shape —
    # [1, C] chunk, [S, K+1] verify, [S] draft — so turning the features
    # on adds a handful of warm signatures, never a steady-state capture
    def _chunk_forward(self, params, tokens, start, length, table):
        p, k_pool, v_pool = self._split(params)
        return self.model.chunk_prefill_fn(p, tokens, start, length, table,
                                           k_pool, v_pool)[0]

    def _verify_forward(self, params, tokens, positions, valids, tables):
        p, k_pool, v_pool = self._split(params)
        return self.model.verify_fn(p, tokens, positions, valids, tables,
                                    k_pool, v_pool)[0]

    def _draft_forward(self, params, tokens, positions, tables):
        p, k_pool, v_pool = self._split(params)
        return self.draft.propose_fn(p, tokens, positions, tables, k_pool,
                                     v_pool, self.spec_k)[0]

    def _draft_chunk_forward(self, params, tokens, start, length, table):
        p, k_pool, v_pool = self._split(params)
        return self.draft.chunk_prefill_fn(p, tokens, start, length, table,
                                           k_pool, v_pool)[0]

    # -- execution (retry envelope + fault point, like ServableModel) ---
    def _run_op(self, op, params, *arrays):
        """One dispatch of a bound op on host int32 inputs; returns its
        output tensor (fresh: the op's static buffer is reused)."""
        faults.fault_point("serving.predict", model=self.name)
        inputs = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device) for a in arrays]
        with autograd.pause():
            return op(params, *inputs)

    def _prefill_once(self, ops, tokens, length, table):
        return self._run_op(ops.prefill, ops.params, tokens, length, table)

    def _decode_once(self, ops, tokens, positions, tables):
        return self._run_op(ops.decode, ops.params, tokens, positions,
                            tables)

    def _chunk_once(self, ops, tokens, start, length, table):
        return self._run_op(ops.chunk, ops.params, tokens, start, length,
                            table)

    def _verify_once(self, ops, tokens, positions, valids, tables):
        return self._run_op(ops.verify, ops.params, tokens, positions,
                            valids, tables)

    def _draft_once(self, ops, tokens, positions, tables):
        return self._run_op(ops.draft, ops.draft_params, tokens, positions,
                            tables)

    def _draft_chunk_once(self, ops, tokens, start, length, table):
        return self._run_op(ops.draft_chunk, ops.draft_params, tokens,
                            start, length, table)

    def _record_pools(self, pools, shape):
        """Charge a freshly made K/V pool set to the engine's pool region
        (``<account_region>:pools``): ``prod(shape)`` fp32 words per pool.
        Pool sets live for the engine's lifetime (the live set, the draft's
        and generate_reference's), so the region only allocates."""
        from ... import memory_accounting
        nbytes = 1
        for d in shape:
            nbytes *= int(d)
        nbytes *= 4 * len(pools)   # fp32 pools
        memory_accounting.record_alloc(
            nbytes, "%s:pools" % self._cache.account_region,
            count=len(pools))
        return pools

    def _init_pools(self):
        """Fresh zeroed target-model K/V pools on the engine's device."""
        return self._record_pools(self._cache.init_pools(self.device),
                                  self._cache.pool_shape())

    def _draft_pools(self):
        """Fresh zeroed draft-model K/V pools (same block grid as the
        target pools, draft head geometry)."""
        shape = (self.draft.num_layers, self._cache.num_blocks,
                 self._cache.block_size, self.draft.num_heads,
                 self.draft.head_dim)
        return self._record_pools(
            (torch.zeros(shape, device=self.device),
             torch.zeros(shape, device=self.device)), shape)

    def _sync(self):
        """Wait for this thread's stream, on which the engine's steps and
        copies run: the pages are then what its last step or copy left.
        Not the whole device: another engine or model on the card may be
        capturing a CUDA graph, which a device-wide synchronize would
        invalidate."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- warmup ----------------------------------------------------------
    def warmup(self):
        """Capture every prefill (prompt bucket) and decode (width bucket)
        signature of the live ops.  Steady-state traffic then never misses:
        ``cache_stats()`` stays flat and ``capture_stats()`` captures no
        more.  Every warmup table is zeros, so its writes land in the trash
        block of the live pools only."""
        before = self.cache_stats()["misses"]
        captures = self.capture_stats()["captures"]
        ops = self._live
        max_w = self._width_ladder.max_batch
        S = self.max_slots
        n = 0
        if self.prefill_chunk is not None:
            # one chunk signature replaces the whole prompt ladder
            self._chunk_exec(ops, np.zeros((1, self.prefill_chunk), np.int32),
                             np.zeros((1,), np.int32),
                             np.ones((1,), np.int32),
                             np.zeros((1, max_w), np.int32))
            n += 1
        else:
            for lb in self._prompt_ladder:
                self._prefill_exec(ops, np.zeros((1, lb), np.int32),
                                   np.ones((1,), np.int32),
                                   np.zeros((1, max_w), np.int32))
                n += 1
        if self.spec_k > 0:
            # spec engines decode through ONE verify + ONE draft signature
            self._verify_exec(ops, np.zeros((S, self.spec_k + 1), np.int32),
                              np.zeros((S,), np.int32),
                              np.zeros((S,), np.int32),
                              np.zeros((S, max_w), np.int32))
            self._draft_exec(ops, np.zeros((S,), np.int32),
                             np.zeros((S,), np.int32),
                             np.zeros((S, max_w), np.int32))
            self._draft_chunk_exec(
                ops, np.zeros((1, self.prefill_chunk), np.int32),
                np.zeros((1,), np.int32), np.ones((1,), np.int32),
                np.zeros((1, max_w), np.int32))
            n += 3
        elif self.prefill_only:
            # a prefill-only tier never dispatches a decode step: warming
            # the width ladder would only stretch startup
            pass
        else:
            for w in self._width_ladder:
                self._decode_exec(ops, np.zeros((S,), np.int32),
                                  np.zeros((S,), np.int32),
                                  np.zeros((S, w), np.int32))
                n += 1
        after = self.cache_stats()
        self.warmup_report = {
            "signatures": n,
            "compiles": after["misses"] - before,
            "captures": self.capture_stats()["captures"] - captures,
            "cache": {"hits": after["hits"], "misses": after["misses"]},
        }
        return self.warmup_report

    # -- admission (client threads) --------------------------------------
    def submit(self, prompt, max_new_tokens=None, timeout_ms=None,
               on_token=None, owner=None, temperature=0.0, top_k=0,
               top_p=1.0, seed=None):
        """Submit one generation request; always returns a DecodeStream.

        Rejections come back already terminal (OVERLOADED when the queue
        or the KV block pool cannot take the stream, INVALID_INPUT for a
        prompt outside the menu or sampling options out of range,
        UNAVAILABLE when the breaker is open or the engine is stopped or
        draining) — callers branch on ``status``, never on exceptions,
        exactly like ModelServer.predict.

        ``temperature``/``top_k``/``top_p``/``seed`` select seeded
        host-side sampling (sampling.py); the defaults are greedy and
        bit-identical to the pre-sampling engine.  An explicit ``seed``
        makes the stream replay the same tokens on any engine with the
        same params — the chaos harness and the sequential oracle lean on
        that.

        ``owner`` is the router's fencing token: it is installed on the
        stream before admission and presented on every emission/terminal
        this engine produces, so a handoff (which re-owns the stream) can
        fence this engine out mid-flight."""
        if max_new_tokens is None:
            max_new_tokens = self.max_new_tokens
        deadline = (time.monotonic() + timeout_ms / 1e3
                    if timeout_ms is not None else None)
        try:
            sampling = SamplingParams(temperature, top_k, top_p, seed)
        except ValueError as exc:
            stream = DecodeStream(None, max_new_tokens, deadline,
                                  stats=self.stats, on_token=on_token)
            self.stats.on_invalid()
            stream.complete(INVALID_INPUT, error=str(exc))
            return stream
        if sampling.greedy and sampling.seed is None:
            sampling = None
        elif sampling.seed is None:
            # resolve on the CALLER's thread: the framework key state is
            # thread-local, so deriving here keeps the stream reproducible
            # under the caller's mx.random.seed (the worker thread's state
            # is unrelated)
            from .sampling import resolve_seed
            sampling.seed = resolve_seed(sampling)
        try:
            prompt = self._coerce_prompt(prompt)
        except (TypeError, ValueError) as exc:
            stream = DecodeStream(None, max_new_tokens, deadline,
                                  stats=self.stats, on_token=on_token)
            self.stats.on_invalid()
            stream.complete(INVALID_INPUT, error=str(exc))
            return stream
        stream = DecodeStream(prompt, int(max_new_tokens), deadline,
                              stats=self.stats, on_token=on_token,
                              sampling=sampling)
        if owner is not None:
            stream.set_owner(owner)
        with self._cond:
            closed = self._closed
            draining = self._draining
        if closed or draining:
            self.stats.on_unavailable_rejected()
            stream.complete(UNAVAILABLE,
                            error=("engine draining" if draining
                                   else "engine stopped"))
            return stream
        problem = self._validate(prompt, int(max_new_tokens))
        if problem is not None:
            self.stats.on_invalid()
            stream.complete(INVALID_INPUT, error=problem)
            return stream
        # breaker admission after validation (a request that can never
        # execute must not consume the half-open probe slot)
        decision = self.breaker.admit()
        if decision == REJECT:
            self.stats.on_unavailable_rejected()
            snap = self.breaker.snapshot()
            stream.complete(
                UNAVAILABLE,
                error="circuit open after %d consecutive failure(s); "
                      "retry in <= %.0f ms" % (snap["consecutive_failures"],
                                               snap["backoff_s"] * 1e3))
            return stream
        # KV admission: a stream's worst-case block count is reserved at
        # JOIN time (so an admitted-to-a-slot sequence can always grow to
        # completion — no mid-stream OOM, no eviction); admission itself
        # sheds fast when the pool is exhausted (nothing free and
        # unpromised: queueing more work could not make progress sooner)
        stream.seq_id = next(self._seq_counter)
        if self._cache.available_unreserved() <= 0:
            admitted = "no-blocks"
        else:
            with self._cond:
                if not self._running or self._draining:
                    admitted = "stopping"
                elif len(self._queue) >= self._max_queue:
                    admitted = "full"
                else:
                    self._queue.append(_QEntry(stream, gen=owner))
                    self._cond.notify_all()
                    admitted = True
        if admitted is not True:
            if decision == PROBE:
                self.breaker.release_probe()
            if admitted == "stopping":
                self.stats.on_unavailable_rejected()
                stream.complete(UNAVAILABLE, error="engine shutting down")
            else:
                self.stats.on_shed()
                stream.complete(
                    OVERLOADED,
                    error=("admission queue full" if admitted == "full"
                           else "no free KV blocks"))
            return stream
        stream.admitted = True
        self.stats.on_admitted()
        return stream

    def generate(self, prompt, max_new_tokens=None, timeout_ms=None):
        """Blocking convenience: submit + wait; returns the stream."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           timeout_ms=timeout_ms).result()

    def _validate(self, prompt, max_new_tokens):
        if not 1 <= len(prompt) <= self.max_prompt_len:
            return ("prompt length %d outside [1, %d]"
                    % (len(prompt), self.max_prompt_len))
        if not 1 <= max_new_tokens <= self.max_new_tokens:
            return ("max_new_tokens %d outside [1, %d]"
                    % (max_new_tokens, self.max_new_tokens))
        if prompt.min() < 0 or prompt.max() >= self.model.vocab_size:
            return ("prompt token ids outside [0, %d)"
                    % self.model.vocab_size)
        need = self._blocks_needed(len(prompt), max_new_tokens)
        if need > self._cache.capacity():
            # could NEVER join: reject now instead of starving in the queue
            return ("stream needs %d KV blocks but the pool only has %d"
                    % (need, self._cache.capacity()))
        return None

    def _blocks_needed(self, prompt_len, max_new_tokens):
        """Worst-case block reservation for one stream.  A prefill-only
        engine writes exactly the prompt's pages — the stream leaves at
        its first token, so no decode growth is ever provisioned here."""
        if self.prefill_only:
            return self._cache.blocks_for_tokens(int(prompt_len))
        return self._cache.blocks_for_tokens(int(prompt_len)
                                             + int(max_new_tokens))

    @staticmethod
    def _coerce_prompt(prompt):
        arr = np.asarray(prompt)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token id "
                             "sequence, got shape %s" % (arr.shape,))
        if not np.issubdtype(arr.dtype, np.integer):
            if not np.all(arr == np.floor(arr)):
                raise ValueError("prompt token ids must be integers")
        return arr.astype(np.int32)

    # -- scheduler loop (worker thread) ----------------------------------

    # -- scheduler loop (worker thread) ----------------------------------
    def _run(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._run_loop()
        except BaseException as exc:
            # the scheduler must never die silently: an exception escaping
            # the narrow per-execution guards (a failed device fetch, a
            # SimulatedCrash BaseException from a fault plan) would leave
            # _running True and every waiter blocked forever, violating
            # the "terminal state is a status, never a hang" contract.
            # Close the engine, drain everything with the retryable
            # status, then re-raise so the death stays observable — UNLESS
            # stop() already closed and drained us: a worker tripping over
            # its own freed KV state after a timed-out shutdown join is
            # routine teardown, not news worth a thread traceback.
            with self._cond:
                already_closed = self._closed
                self._closed = True
                self._running = False
            self._drain(error="decode worker died: %r" % (exc,))
            if not already_closed:
                raise

    def _run_loop(self):
        while True:
            with self._cond:
                # idle only when queue AND slots are empty — nothing whose
                # deadline could expire — and submit()/stop() both notify,
                # so the timeout is pure liveness insurance, kept long to
                # avoid burning 20 wakeups/s per idle engine.  A drain
                # parks here too, at a step boundary: the worker waits for
                # the card, publishes the live pools and signals quiesced
                # so export_stream can read a frozen device state;
                # resume() un-parks it (device content is untouched while
                # parked).
                while self._running and (
                        self._draining
                        or (not self._queue and not any(self._slots))):
                    if self._draining and not self._quiesced.is_set():
                        self._sync()
                        self._pools = self._live.pools
                        self._quiesced.set()
                        self._cond.notify_all()
                    self._cond.wait(0.5)
                if not self._running:
                    return
            self._expire()
            for seq in self._claim_joiners():
                if seq.snap is not None:
                    self._resume_imported(seq)
                elif self.prefill_chunk is None:
                    self._prefill(seq.stream)
                # chunked joiners advance below, one chunk per iteration
            if self.prefill_chunk is not None:
                self._advance_prefill()
            with self._cond:
                has_live = any(self._slots)
            if has_live:
                if self.spec_k > 0:
                    self._spec_step()
                else:
                    self._step()

    def _expire(self):
        """TIMEOUT queued and live streams whose deadline passed."""
        now = time.monotonic()
        with self._cond:
            expired_q = [e for e in self._queue if e.stream.expired(now)]
            if expired_q:
                self._queue = deque(e for e in self._queue
                                    if not e.stream.expired(now))
            expired_live = [(i, seq) for i, seq in enumerate(self._slots)
                            if seq is not None
                            and seq.stream.expired(now)]
            for i, _ in expired_live:
                self._slots[i] = None
        # a lost completion means an external fence already terminated
        # the stream; we still held it, so its bucket settles here with
        # the fence's status (see _vacate)
        for e in expired_q:
            self._cache.release(e.stream.seq_id)
            if e.stream.complete(TIMEOUT, error="deadline before prefill",
                                 owner=e.gen):
                self.stats.on_result(TIMEOUT)
            else:
                self.stats.on_result(e.stream.snapshot()[0])
        for _, seq in expired_live:
            self._cache.free_seq(seq.seq_id)
            if seq.stream.complete(TIMEOUT, error="deadline mid-stream",
                                   owner=seq.gen):
                self.stats.on_result(TIMEOUT)
            else:
                self.stats.on_result(seq.stream.snapshot()[0])

    def _claim_joiners(self):
        """Move queued streams into free slots (iteration-level join).

        A stream joins only when its worst-case KV block count can be
        reserved — a stream in a slot can then ALWAYS grow to completion
        (no mid-stream OOM, no eviction).  Joins are strict FIFO: when the
        head cannot reserve, nothing behind it jumps the line, so a big
        request cannot be starved by a stream of small ones.  ``static``
        scheduling (the bench baseline) only admits into an EMPTY batch
        and then runs it to completion — the run-to-completion discipline
        continuous batching replaces."""
        with self._cond:
            if self.scheduling == "static" and any(self._slots):
                return []       # a static batch runs to completion first
        joined = []
        while True:
            with self._cond:
                free_slot = next((i for i in range(self.max_slots)
                                  if self._slots[i] is None), None)
                if free_slot is None or not self._queue:
                    break
                entry = self._queue[0]
                res = None
                if entry.snap is None:
                    blocks = self._blocks_needed(
                        len(entry.stream.prompt),
                        entry.stream.max_new_tokens)
                    if self.prefix_cache:
                        res = self._cache.reserve(
                            entry.stream.seq_id, blocks,
                            prompt=entry.stream.prompt,
                            align_tokens=self.prefill_chunk)
                    else:
                        res = self._cache.reserve(entry.stream.seq_id,
                                                  blocks)
                    if not res:
                        break   # head waits for finishing sequences' blocks
                # imported entries pre-reserved at import_stream time
                self._queue.popleft()
                seq = _Seq(entry.stream, gen=entry.gen, snap=entry.snap)
                if entry.snap is None and self.prefill_chunk is not None:
                    # chunked prompts join mid-prefill: one chunk per
                    # scheduler iteration, decode steps interleaved
                    seq.prefill_pos = getattr(res, "prefix_tokens", 0)
                if entry.snap is None and entry.stream.sampling is not None:
                    seq.sampler = StreamSampler(entry.stream.sampling)
                self._slots[free_slot] = seq
            if self.prefix_cache and entry.snap is None:
                self.stats.on_prefix(getattr(res, "shared_blocks", 0))
            joined.append(seq)
        return joined

    def _vacate(self, seq, status, error=None):
        """Free the sequence's pages and complete its stream (the slot
        entry was already cleared by the caller under ``_cond``).  The
        completion presents this engine's fencing token: losing means a
        router fence terminated the stream while the seq still lived
        here (a kill racing a handoff).  The stream leaves this engine
        exactly once either way, so a lost completion settles the bucket
        with the fence's status — every removal site counts exactly one
        terminal, which is what keeps ``requests + imported == terminals
        + handed_off`` true per engine."""
        self._cache.free_seq(seq.seq_id)
        if seq.stream.complete(status, error=error, owner=seq.gen):
            self.stats.on_result(status)
        else:
            self.stats.on_result(seq.stream.snapshot()[0])

    def _fail_all(self, exc):
        """A batch execution failed beyond the retry budget: fail every
        live stream (the per-stream view of MicroBatcher's batch ERROR)."""
        with self._cond:
            live = [(i, seq) for i, seq in enumerate(self._slots)
                    if seq is not None]
            for i, _ in live:
                self._slots[i] = None
        for _, seq in live:
            self._vacate(seq, ERROR, error=repr(exc))


    def _prefill(self, stream):
        """Run one joining request's prompt and emit its first token."""
        seq = None
        with self._cond:
            for cand in self._slots:
                if cand is not None and cand.stream is stream:
                    seq = cand
                    break
        if seq is None:          # vacated between join and prefill
            return
        prompt = stream.prompt
        self._cache.ensure_capacity(seq.seq_id, len(prompt))
        lb = self._prompt_ladder.bucket(len(prompt))
        toks = np.zeros((1, lb), np.int32)
        toks[0, :len(prompt)] = prompt
        table = np.asarray(
            [self._cache.table(seq.seq_id, self._width_ladder.max_batch)],
            np.int32)
        try:
            logits = self._prefill_exec(self._live, toks,
                                        np.asarray([len(prompt)], np.int32),
                                        table)
        except Exception as exc:
            self.breaker.on_failure()
            with self._cond:
                for i, cand in enumerate(self._slots):
                    if cand is seq:
                        self._slots[i] = None
            self._vacate(seq, ERROR, error=repr(exc))
            return
        self.breaker.on_success()
        # the TTFT token must reach the host to stream it
        logits = logits.cpu().numpy()[0]
        token = self._select_token(seq, logits)
        seq.position = len(prompt)
        seq.cur_token = token
        seq.generated = 1
        stream._emit(token, owner=seq.gen)
        # TTFT from SUBMISSION (queue wait included — the number a client
        # experiences), taken from the stream's own record so snapshot and
        # bench artifact report the same sample, not two timestamps
        _, _, ttft, _, _ = stream.snapshot()
        if ttft is None:        # emit raced a terminal claim
            ttft = (time.monotonic() - stream.t_submit) * 1e3
        self.stats.on_prefill(ttft)
        self.stats.on_tokens(1)
        self._maybe_finish(seq, token)
        self.stats.on_idle(self._live_count(), self._cache.used())

    def _select_token(self, seq, logits_row):
        """Next token from a host logits row: argmax, or the stream's
        seeded sampler (sampling.py) — host-side either way, so the
        captured graphs are identical for greedy and sampled streams."""
        if seq.sampler is None:
            return int(np.argmax(logits_row))
        return seq.sampler.sample(logits_row)


    def _cow_pages(self, seq, first_pos, last_pos):
        """Copy-on-write guard for a write to positions [first, last]:
        fork every shared block covering them (cache swaps the table
        entry; we copy the device pages so the fork starts bit-identical
        to the shared original).  Draft pools fork the same block ids —
        the draft pool is indexed by the target's page table.  The copies
        run in place on this (the worker's) stream, before the step that
        writes the fork."""
        bs = self._cache.block_size
        for idx in range(int(first_pos) // bs, int(last_pos) // bs + 1):
            blk, src = self._cache.writable(seq.seq_id, idx)
            if src is None:
                continue
            pools = list(self._live.pools)
            if self._live.dpools is not None:
                pools += list(self._live.dpools)
            for pool in pools:
                pool[:, blk] = pool[:, src]
            self.stats.on_cow_fork()

    def _advance_prefill(self):
        """Run ONE prompt chunk for the oldest mid-prefill stream.

        One chunk per scheduler iteration is the interleave: a long
        prompt's chunks alternate with decode steps for live streams, so
        their inter-token latency (and queued streams' TTFT) no longer
        spikes behind it.  Every chunk is the same ``[1, C]`` signature —
        prefix-cache hits just start the loop at the first unshared
        chunk."""
        with self._cond:
            pending = [s for s in self._slots
                       if s is not None and s.prefill_pos is not None]
        if not pending:
            return
        seq = min(pending, key=lambda s: s.seq_id)
        stream = seq.stream
        prompt = stream.prompt
        L = len(prompt)
        C = self.prefill_chunk
        s0 = seq.prefill_pos
        n = min(C, L - s0)
        self._cache.ensure_capacity(seq.seq_id, s0 + n)
        if self.prefix_cache:
            self._cow_pages(seq, s0, s0 + n - 1)
        max_w = self._width_ladder.max_batch
        table = np.asarray([self._cache.table(seq.seq_id, max_w)], np.int32)
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = prompt[s0:s0 + n]
        start = np.asarray([s0], np.int32)
        length = np.asarray([n], np.int32)
        try:
            logits = self._chunk_exec(self._live, toks, start, length, table)
            if self.spec_k > 0:
                self._draft_chunk_exec(self._live, toks, start, length,
                                       table)
        except Exception as exc:
            self.breaker.on_failure()
            with self._cond:
                for i, cand in enumerate(self._slots):
                    if cand is seq:
                        self._slots[i] = None
            self._vacate(seq, ERROR, error=repr(exc))
            return
        self.breaker.on_success()
        if s0 + n < L:
            seq.prefill_pos = s0 + n
            return
        # final chunk: the prompt's K/V is complete — publish it for
        # cross-request reuse, then emit the TTFT token
        seq.prefill_pos = None
        if self.prefix_cache:
            self._cache.register_prefix(seq.seq_id, prompt)
        logits = logits.cpu().numpy()[0]    # the TTFT token, to the host
        token = self._select_token(seq, logits)
        seq.position = L
        seq.cur_token = token
        seq.generated = 1
        stream._emit(token, owner=seq.gen)
        _, _, ttft, _, _ = stream.snapshot()
        if ttft is None:        # emit raced a terminal claim
            ttft = (time.monotonic() - stream.t_submit) * 1e3
        self.stats.on_prefill(ttft)
        self.stats.on_tokens(1)
        if self.prefill_only:
            if not self._maybe_finish(seq, token):
                self._handoff_first_token(seq)
                return
        else:
            self._maybe_finish(seq, token)
        self.stats.on_idle(self._live_count(), self._cache.used())

    def _pages(self, pools, blocks):
        """Host copies (numpy) of ``blocks``' pages of a (k, v) pool pair:
        ``[num_layers, len(blocks), block_size, heads, head_dim]`` each."""
        idx = torch.as_tensor(np.asarray(blocks, np.int64),
                              device=self.device)
        return [pool[:, idx].cpu().numpy() for pool in pools]

    def _handoff_first_token(self, seq):
        """Prefill-only mode: the stream leaves this engine AT its first
        token.  The sequence's prompt K/V pages, cursor, and sampler
        state are snapshotted (the exact ``export_stream`` dict shape),
        its blocks return to the pool, and the installed handoff sink
        decides where the stream decodes — a truthy return means the
        stream found a decode home and leaves this engine's accounting
        through ``handed_off``; anything else (no sink, a False return,
        an exception) terminates it here with the retryable UNAVAILABLE,
        its one-token prefix intact for re-admission.

        No quiesce is needed: the worker thread runs the steps, so the
        pages it reads out (after its stream's work) are exactly the state
        the final chunk left behind — the importer's restore is bitwise."""
        stream = seq.stream
        with self._cond:
            for i, cand in enumerate(self._slots):
                if cand is seq:
                    self._slots[i] = None
        status, tokens, _, _, _ = stream.snapshot()
        if status is not None:
            # terminal while prefilling (fenced by the router): counters
            # settled wherever it was completed; just return its blocks
            self._cache.free_seq(seq.seq_id)
            return
        sampling = None
        if stream.sampling is not None:
            sampling = stream.sampling.as_dict()
            if seq.sampler is not None:
                sampling.update(seq.sampler.state())
            else:
                sampling.setdefault("draws", 0)
        need = self._cache.blocks_for_tokens(seq.position)
        blocks = self._cache.blocks_of(seq.seq_id)[:need]
        k_pages, v_pages = self._pages(self._live.pools, blocks)
        snap = {
            "prompt": np.asarray(stream.prompt, np.int32).copy(),
            "max_new_tokens": int(stream.max_new_tokens),
            "tokens": list(tokens),
            "geometry": {
                "block_size": self._cache.block_size,
                "num_layers": self.model.num_layers,
                "num_heads": self.model.num_heads,
                "head_dim": self.model.head_dim,
                "vocab_size": self.model.vocab_size,
            },
            "position": int(seq.position),
            "cur_token": int(seq.cur_token),
            "generated": int(seq.generated),
            "k": k_pages,
            "v": v_pages,
            "sampling": sampling,
        }
        self._cache.free_seq(seq.seq_id)
        cb = self._handoff_cb
        handed = False
        if cb is not None:
            try:
                handed = bool(cb(stream, snap))
            except Exception:
                handed = False
        if handed:
            self.stats.on_handed_off()
        else:
            # the sink may have already fence-terminated the stream (an
            # exhausted adoption search completes it UNAVAILABLE with a
            # private token), so this complete can lose — but the stream
            # leaves this engine either way, and conservation needs
            # exactly one bucket for it here
            stream.complete(UNAVAILABLE,
                            error="prefill tier found no decode home; "
                                  "re-admit with the emitted prefix as "
                                  "prompt",
                            owner=seq.gen)
            self.stats.on_result(UNAVAILABLE)
        self.stats.on_idle(self._live_count(), self._cache.used())

    def set_handoff(self, cb):
        """Install the first-token handoff sink ``cb(stream, snap) ->
        bool`` for a prefill-only engine (serving/disagg/ wires this to
        the decode tier's adoption path).  The sink runs on the worker
        thread between the final prompt chunk and the stream's departure;
        it must not block on this engine."""
        if not self.prefill_only:
            raise MXNetError("set_handoff requires prefill_only=True")
        self._handoff_cb = cb

    def _maybe_finish(self, seq, token):
        """OK-complete a sequence that hit EOS or its token budget."""
        eos = getattr(self.model, "eos_id", None)
        if seq.generated >= seq.stream.max_new_tokens or \
                (eos is not None and token == eos):
            with self._cond:
                for i, cand in enumerate(self._slots):
                    if cand is seq:
                        self._slots[i] = None
            self._vacate(seq, OK)
            return True
        return False

    def _live_count(self):
        with self._cond:
            return sum(1 for s in self._slots if s is not None)


    def _step(self):
        """One fixed-shape decode iteration over every live slot."""
        with self._cond:
            slots = list(self._slots)
        live = [seq for seq in slots
                if seq is not None and seq.prefill_pos is None]
        if not live:
            return
        # lazily grow page tables to cover this step's write index, then
        # pick the smallest warmed width covering the longest one
        for seq in live:
            self._cache.ensure_capacity(seq.seq_id, seq.position + 1)
            if self.prefix_cache:
                self._cow_pages(seq, seq.position, seq.position)
        max_tokens = max(seq.position + 1 for seq in live)
        width = self._width_ladder.bucket(
            self._cache.blocks_for_tokens(max_tokens))
        tokens = np.zeros((self.max_slots,), np.int32)
        positions = np.zeros((self.max_slots,), np.int32)
        tables = np.zeros((self.max_slots, width), np.int32)
        for i, seq in enumerate(slots):
            if seq is None or seq.prefill_pos is not None:
                continue
            tokens[i] = seq.cur_token
            positions[i] = seq.position
            tables[i] = self._cache.table(seq.seq_id, width)
        t0 = time.monotonic()
        try:
            logits = self._decode_exec(self._live, tokens, positions, tables)
        except Exception as exc:
            self.breaker.on_failure()
            self._fail_all(exc)
            return
        self.breaker.on_success()
        # per-step token fetch: the ids must reach the host to stream
        logits = logits.cpu().numpy()
        emitted = 0
        for i, seq in enumerate(slots):
            if seq is None or seq.prefill_pos is not None:
                continue
            with self._cond:
                if self._slots[i] is not seq:
                    continue     # vacated mid-step (teardown race)
            token = self._select_token(seq, logits[i])
            seq.position += 1
            seq.cur_token = token
            seq.generated += 1
            seq.stream._emit(token, owner=seq.gen)
            emitted += 1
            self._maybe_finish(seq, token)
        self.stats.on_step(len(live), emitted,
                           (time.monotonic() - t0) * 1e3,
                           self._cache.used())

    def _spec_step(self):
        """One speculative round: draft proposes K tokens in one unrolled
        call, ONE paged verify call scores all K+1 positions, and every
        live slot commits the longest prefix where the draft agrees with
        the target — up to K+1 tokens for two dispatches.

        Emitted tokens come exclusively from the target's logits rows
        (row i is the target's distribution after the first i+1 round
        tokens), so the committed sequence is the target's greedy chain
        no matter what the draft proposed: wrong, stale, or cold draft
        state only lowers the acceptance rate.  Sampled slots use one
        valid row and draw from row 0 — one seeded host draw per token,
        same replay contract as the non-speculative path."""
        with self._cond:
            slots = list(self._slots)
        live = [seq for seq in slots
                if seq is not None and seq.prefill_pos is None]
        if not live:
            return
        K1 = self.spec_k + 1
        width = self._width_ladder.max_batch
        valid_by = {}
        for seq in live:
            rem = seq.stream.max_new_tokens - seq.generated
            v = 1 if seq.sampler is not None else max(1, min(K1, rem))
            valid_by[id(seq)] = v
            # verify writes K/V for every valid row; rows past the budget
            # are invalid (trash block), so capacity never exceeds the
            # admission reservation
            self._cache.ensure_capacity(seq.seq_id, seq.position + v)
            if self.prefix_cache:
                self._cow_pages(seq, seq.position, seq.position + v - 1)
        tokens = np.zeros((self.max_slots, K1), np.int32)
        positions = np.zeros((self.max_slots,), np.int32)
        valids = np.zeros((self.max_slots,), np.int32)
        tables = np.zeros((self.max_slots, width), np.int32)
        cur = np.zeros((self.max_slots,), np.int32)
        for i, seq in enumerate(slots):
            if seq is None or seq.prefill_pos is not None:
                continue
            positions[i] = seq.position
            valids[i] = valid_by[id(seq)]
            tables[i] = self._cache.table(seq.seq_id, width)
            cur[i] = seq.cur_token
        t0 = time.monotonic()
        try:
            props = self._draft_exec(self._live, cur, positions, tables)
            # the proposals feed the verify call's token rows
            tokens[:, 0] = cur
            tokens[:, 1:] = props.cpu().numpy()
            logits = self._verify_exec(self._live, tokens, positions, valids,
                                       tables)
        except Exception as exc:
            self.breaker.on_failure()
            self._fail_all(exc)
            return
        self.breaker.on_success()
        # per-round token fetch: accepted ids must reach the host to stream
        logits = logits.cpu().numpy()
        emitted_total = 0
        eos = getattr(self.model, "eos_id", None)
        for i, seq in enumerate(slots):
            if seq is None or seq.prefill_pos is not None:
                continue
            with self._cond:
                if self._slots[i] is not seq:
                    continue     # vacated mid-round (teardown race)
            v = int(valids[i])
            rows = logits[i]
            emitted = []
            j = 0
            while True:
                tok = self._select_token(seq, rows[j])
                emitted.append(tok)
                if eos is not None and tok == eos:
                    break
                if j >= v - 1:
                    break        # last valid row consumed
                if int(tokens[i, j + 1]) != tok:
                    break        # draft diverged: later rows scored the
                                 # wrong token chain
                j += 1
            if seq.sampler is None and v > 1:
                self.stats.on_spec(v - 1, len(emitted) - 1)
            for tok in emitted:
                seq.position += 1
                seq.generated += 1
                seq.cur_token = tok
                seq.stream._emit(tok, owner=seq.gen)
            emitted_total += len(emitted)
            self._maybe_finish(seq, emitted[-1])
        self.stats.on_step(len(live), emitted_total,
                           (time.monotonic() - t0) * 1e3,
                           self._cache.used())


    def _resume_imported(self, seq):
        """Continue an imported stream: write its snapshot's K/V pages
        into this engine's live pools at the blocks just granted to it,
        restore the (position, cur_token, generated) cursor, and let the
        normal decode step take it from there.  The restore is bitwise:
        float32 pages round-trip host<->device exactly, and the decode math
        for a slot depends only on (params, cur_token, position, K/V pages
        0..position-1), so the continued stream equals the uninterrupted
        reference token for token."""
        snap = seq.snap
        seq.snap = None
        samp = snap.get("sampling")
        if samp is not None:
            params = SamplingParams(samp["temperature"], samp["top_k"],
                                    samp["top_p"], samp["seed"])
            seq.stream.sampling = params
            seq.sampler = StreamSampler.restore(params, samp["seed"],
                                                samp.get("draws", 0))
        if snap["generated"] == 0 or snap.get("k") is None:
            # exported before its prefill ran: nothing to restore — run
            # the normal prompt path on this engine
            if self.prefill_chunk is not None:
                seq.prefill_pos = 0
                return
            self._prefill(seq.stream)
            return
        position = int(snap["position"])
        self._cache.ensure_capacity(seq.seq_id, position)
        blocks = self._cache.blocks_of(seq.seq_id)
        idx = torch.as_tensor(np.asarray(blocks, np.int64),
                              device=self.device)
        # the snapshot's K/V pages stage host->device as two transient
        # buffers, consumed by the in-place write below (on the worker's
        # stream, before its next step); the paired free keeps the region
        # balanced while its peak records the staging cost
        from ... import memory_accounting
        staged = int(snap["k"].nbytes) + int(snap["v"].nbytes)
        region = "%s:import" % self._cache.account_region
        memory_accounting.record_alloc(staged, region, count=2)
        for pool, pages in zip(self._live.pools, (snap["k"], snap["v"])):
            pool[:, idx] = torch.from_numpy(
                np.ascontiguousarray(pages, np.float32)).to(self.device)
        memory_accounting.record_free(staged, region, count=2)
        seq.position = position
        seq.cur_token = int(snap["cur_token"])
        seq.generated = int(snap["generated"])
        self.stats.on_idle(self._live_count(), self._cache.used())

    # -- drain / handoff (router threads) ---------------------------------
    def quiesce(self, timeout_s=5.0):
        """Stop admitting and park the scheduler at a step boundary.

        Returns True once the worker is parked with its pool handles
        published (export_stream is only legal then: the device pools are
        frozen, no step is mutating pages).  False on timeout — the
        caller treats the engine as wedged and fences its streams instead
        of exporting them.  Idempotent; ``resume()`` reverses it."""
        with self._cond:
            if self._closed:
                return False
            self._draining = True
            parked = self._quiesced
            self._cond.notify_all()
        # wait OFF-lock: the worker needs _cond to park and set the event
        return parked.wait(timeout_s)

    def resume(self):
        """Reopen admission and un-park the scheduler (a drain that was
        cancelled, or a drained replica re-enabled)."""
        with self._cond:
            self._draining = False
            self._pools = None
            self._quiesced.clear()
            self._cond.notify_all()

    def export_streams(self):
        """Snapshot-and-remove every non-terminal queued/live stream (the
        drain sweep); returns ``[(stream, snapshot), ...]``.  Requires a
        successful ``quiesce()``."""
        with self._cond:
            targets = [e.stream for e in self._queue] \
                + [seq.stream for seq in self._slots if seq is not None]
        out = []
        for stream in targets:
            snap = self.export_stream(stream)
            if snap is not None:
                out.append((stream, snap))
        return out


    def export_stream(self, stream):
        """Extract one stream's resumable state and release its resources
        here: emitted-token prefix, generation cursor, and an exact host
        copy of its valid K/V pages (positions ``0..position-1``).  The
        stream leaves this engine's accounting through ``handed_off`` —
        it will terminate wherever ``import_stream`` lands it.  Returns
        None when the stream is unknown here or already terminal."""
        with self._cond:
            if not self._quiesced.is_set():
                raise MXNetError("export_stream requires a quiesced "
                                 "engine: call quiesce() first")
            entry = next((e for e in self._queue if e.stream is stream),
                         None)
            seq = None
            if entry is not None:
                self._queue.remove(entry)
            else:
                for i, cand in enumerate(self._slots):
                    if cand is not None and cand.stream is stream:
                        seq = cand
                        self._slots[i] = None
                        break
            pools = self._pools
        if entry is None and seq is None:
            return None
        status, tokens, _, _, _ = stream.snapshot()
        if status is not None:
            # terminal while still held: the engine's own terminations
            # always remove the stream before completing, so a terminal
            # found here means an external fence won — settle the bucket
            # (see _vacate) and return its blocks (free_seq also drops
            # any outstanding reservation)
            self._cache.free_seq(stream.seq_id)
            self.stats.on_result(status)
            return None
        geometry = {
            "block_size": self._cache.block_size,
            "num_layers": self.model.num_layers,
            "num_heads": self.model.num_heads,
            "head_dim": self.model.head_dim,
            "vocab_size": self.model.vocab_size,
        }
        sampling = None
        if stream.sampling is not None:
            sampling = stream.sampling.as_dict()
            if seq is not None and seq.sampler is not None:
                # effective seed + draws so far: the importer rebuilds the
                # RandomState and burns the draws, continuing the exact
                # uniform sequence this stream would have used here
                sampling.update(seq.sampler.state())
            else:
                sampling.setdefault("draws", 0)
        if seq is not None and seq.snap is not None:
            # imported here but never resumed: re-export the snapshot
            snap = dict(seq.snap)
        elif entry is not None and entry.snap is not None:
            snap = dict(entry.snap)
        elif seq is not None and seq.generated > 0:
            need = self._cache.blocks_for_tokens(seq.position)
            blocks = self._cache.blocks_of(seq.seq_id)[:need]
            k_pages, v_pages = self._pages(pools, blocks)
            snap = {
                "prompt": np.asarray(stream.prompt, np.int32).copy(),
                "max_new_tokens": int(stream.max_new_tokens),
                "tokens": list(tokens),
                "geometry": geometry,
                "position": int(seq.position),
                "cur_token": int(seq.cur_token),
                "generated": int(seq.generated),
                "k": k_pages,
                "v": v_pages,
                "sampling": sampling,
                "generation": self.generation,
            }
        else:
            # still queued (or joined but not yet prefilled): no device
            # state exists — the importer reruns the prompt from scratch
            snap = {
                "prompt": np.asarray(stream.prompt, np.int32).copy(),
                "max_new_tokens": int(stream.max_new_tokens),
                "tokens": list(tokens),
                "geometry": geometry,
                "position": 0,
                "cur_token": 0,
                "generated": 0,
                "k": None,
                "v": None,
                "sampling": sampling,
                "generation": self.generation,
            }
        self._cache.free_seq(stream.seq_id)
        self.stats.on_handed_off()
        self.stats.on_idle(self._live_count(), self._cache.used())
        return snap


    def import_stream(self, snap, stream=None, owner=None):
        """Admit a snapshot exported elsewhere; the stream resumes at the
        head of the queue with its worst-case KV blocks reserved up
        front.  ``stream`` is the original client handle (its token
        prefix continues seamlessly); without one, a fresh pre-seeded
        stream is built.  ``owner`` is installed as the fencing token
        BEFORE this call by the router (via ``stream.set_owner``) — the
        token presented here must match it, or the import is refused
        (the stale-zombie guard).  Raises :class:`MXNetError` on
        geometry mismatch, no KV headroom, or a closed/draining engine —
        the router's cue to try another survivor."""
        geometry = snap["geometry"]
        mine = {
            "block_size": self._cache.block_size,
            "num_layers": self.model.num_layers,
            "num_heads": self.model.num_heads,
            "head_dim": self.model.head_dim,
            "vocab_size": self.model.vocab_size,
        }
        if geometry != mine:
            raise MXNetError("snapshot geometry %r does not match engine "
                             "%r geometry %r" % (geometry, self.name, mine))
        if snap.get("generation") != self.generation:
            # the half-loaded-model guard: K/V pages written by one weight
            # generation must never be read by another's attention — a
            # stream finishes on the generation it started on (invariant 13)
            raise MXNetError(
                "snapshot from weight generation %r cannot resume on "
                "engine %r serving generation %r"
                % (snap.get("generation"), self.name, self.generation))
        if self.prefill_only and int(snap["generated"]) > 0:
            # mid-decode state needs decode steps this tier never runs;
            # only not-yet-prefilled streams may migrate within the tier
            raise MXNetError("prefill-only engine %r cannot resume a "
                             "stream that already decoded %d token(s)"
                             % (self.name, int(snap["generated"])))
        prompt = np.asarray(snap["prompt"], np.int32)
        if stream is None:
            sampling = None
            samp = snap.get("sampling")
            if samp is not None:
                sampling = SamplingParams(samp["temperature"],
                                          samp["top_k"], samp["top_p"],
                                          samp["seed"])
            stream = DecodeStream(prompt, int(snap["max_new_tokens"]),
                                  stats=self.stats, sampling=sampling)
            if owner is not None:
                stream.set_owner(owner)
            with stream._cond:
                stream._tokens.extend(int(t) for t in snap["tokens"])
        elif stream.owner() != owner:
            raise MXNetError("import_stream fencing token %r does not own "
                             "the stream (owner %r)" % (owner,
                                                        stream.owner()))
        stream.stats = self.stats
        need = self._blocks_needed(len(prompt),
                                   int(snap["max_new_tokens"]))
        with self._cond:
            if self._closed or self._draining or not self._running:
                raise MXNetError("engine %r is not accepting streams"
                                 % self.name)
        seq_id = next(self._seq_counter)
        stream.seq_id = seq_id
        if not self._cache.reserve(seq_id, need):
            raise MXNetError("engine %r has no KV headroom for %d blocks"
                             % (self.name, need))
        with self._cond:
            if self._closed or self._draining or not self._running:
                # lost a teardown race after reserving: give it back
                self._cache.release(seq_id)
                raise MXNetError("engine %r is not accepting streams"
                                 % self.name)
            self._queue.appendleft(_QEntry(stream, gen=owner, snap=snap))
            self._cond.notify_all()
        self.stats.on_imported()
        return stream

    def routing_signals(self):
        """The live signals the fleet's placement score consumes — cheap,
        lock-consistent reads, nothing on the card."""
        with self._cond:
            queue_depth = len(self._queue)
            slots_live = sum(1 for s in self._slots if s is not None)
            draining = self._draining or self._closed
        snap = self.stats.snapshot()
        kv = self._cache.stats()
        from ... import memory_accounting
        mem = memory_accounting.memory_counters().get(
            self._cache.account_region, {})
        free_blocks = self._cache.available_unreserved()
        return {
            # available_unreserved counts a page shared by N sequences
            # ONCE — the fleet's headroom math sees real free blocks, not
            # N-times-counted shared ones
            "kv_blocks_free": free_blocks,
            "kv_capacity": self._cache.capacity(),
            "kv_block_size": self._cache.block_size,
            # bytes-based headroom from the HBM accountant + block geometry
            # (memory_accounting.py): what scaling_advice() aggregates
            "kv_block_bytes": kv["block_bytes"],
            "kv_bytes_free": free_blocks * kv["block_bytes"],
            "kv_bytes_capacity": self._cache.capacity() * kv["block_bytes"],
            "kv_bytes_live": int(mem.get("live_bytes", 0)),
            "kv_bytes_peak": int(mem.get("peak_bytes", 0)),
            "queue_depth": queue_depth,
            "max_queue": self._max_queue,
            "slots_live": slots_live,
            "max_slots": self.max_slots,
            "tokens_per_s": snap["tokens_per_s"],
            "tp_degree": self.tp_degree,
            "draining": draining,
            "generation": self.generation,
            "prefix_hits": kv["prefix_hits"],
            "prefix_blocks_shared": kv["prefix_blocks_shared"],
            "cow_forks": kv["cow_forks"],
        }

    # -- reference path ---------------------------------------------------

    # -- reference path ---------------------------------------------------
    def _reference_ops(self):
        """generate_reference's ops, bound to its own pool pair (made and
        charged at the first call; their signatures capture then)."""
        if self._ref is None:
            self._ref = _BoundOps(self, self._init_pools())
        return self._ref

    def generate_reference(self, prompt, max_new_tokens=None,
                           temperature=0.0, top_k=0, top_p=1.0, seed=None):
        """Decode ``prompt`` one-request-at-a-time, bypassing the
        scheduler: private pools (zeroed at each call), the same signatures
        the live engine dispatches (batch ``[max_slots]`` with one live
        slot), through ops of their own, so that the live ops capture
        nothing here.
        This is the bitwise reference the acceptance gate compares
        continuous-batched outputs against, so it mirrors the engine's
        configured kernel path exactly: chunked engines prefill through
        the same ``[1, C]`` chunk signature, speculative engines decode
        through the same ``[S, K+1]`` verify signature with ONE valid row
        per call (sequential — no draft, no speculation; speculation only
        changes how many of these rows commit per dispatch, never their
        logits).  Sampling options replay a sampled stream: an explicit
        ``seed`` makes the output a pure function of the arguments.  Calls
        run one at a time (they share the private pools)."""
        if max_new_tokens is None:
            max_new_tokens = self.max_new_tokens
        prompt = self._coerce_prompt(prompt)
        problem = self._validate(prompt, int(max_new_tokens))
        if problem is not None:
            raise MXNetError(problem)
        sampler = None
        params = SamplingParams(temperature, top_k, top_p, seed)
        if not (params.greedy and params.seed is None):
            sampler = StreamSampler(params)

        def pick(row):
            if sampler is None:
                return int(np.argmax(row))
            return sampler.sample(row)

        with self._ref_lock:
            ops = self._reference_ops()
            for pool in ops.pools:
                pool.zero_()
            return self._reference_tokens(ops, prompt, int(max_new_tokens),
                                          pick)

    def _reference_tokens(self, ops, prompt, max_new_tokens, pick):
        blocks = list(range(1, 1 + self._cache.blocks_for_tokens(
            len(prompt) + max_new_tokens)))
        have = self._cache.blocks_for_tokens(len(prompt))
        max_w = self._width_ladder.max_batch
        table = np.zeros((1, max_w), np.int32)
        table[0, :have] = blocks[:have]
        if self.prefill_chunk is not None:
            C = self.prefill_chunk
            for s0 in range(0, len(prompt), C):
                n = min(C, len(prompt) - s0)
                toks = np.zeros((1, C), np.int32)
                toks[0, :n] = prompt[s0:s0 + n]
                logits = self._chunk_exec(ops, toks,
                                          np.asarray([s0], np.int32),
                                          np.asarray([n], np.int32), table)
        else:
            lb = self._prompt_ladder.bucket(len(prompt))
            toks = np.zeros((1, lb), np.int32)
            toks[0, :len(prompt)] = prompt
            logits = self._prefill_exec(ops, toks,
                                        np.asarray([len(prompt)], np.int32),
                                        table)
        token = pick(logits.cpu().numpy()[0])
        out_tokens = [token]
        position = len(prompt)
        eos = getattr(self.model, "eos_id", None)
        S = self.max_slots
        while len(out_tokens) < max_new_tokens and token != eos:
            need = self._cache.blocks_for_tokens(position + 1)
            have = max(have, need)
            positions = np.zeros((S,), np.int32)
            positions[0] = position
            if self.spec_k > 0:
                tokens = np.zeros((S, self.spec_k + 1), np.int32)
                valids = np.zeros((S,), np.int32)
                tables = np.zeros((S, max_w), np.int32)
                tokens[0, 0] = token
                valids[0] = 1
                tables[0, :have] = blocks[:have]
                logits = self._verify_exec(ops, tokens, positions, valids,
                                           tables)
                row = logits.cpu().numpy()[0, 0]
            else:
                width = self._width_ladder.bucket(need)
                tokens = np.zeros((S,), np.int32)
                tables = np.zeros((S, width), np.int32)
                tokens[0] = token
                tables[0, :have] = blocks[:have]
                logits = self._decode_exec(ops, tokens, positions, tables)
                row = logits.cpu().numpy()[0]
            token = pick(row)
            out_tokens.append(token)
            position += 1
        return np.asarray(out_tokens, np.int32)

    # -- observability ----------------------------------------------------
    def cache_stats(self):
        """Merged per-signature cache counters of the live ops
        (``prefill|``/``decode|``/``chunk|``/``verify|``/``draft|``/
        ``draft_chunk|`` key prefixes): a miss is a signature's first call,
        a capture on the card.  ``generate_reference``'s ops are not
        counted: their captures are its own."""
        merged = {}
        hits = misses = 0
        for prefix, cop in self._live.named_ops():
            st = cop.cache_stats()
            for sig, rec in st["signatures"].items():
                merged["%s|%s" % (prefix, sig)] = dict(rec)
            hits += st["hits"]
            misses += st["misses"]
        return {"signatures": merged, "hits": hits, "misses": misses,
                "recompiles": misses}

    def capture_stats(self):
        """The live ops' CUDA-graph counters, summed: captures, replays,
        eager warm-up runs, dropped captures and graphs held (all but the
        eager runs are 0 on the CPU, where the ops run eagerly)."""
        out = {}
        for _, cop in self._live.named_ops():
            for key, n in cop.capture_stats().items():
                out[key] = out.get(key, 0) + n
        return out

    def kv_stats(self):
        return self._cache.stats()

    def health(self):
        return self.breaker.health()

    def stats_snapshot(self):
        """Full engine snapshot (the ``ModelServer.stats()`` analog)."""
        snap = self.stats.snapshot()
        cache = self.cache_stats()
        snap["cache"] = {"hits": cache["hits"], "misses": cache["misses"],
                         "recompiles": cache["recompiles"],
                         "signatures": len(cache["signatures"])}
        snap["warmup"] = self.warmup_report
        snap["captures"] = self.capture_stats()
        snap["kv"] = self.kv_stats()
        # live pool headroom (not the step-sampled counter): capacity and
        # blocks neither allocated nor promised — the routing signal
        snap["kv_capacity"] = self._cache.capacity()
        snap["kv_blocks_free"] = self._cache.available_unreserved()
        snap["health"] = self.breaker.health()
        snap["breaker"] = self.breaker.snapshot()
        with self._cond:
            snap["queue_depth"] = len(self._queue)
            snap["slots_live"] = sum(1 for s in self._slots if s is not None)
            snap["draining"] = self._draining
        snap["scheduling"] = self.scheduling
        snap["generation"] = self.generation
        return snap

    # -- lifecycle ---------------------------------------------------------
    def stop(self):
        """Tear down; every queued or live stream terminates with the
        retryable UNAVAILABLE status and every KV block returns to the
        pool — no waiter left hanging, allocated == freed after drain."""
        with self._cond:
            self._closed = True
            self._running = False
            self._cond.notify_all()
        self._thread.join(timeout=5)
        self._drain(error="engine shutting down")

    def _drain(self, error):
        """Terminate every queued and live stream with UNAVAILABLE and
        return their KV blocks; idempotent (first completion wins,
        freeing an already-freed sequence is a no-op)."""
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
            live = [seq for seq in self._slots if seq is not None]
            self._slots = [None] * self.max_slots
        for e in leftovers:
            self._cache.release(e.stream.seq_id)
            if e.stream.complete(UNAVAILABLE, error=error, owner=e.gen):
                self.stats.on_result(UNAVAILABLE)
            else:
                # externally fenced while queued: settle the bucket here
                # (see _vacate)
                self.stats.on_result(e.stream.snapshot()[0])
        for seq in live:
            self._vacate(seq, UNAVAILABLE, error=error)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
