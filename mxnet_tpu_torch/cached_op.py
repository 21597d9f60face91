"""CachedOp: a whole forward captured once and replayed (counterpart of
``mxnet_tpu/cached_op.py:37-302``).

The JAX package traces the forward under ``jax.jit`` once per input
signature and calls the compiled executable after that.  Here a signature's
first call on the card captures the forward into a ``torch.cuda.CUDAGraph``
over static input buffers, and each later call copies its inputs into those
buffers and replays the graph: one launch for the whole forward, the same
kernels eager mode runs (the hand-written ones included, which launch on
the current stream), so a captured forward is bitwise its eager self.

- **Signatures.** ``(mode, input shapes and dtypes)``, written as the JAX
  package writes them (``infer|float32[4,16]``); :meth:`cache_stats` counts
  a signature's first call as a miss and every later one as a hit, as
  there.  :meth:`capture_stats` counts the graphs themselves: captures,
  replays, the eager warm-up runs before each capture, and the times the
  captures were dropped.
- **Capture.** A new signature runs eagerly twice (its warm-up) on
  a side stream, so that lazily made state (cuBLAS and cuDNN workspaces,
  kernels built at first use) exists before capture, then is captured on
  that stream into the op's one memory pool.  The aux state (``aux_names``,
  BatchNorm's running statistics) is put back after the warm-up runs, so
  each call still folds it once.  On the card a capture that fails raises:
  nothing falls back to eager execution.
- **Recording.** Under ``autograd.record()`` the call is one node on the
  tape (``_CachedOp``, ``cached_op.cc:228``): a ``torch.autograd.Function``
  whose forward replays a captured forward graph and whose backward
  replays a graph of that forward's backward, captured with it.  The
  gradients reach the inputs that take them and the parameters that
  require them, where ``.grad`` hooks (the Trainer's) see them as they see
  eager ones.  A forward graph's saved activations live until its
  backward; a replay of another of the op's graphs in between would
  overwrite them, and the backward then raises instead of using them.
- **Parameters.** ``param_dict`` maps names to the live tensors, which the
  graphs read and (aux) write in place.  A parameter whose storage changes
  (``Parameter.set_data`` of another shape, ``cast``) invalidates every
  capture; the next call captures again instead of replaying into freed
  memory.
- **Outputs.** Each call returns fresh tensors: the static output buffers
  are overwritten by the next replay.
- **Threads.** Captures and replays of one op run under its lock, and a
  capture checks only its own thread's CUDA calls
  (``capture_error_mode="thread_local"``), so other threads' work on the
  card cannot break it.  Captures of all ops in the process take turns
  (``_CAPTURE_LOCK``): entering a capture synchronizes the whole device
  and empties the allocator's cache, and a device-wide synchronize while
  another thread's capture is open would invalidate that capture.  Other
  threads keep replaying meanwhile (a serving fleet warms a joining copy
  beside live ones); they synchronize only their own streams.  Python's
  cycle collector is held off during a capture: a collection inside it
  would destroy dead ops' graphs on the capturing thread, a call the
  capture forbids, which invalidates it (seen on the card when a fleet's
  dropped copies were collected during the next engine's warm-up).
- **The CPU.** A CPU input runs the forward eagerly on every call (the
  tests' device), recording for autograd only under ``autograd.record()``
  as a graph does; the signature counts are kept the same way.

- **Keys.** Each call takes one ``random.next_key()`` on the host
  (``mxnet_tpu/cached_op.py:233``) and runs the forward under
  ``random.key_override`` of it, so every random op inside splits its key
  from the call's, as the JAX package's traced forward does.  On the card
  the key is the graphs' one more input: a static ``int32`` buffer of two
  words, into which each call copies its key before the replay, and from
  which the captured forward splits in torch integer ops.  So every replay
  draws fresh masks, the same as the CPU's eager run from the same
  ``mx.random.seed``; a recorded call's backward reuses its forward's
  masks (saved by autograd in the graph), drawing nothing.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

from . import autograd
from . import random as _random
from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["CachedOp"]

_WARMUP = 2
# one capture at a time in the process (see "Threads" above); reentrant,
# so that a capture begun inside another fails as it would without the
# lock instead of waiting for itself
_CAPTURE_LOCK = threading.RLock()


@contextlib.contextmanager
def _collector_held():
    """Hold the cycle collector off until the block ends (see "Threads"
    above)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _as_tensor(x):
    return x._data if isinstance(x, NDArray) else x


class _Graph:
    """One captured signature: the static buffers and the graphs."""

    __slots__ = ("static_in", "static_out", "fwd", "bwd", "out_diff",
                 "static_gout", "static_grads", "grad_slots")


class CachedOp:
    """``CachedOp(forward_fn, param_dict, aux_names=(), draws_key=True)``.

    ``forward_fn(params, *inputs)`` takes ``{name: tensor}`` and tensors
    and returns a tensor or a list or tuple of them.  ``param_dict`` is
    ``{name: tensor}`` (the live storage); ``aux_names`` are the
    parameters the forward writes in training.  ``draws_key=False`` takes
    no key a call (the executor's graphs, whose random nodes take theirs as
    an input, as the JAX executor's jitted functions do)."""

    def __init__(self, forward_fn, param_dict, aux_names=(), draws_key=True):
        self._forward_fn = forward_fn
        self._draws_key = draws_key
        self._param_names = sorted(param_dict.keys())
        aux = set(aux_names)
        self._aux_names = [n for n in self._param_names if n in aux]
        self._out_tree = None          # 'single' | 'list' | 'tuple'
        self._sig_stats = {}           # signature str -> [hits, misses]
        self._stats_lock = threading.Lock()
        self._lock = threading.RLock()
        self._graphs = {}
        self._storage = None
        self._stream = None
        self._pool = None
        self._key_buf = None
        self._generation = 0
        self._counts = {"captures": 0, "replays": 0, "eager_runs": 0,
                        "drops": 0}

    # ------------------------------------------------------------------
    @staticmethod
    def _signature(training, input_vals):
        """The cache key of one dispatch as a readable string, e.g.
        ``infer|float32[4,16]``."""
        parts = ["train" if training else "infer"]
        for v in input_vals:
            shape = ",".join(str(d) for d in getattr(v, "shape", ()))
            parts.append("%s[%s]" % (_dtype_name(getattr(v, "dtype", "?")),
                                     shape))
        return "|".join(parts)

    def _note_dispatch(self, training, input_vals):
        sig = self._signature(training, input_vals)
        with self._stats_lock:
            rec = self._sig_stats.get(sig)
            if rec is None:
                self._sig_stats[sig] = [0, 1]
            else:
                rec[0] += 1
        return sig

    def cache_stats(self):
        """``{"signatures": {sig: {"hits": h, "misses": m}}, "hits": H,
        "misses": M, "recompiles": M}``: a miss is a signature's first call
        (a capture on the card), a hit every later one (a replay)."""
        with self._stats_lock:
            sigs = {sig: {"hits": rec[0], "misses": rec[1]}
                    for sig, rec in self._sig_stats.items()}
        hits = sum(r["hits"] for r in sigs.values())
        misses = sum(r["misses"] for r in sigs.values())
        return {"signatures": sigs, "hits": hits, "misses": misses,
                "recompiles": misses}

    def reset_cache_stats(self):
        """Zero the hit and miss counts (the captures stay)."""
        with self._stats_lock:
            self._sig_stats.clear()

    def capture_stats(self):
        """``{"captures", "replays", "eager_runs", "drops", "graphs"}``:
        graphs captured (a recorded signature's forward and backward count
        as one), forward replays, eager warm-up runs, captures dropped on a
        storage change, and graphs held now."""
        with self._lock:
            out = dict(self._counts)
            out["graphs"] = len(self._graphs)
        return out

    # ------------------------------------------------------------------
    def _call_fn(self, params, inputs, rng_key):
        scope = _random.key_override(rng_key) if self._draws_key \
            else contextlib.nullcontext()
        with scope:
            out = self._forward_fn(dict(zip(self._param_names, params)),
                                   *inputs)
        if isinstance(out, (list, tuple)):
            self._out_tree = "tuple" if isinstance(out, tuple) else "list"
            return list(out)
        self._out_tree = "single"
        return [out]

    def _wrap(self, outs, as_nd):
        if as_nd:
            outs = [NDArray(o) for o in outs]
        if self._out_tree == "single":
            return outs[0]
        return tuple(outs) if self._out_tree == "tuple" else list(outs)

    def __call__(self, param_dict, *inputs):
        training = autograd.is_training()
        recording = autograd.is_recording() and torch.is_grad_enabled()
        params = [_as_tensor(param_dict[n]) for n in self._param_names]
        as_nd = any(isinstance(x, NDArray) for x in inputs)
        in_vals = [_as_tensor(x) for x in inputs]
        sig = self._note_dispatch(training, in_vals)
        rng_key = _random.next_key() if self._draws_key else None
        first = in_vals[0] if in_vals else (params[0] if params else None)
        if first is None or first.device.type != "cuda":
            with self._lock:
                self._counts["eager_runs"] += 1
            # recorded exactly when a graph would record: under record()
            with torch.set_grad_enabled(recording):
                return self._wrap(self._call_fn(params, in_vals, rng_key),
                                  as_nd)
        return self._wrap(self._call_graph(sig, training, recording, params,
                                           in_vals, rng_key), as_nd)

    # ------------------------------------------------------------------
    def _check_storage(self, params):
        key = tuple((p.data_ptr(), p.dtype, tuple(p.shape)) for p in params)
        if key != self._storage:
            if self._graphs:
                self._counts["drops"] += 1
            self._graphs.clear()
            self._storage = key

    def _call_graph(self, sig, training, recording, params, in_vals,
                    rng_key):
        # the key's words as a host tensor, what the replay copies in
        if rng_key is not None:
            rng_key = _random.key_tensor(rng_key, "cpu")
        grad_params = [i for i, p in enumerate(params)
                       if recording and p.requires_grad]
        key = (sig, recording, tuple(x.requires_grad for x in in_vals)
               if recording else (), tuple(grad_params))
        with self._lock:
            self._check_storage(params)
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._capture(training, recording, params, in_vals,
                                      grad_params)
                self._graphs[key] = entry
            if not recording:
                return self._replay(entry, in_vals, rng_key)
        outs = _GraphReplay.apply(self, entry, rng_key, len(in_vals),
                                  *in_vals, *[params[i] for i in grad_params])
        return list(outs)

    def _replay(self, entry, in_vals, rng_key):
        with torch.no_grad():
            for s, x in zip(entry.static_in, in_vals):
                if s is not x:
                    s.copy_(x)
            if rng_key is not None:
                self._key_buf.copy_(rng_key)
        entry.fwd.replay()
        self._generation += 1
        self._counts["replays"] += 1
        return [o.detach().clone() for o in entry.static_out]

    def _capture(self, training, recording, params, in_vals, grad_params):
        """Warm up, then capture the forward (and, recording, its backward)
        of one signature; raises if the capture fails."""
        with _CAPTURE_LOCK, _collector_held():
            return self._capture_locked(training, recording, params,
                                        in_vals, grad_params)

    def _capture_locked(self, training, recording, params, in_vals,
                        grad_params):
        device = in_vals[0].device if in_vals else params[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._key_buf is None:
            self._key_buf = torch.zeros(2, dtype=torch.int32, device=device)
        stream = self._stream
        entry = _Graph()
        with torch.no_grad():
            entry.static_in = [x.detach().clone() for x in in_vals]
        if recording:
            for s, x in zip(entry.static_in, in_vals):
                s.requires_grad_(x.requires_grad)
        # the graphs differentiate aliases of the parameters (the same
        # storage): leaves made here, on the capture's stream, where the
        # parameters' own gradient accumulators may have been made on
        # another (a Trainer hooks them when it is built)
        cap_params = list(params)
        for i in grad_params:
            cap_params[i] = params[i].detach().requires_grad_()
        wrt = [s for s in entry.static_in if s.requires_grad] + \
            [cap_params[i] for i in grad_params]
        name_pos = {n: i for i, n in enumerate(self._param_names)}
        aux = [params[name_pos[n]] for n in self._aux_names] \
            if training else []
        with torch.no_grad():
            saved = [a.detach().clone() for a in aux]

        def run():
            outs = self._call_fn(cap_params, entry.static_in, self._key_buf)
            if recording:
                diff = [o for o in outs if o.requires_grad]
                if diff and wrt:
                    torch.autograd.grad(diff, wrt,
                                        [torch.ones_like(o) for o in diff],
                                        allow_unused=True)
            return outs

        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream), torch.set_grad_enabled(recording):
            for _ in range(_WARMUP):
                run()
                self._counts["eager_runs"] += 1
            with torch.no_grad():
                for a, s in zip(aux, saved):
                    a.copy_(s)
        del saved
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)

        entry.fwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(entry.fwd, pool=self._pool, stream=stream,
                              capture_error_mode="thread_local"), \
                torch.set_grad_enabled(recording):
            outs = self._call_fn(cap_params, entry.static_in, self._key_buf)
        entry.static_out = outs
        entry.out_diff = [recording and o.requires_grad for o in outs]
        entry.bwd = None
        if recording:
            diff_idx = [i for i, d in enumerate(entry.out_diff) if d]
            with torch.cuda.stream(stream):
                entry.static_gout = [(i, torch.zeros_like(outs[i]))
                                     for i in diff_idx]
            # where each of wrt's gradients goes among the Function's
            # inputs (the call's inputs, then the parameters that take one)
            slots = [i for i, s in enumerate(entry.static_in)
                     if s.requires_grad]
            slots += [len(in_vals) + j for j in range(len(grad_params))]
            entry.grad_slots = slots
            entry.bwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(entry.bwd, pool=self._pool, stream=stream,
                                  capture_error_mode="thread_local"):
                if diff_idx and wrt:
                    grads = torch.autograd.grad(
                        [outs[i] for i in diff_idx], wrt,
                        [g for _, g in entry.static_gout], allow_unused=True)
                else:
                    grads = [None] * len(wrt)
            entry.static_grads = list(grads)
            entry.static_out = [o.detach() for o in outs]
        self._counts["captures"] += 1
        return entry


class _GraphReplay(torch.autograd.Function):
    """One tape node for a recorded call: forward and backward replay the
    signature's two graphs."""

    @staticmethod
    def forward(ctx, cop, entry, rng_key, n_in, *tensors):
        with cop._lock:
            outs = cop._replay(entry, tensors[:n_in], rng_key)
            ctx.generation = cop._generation
        ctx.cop, ctx.entry, ctx.n_tensors = cop, entry, len(tensors)
        frozen = [o for o, d in zip(outs, entry.out_diff) if not d]
        if frozen:
            ctx.mark_non_differentiable(*frozen)
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grad_outs):
        cop, entry = ctx.cop, ctx.entry
        with cop._lock:
            if cop._generation != ctx.generation:
                raise MXNetError(
                    "CachedOp: another of this op's graphs was replayed "
                    "between a recorded forward and its backward, which "
                    "overwrote the saved activations; run the backward "
                    "before calling the block again")
            for i, buf in entry.static_gout:
                g = grad_outs[i]
                if g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)
            entry.bwd.replay()
            grads = [None] * ctx.n_tensors
            for slot, g in zip(entry.grad_slots, entry.static_grads):
                grads[slot] = None if g is None else g.clone()
        return (None, None, None, None) + tuple(grads)
