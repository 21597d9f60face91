"""DeviceFeed: the input pipeline's stage that puts batches on the card
ahead of the step (counterpart of ``mxnet_tpu/io/device_feed.py``:
``stage_batch`` :76, ``_FeedState`` :155, ``_feed_worker`` :197,
``DeviceFeed`` :227).

``DeviceFeed`` wraps any iterable of batches (a ``DataLoader``'s sample
lists, a ``DataIter``, a generator of arrays) with one background thread
that runs up to ``depth`` batches ahead of the consumer through a bounded
queue:

* an optional ``transform`` (the DataLoader's batchify) runs on the feed
  thread, off the consumer's critical path;
* each item is then **staged** (:func:`stage_batch`): every tensor leaf
  is put in page-locked host memory (``Tensor.pin_memory()``) and copied
  to the card with ``non_blocking=True`` on a ``torch.cuda.Stream`` that
  the feed owns.  The thread's whole work (the source's own, the
  transform's and the copy) runs on that stream, and the thread waits on a
  CUDA event recorded after it before it enqueues, so a batch is resident
  when the consumer sees it and the consumer's stream needs no wait;
* on receipt the consumer calls ``record_stream`` on each CUDA tensor with
  its current stream: the caching allocator gave the tensor's block to the
  feed's stream, and without that mark it would hand the block back to the
  feed's next copy as soon as the consumer drops the batch, while kernels
  queued on the consumer's stream may still read it.

The lifecycle is the JAX package's: the queue is bounded (``depth >= 1``);
a worker's error is raised in the consumer after the batches before it;
``close()`` is idempotent, unblocks a worker waiting on a full queue and
joins it (``__exit__`` and ``__del__`` call it); the thread holds no
reference to the ``DeviceFeed`` (its target is a module function over a
separate state), so an iterator abandoned mid-epoch stays collectable and
its ``__del__`` stops the thread.  One feed is one pass over its source.
The caller's context is taken at construction, since the thread has no
``with mx.gpu(0):`` scope of its own.

The ``feed`` profiler domain carries ``<name>:queue_depth``,
``<name>:h2d_ms`` and ``<name>:starved_ms`` counters while profiling is
on; ``stats()`` gives the totals always.  ``mesh=`` (a sharded feed) waits
for ROADMAP queue 1 #8 and raises.
"""
from __future__ import annotations

import contextlib
import queue as _queue
import threading
import time

import numpy as np
import torch

from .. import profiler
from .. import util as _util
from ..base import MXNetError
from ..context import PinnedCPU, current_context, resolve_device

__all__ = ["DeviceFeed", "stage_batch"]

_END = object()
_JOIN_TIMEOUT_S = 10.0
_PUT_POLL_S = 0.05


class _WorkerError:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


def _no_mesh(mesh):
    if mesh is not None:
        raise MXNetError("a DeviceFeed sharded over a mesh is not ported "
                         "yet (ROADMAP queue 1 #8)")


def _target(ctx):
    """(device, pinned) for a context: ``cpu_pinned`` is the CPU with
    page-locked memory."""
    if ctx is None:
        ctx = current_context()
    if isinstance(ctx, PinnedCPU):
        return ctx.device, True
    return resolve_device(ctx), False


def _put_tensor(t, device, pinned):
    if device.type == "cuda":
        if t.device == device:
            return t
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    t = t.cpu()
    if pinned and torch.cuda.is_available() and not t.is_pinned():
        # page-locking needs the CUDA driver; without one there is no card
        # to copy to, and the host tensor is the staged form
        t = t.pin_memory()
    return t


def _walk(obj, leaf):
    """``obj`` with every array leaf replaced by ``leaf(x)``: DataBatches,
    lists, tuples and dicts keep their structure, anything else passes."""
    from ..ndarray.ndarray import NDArray
    from .io import DataBatch
    if isinstance(obj, DataBatch):
        return DataBatch(
            data=None if obj.data is None else [_walk(d, leaf)
                                                for d in obj.data],
            label=None if obj.label is None else [_walk(x, leaf)
                                                  for x in obj.label],
            pad=obj.pad, index=obj.index, bucket_key=obj.bucket_key,
            provide_data=obj.provide_data, provide_label=obj.provide_label)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_walk(o, leaf) for o in obj)
    if isinstance(obj, dict):
        return {k: _walk(v, leaf) for k, v in obj.items()}
    if isinstance(obj, (NDArray, torch.Tensor, np.ndarray)):
        return leaf(obj)
    return obj


def stage_batch(item, ctx=None, mesh=None):
    """Place one batch on ``ctx`` (default the current context), keeping
    its structure: an NDArray leaf becomes an NDArray there, a tensor or a
    numpy array a tensor.  For a CUDA context each leaf goes through
    page-locked memory and a ``non_blocking`` copy on the current stream
    (the feed's, on its thread), and the call returns only after a CUDA
    event recorded behind the copies has completed; a leaf already on that
    device stays as it is.  ``cpu_pinned`` pins host leaves.  The
    ``device_feed.put`` fault point sits at the top."""
    from ..base import tensor_from_numpy
    from ..faults import fault_point
    from ..ndarray.ndarray import NDArray

    fault_point("device_feed.put")
    _no_mesh(mesh)
    device, pinned = _target(ctx)

    def leaf(x):
        if isinstance(x, NDArray):
            return NDArray(_put_tensor(x._data.detach(), device, pinned))
        if isinstance(x, np.ndarray):
            x = tensor_from_numpy(x)
        return _put_tensor(x, device, pinned)

    staged = _walk(item, leaf)
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()
    return staged


def _claim(item):
    """Mark each CUDA tensor of a received batch as used on the consumer's
    current stream (``record_stream``), so the allocator does not reuse
    its block for the feed's next copy before the consumer's kernels are
    done with it."""
    from ..ndarray.ndarray import NDArray

    def leaf(x):
        t = x._data if isinstance(x, NDArray) else x
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))
        return x
    _walk(item, leaf)


class _FeedState:
    """Everything the worker thread touches, apart from the DeviceFeed, so
    that an abandoned feed stays collectable while its thread runs."""

    def __init__(self, source, ctx, transform, depth, name, stage, stream):
        self.source = source
        self.ctx = ctx
        self.transform = transform
        self.stage = stage
        self.stream = stream
        self.queue = _queue.Queue(maxsize=int(depth))
        self.stop = threading.Event()
        self.lock = threading.Lock()
        # guarded by lock: written by the worker, read by the consumer
        self.batches = 0
        self.h2d_ms = 0.0
        self.starved_ms = 0.0
        self.max_depth = 0
        domain = profiler.Domain("feed")
        self.c_depth = domain.new_counter("%s:queue_depth" % name)
        self.c_h2d = domain.new_counter("%s:h2d_ms" % name)
        self.c_starved = domain.new_counter("%s:starved_ms" % name)

    def put(self, item):
        """Bounded put that honours stop; False if stopped while full."""
        while not self.stop.is_set():
            try:
                self.queue.put(item, timeout=_PUT_POLL_S)
                return True
            except _queue.Full:
                continue
        return False


# a transient staging failure stages the same item again
_stage_with_retry = _util.retry(attempts=3, backoff=0.002)(stage_batch)


def _feed_worker(state):
    try:
        scope = (torch.cuda.stream(state.stream) if state.stream is not None
                 else contextlib.nullcontext())
        with scope:
            if state.stream is not None:
                state.stream.wait_event(state.ready)
            it = iter(state.source)
            while not state.stop.is_set():
                try:
                    item = next(it)
                except StopIteration:
                    state.put(_END)
                    return
                if state.transform is not None:
                    item = state.transform(item)
                t0 = time.perf_counter()
                staged = (_stage_with_retry(item, ctx=state.ctx)
                          if state.stage else item)
                h2d_ms = (time.perf_counter() - t0) * 1e3
                if not state.put(staged):
                    return
                depth = state.queue.qsize()
                with state.lock:
                    state.batches += 1
                    state.h2d_ms += h2d_ms
                    state.max_depth = max(state.max_depth, depth)
                if profiler.profiling_active():
                    state.c_h2d.set_value(h2d_ms)
                    state.c_depth.set_value(depth)
    except BaseException as exc:  # raised in the consumer, not on stderr
        state.put(_WorkerError(exc))


class DeviceFeed:
    """A bounded background thread that keeps staged batches ahead of the
    step.

    Parameters
    ----------
    source : iterable
        The batches; iterated once, on the feed thread.
    ctx : device, optional
        Where batches are staged (default the current context, taken now);
        ``mx.cpu_pinned()`` stages into page-locked host memory.
    mesh : optional
        A sharded feed: not ported yet (ROADMAP queue 1 #8), raises.
    depth : int
        Queue capacity, the batches the feed runs ahead (>= 1).
    transform : callable, optional
        Applied to each item on the feed thread before staging.
    name : str
        The counters' prefix.
    stage : bool
        False hands items through unstaged (``PrefetchingIter`` without a
        ``ctx``).
    """

    def __init__(self, source, ctx=None, mesh=None, depth=2, transform=None,
                 name="feed", stage=True):
        _no_mesh(mesh)
        if depth < 1:
            raise ValueError("DeviceFeed depth must be >= 1, got %r" % depth)
        stream = None
        if stage:
            if ctx is None:
                ctx = current_context()
            device, _ = _target(ctx)
            if device.type == "cuda":
                stream = torch.cuda.Stream(device=device)
        self._state = _FeedState(source, ctx, transform, depth, name, stage,
                                 stream)
        if stream is not None:
            # the feed's stream first waits for the work queued so far on
            # the caller's (a source's arrays may still be being written)
            self._state.ready = torch.cuda.Event()
            self._state.ready.record(torch.cuda.current_stream(stream.device))
        self._lock = self._state.lock
        # guarded by _lock: the consumer's side of the lifecycle
        self._thread = None
        self._closed = False
        self._exhausted = False
        self._error = None

    def _ensure_started(self):
        with self._lock:
            if self._closed:
                raise RuntimeError("DeviceFeed is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=_feed_worker, args=(self._state,),
                    name="DeviceFeed", daemon=True)
                self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        self._ensure_started()
        with self._lock:
            if self._exhausted:
                if self._error is not None:
                    raise self._error
                raise StopIteration
        state = self._state
        try:
            item = state.queue.get_nowait()
            starved_ms = 0.0
        except _queue.Empty:
            t0 = time.perf_counter()
            item = state.queue.get()
            starved_ms = (time.perf_counter() - t0) * 1e3
        if starved_ms:
            with self._lock:
                state.starved_ms += starved_ms
            if profiler.profiling_active():
                state.c_starved.set_value(starved_ms)
        if profiler.profiling_active():
            state.c_depth.set_value(state.queue.qsize())
        if item is _END:
            with self._lock:
                self._exhausted = True
            self._join()
            raise StopIteration
        if isinstance(item, _WorkerError):
            with self._lock:
                self._exhausted = True
                self._error = item.exc
            self._join()
            raise item.exc
        if state.stream is not None:
            _claim(item)
        return item

    def next(self):
        return self.__next__()

    def _join(self):
        with self._lock:
            thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(_JOIN_TIMEOUT_S)

    def close(self):
        """Stop the feed: idempotent and safe mid-epoch.  Wakes a worker
        blocked on the full queue, joins it and drops the batches not yet
        taken."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._exhausted = True
        state = self._state
        state.stop.set()
        while True:
            try:
                state.queue.get_nowait()
            except _queue.Empty:
                break
        self._join()
        # wake a consumer blocked in get() on another thread
        try:
            state.queue.put_nowait(_END)
        except _queue.Full:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter teardown: modules may be gone

    def stats(self):
        """``{"batches", "h2d_ms", "starved_ms", "max_queue_depth",
        "avg_h2d_ms"}``: totals since the feed started."""
        state = self._state
        with self._lock:
            batches = state.batches
            return {"batches": batches,
                    "h2d_ms": state.h2d_ms,
                    "starved_ms": state.starved_ms,
                    "max_queue_depth": state.max_depth,
                    "avg_h2d_ms": state.h2d_ms / batches if batches else 0.0}
