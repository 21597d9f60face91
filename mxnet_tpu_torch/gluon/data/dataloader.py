"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``,
:1-403).

Worker processes produce numpy samples over a persistent pool (a
``multiprocessing.Pool``, or a ``ThreadPool`` with ``thread_pool=True``);
``num_workers=0`` loads on the iterating thread.  Each worker process
runs one intra-op thread, as PyTorch's DataLoader workers do: OpenMP
(libgomp) is not fork-safe, and on the H100 machine a forked child whose
parent had run a parallel CPU op hung in its own first one.  Batchify
runs in the parent, so the batches are CPU NDArrays:

* default path: samples (from the workers or the caller's thread) are
  batchified in the consumer.  No background thread;
* ``pin_memory=True``: batchify moves to a ``DeviceFeed`` thread that
  stages each batch into page-locked host memory (``cpu_pinned``);
* ``prefetch_to_device=ctx``: the same thread, and each batch lands on the
  card one to two batches ahead of the consumer (``io.DeviceFeed``: pinned
  memory, a copy on the feed's CUDA stream).  Supersedes ``pin_memory``.

The epoch's order is drawn on the thread that calls ``iter(loader)``, so
the feed paths shuffle as the sync path does under one
``mx.random.seed`` (the JAX package draws it on the feed's thread).

A worker process never touches the card (a forked child cannot use the
parent's CUDA context): workers return numpy samples, and a dataset that
holds
CUDA tensors is refused with ``num_workers > 0`` unless
``thread_pool=True`` (a divergence from the JAX package, whose forked
workers may read device arrays).

Lifecycle: the pool persists across epochs.  ``close()`` drains the
results in flight (a worker's exception cannot strand the pool), closes
and joins the pool (``terminate()`` for a worker wedged past 5 s) and is
idempotent; the loader is a context manager and ``__del__`` calls
``close()``.  Each ``__iter__`` builds its own iterator (and feed), so
epochs may run concurrently.  A batch whose worker died of a retryable
fault is resubmitted; ``worker_timeout`` bounds the wait for one batch.
"""
from __future__ import annotations

import itertools
import multiprocessing as _mp
import threading

import numpy as _np

import torch

from ...base import MXNetError
from ...context import PinnedCPU, cpu, cpu_pinned
from ...ndarray import NDArray
from ...ndarray.ndarray import array, stack
from .sampler import BatchSampler, RandomSampler, SequentialSampler


def default_batchify_fn(data):
    """Stack samples into one batch, a CPU NDArray (a list of them for
    tuple samples)."""
    if isinstance(data[0], NDArray):
        return stack(*data, axis=0)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = _np.asarray(data)
    return array(data, ctx=cpu(), dtype=data.dtype)


def default_mp_batchify_fn(data):
    return default_batchify_fn(data)


class _SimpleIter:
    """num_workers=0: samples load on whichever thread iterates (the
    consumer on the default path, the feed's thread on the feed paths).
    The first batch of indices is drawn here, on the thread that makes the
    iterator, so that a ``RandomSampler`` shuffles from that thread's
    seeded stream: the feed's thread has a stream of its own, which
    ``mx.random.seed`` does not reach (the JAX package draws there, so its
    feed paths shuffle otherwise than its sync path)."""

    def __init__(self, loader):
        self._loader = loader
        it = iter(loader._batch_sampler)
        first = next(it, None)
        self._iter = it if first is None else itertools.chain([first], it)

    def __iter__(self):
        return self

    def __next__(self):
        batch_indices = next(self._iter)
        dataset = self._loader._dataset
        return [dataset[i] for i in batch_indices]


_worker_dataset = None
_worker_dataset_lock = threading.Lock()


def _process_worker_init(dataset):
    """A worker process's: one intra-op thread (the parent's OpenMP pool
    does not survive the fork), then the dataset."""
    torch.set_num_threads(1)
    _worker_init(dataset)


def _worker_init(dataset):
    # process-pool workers each run this once in their own process, but the
    # ThreadPool fallback runs it once per *thread* in one process — the
    # lock makes the publish safe either way
    global _worker_dataset
    with _worker_dataset_lock:
        _worker_dataset = dataset


_CUDA_IN_WORKERS = (
    "the dataset holds CUDA tensors, and DataLoader's worker processes "
    "must not touch CUDA (a forked child cannot use the parent's CUDA "
    "context): keep the dataset's arrays on the host, or pass "
    "num_workers=0 or thread_pool=True")


def _is_cuda(x):
    t = x._data if isinstance(x, NDArray) else x
    return isinstance(t, torch.Tensor) and t.is_cuda


def _holds_cuda(obj, depth=3):
    """Whether ``obj`` (a dataset, its attributes, their lists, tuples and
    dicts, ``depth`` levels down) holds a CUDA tensor.  Reads no sample."""
    if _is_cuda(obj):
        return True
    if depth == 0 or isinstance(obj, (str, bytes, _np.ndarray)):
        return False
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        items = list(obj[:16])
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        items = list(vars(obj).values())
    else:
        return False
    return any(_holds_cuda(o, depth - 1) for o in items)


def _load(batch_indices, refuse_cuda):
    # paired with _worker_init's locked publish: in a ThreadPool the
    # initializer and the first work item can run on different threads.
    # The fault plan is the caller's with thread_pool=True; a forked
    # worker holds its own copy of the one active at the fork
    from ...faults import fault_point
    fault_point("dataloader.worker", batch_indices=tuple(batch_indices))
    with _worker_dataset_lock:
        dataset = _worker_dataset
    samples = [dataset[i] for i in batch_indices]

    def to_np(s):
        if refuse_cuda and _is_cuda(s):
            raise MXNetError(_CUDA_IN_WORKERS)
        if isinstance(s, NDArray):
            return s.asnumpy()
        if isinstance(s, tuple):
            return tuple(to_np(x) for x in s)
        return s
    return [to_np(s) for s in samples]


def _worker_fn(batch_indices):
    return _load(batch_indices, refuse_cuda=False)


def _fork_worker_fn(batch_indices):
    """A forked worker's: a CUDA sample raises, naming the cause, before
    anything reads it."""
    return _load(batch_indices, refuse_cuda=True)


class _MultiWorkerIter:
    """Sample batches from the loader's persistent pool, ``prefetch``
    submissions ahead.  Yields raw sample lists; batchify is the caller's
    (or the feed thread's) job.

    Worker-death recovery (docs/ROBUSTNESS.md): a batch whose worker died
    with a *retryable* failure is resubmitted to the (persistent) pool up
    to ``_RESUBMIT_ATTEMPTS`` times before the failure surfaces — a single
    flaky worker blip costs one extra round-trip, not the epoch."""

    _RESUBMIT_ATTEMPTS = 3

    def __init__(self, loader):
        self._loader = loader
        self._iter = iter(loader._batch_sampler)
        self._pending = []   # [batch_indices, AsyncResult] pairs, in order
        for _ in range(loader._prefetch):
            self._push_next()

    def _push_next(self):
        try:
            batch_indices = next(self._iter)
        except StopIteration:
            return
        result = self._loader._submit(batch_indices)
        self._pending.append([batch_indices, result])

    def _wait(self, result):
        # bounded waits so a concurrent close() (which may terminate()
        # a wedged pool — terminated pools never complete outstanding
        # results) surfaces as an error here instead of hanging this
        # consumer in an untimed get() forever.  The cumulative cap
        # (loader.worker_timeout) covers the worker-DEATH case: a pool
        # worker killed outright (SIGKILL, simulated crash) never posts
        # its AsyncResult at all, and without a ceiling this loop would
        # wedge for the life of the process
        import time as _time
        deadline = (None if self._loader._worker_timeout is None
                    else _time.monotonic() + self._loader._worker_timeout)
        while True:
            try:
                return result.get(timeout=1.0)
            except _mp.TimeoutError:
                with self._loader._lock:
                    closed = self._loader._closed
                if closed:
                    raise RuntimeError(
                        "DataLoader was closed during iteration")
                if deadline is not None and _time.monotonic() >= deadline:
                    raise RuntimeError(
                        "DataLoader batch did not arrive within "
                        "worker_timeout=%.0fs — a pool worker likely died "
                        "without returning (killed process?); close() the "
                        "loader or raise worker_timeout for slow datasets"
                        % self._loader._worker_timeout)

    def __iter__(self):
        return self

    def __next__(self):
        from ...faults import is_retryable
        if not self._pending:
            raise StopIteration
        batch_indices, result = self._pending.pop(0)
        self._push_next()
        for attempt in range(self._RESUBMIT_ATTEMPTS):
            try:
                try:
                    return self._wait(result)
                finally:
                    # success or worker exception, the result is no longer
                    # in flight — close() must not wait on it
                    self._loader._untrack(result)
            except Exception as exc:
                if not is_retryable(exc) or \
                        attempt == self._RESUBMIT_ATTEMPTS - 1:
                    raise
                # worker died on a retryable fault: same indices, new
                # submission (sample order is preserved — the retried batch
                # keeps its position in the epoch)
                result = self._loader._submit(batch_indices)

    def __del__(self):
        # an epoch abandoned mid-stream must not strand its prefetch
        # window in the loader's in-flight bookkeeping forever (each
        # completed AsyncResult retains a whole batch payload).  Only
        # completed results are dropped — still-running ones stay visible
        # to close()'s bounded drain / wedged-worker detection.
        try:
            for _indices, result in self._pending:
                if result.ready():
                    self._loader._untrack(result)
        except Exception:
            pass  # interpreter teardown


class _BatchifyIter:
    """Synchronous tail of the default path: batchify in the consumer."""

    def __init__(self, base, batchify_fn):
        self._base = base
        self._batchify_fn = batchify_fn

    def __iter__(self):
        return self

    def __next__(self):
        return self._batchify_fn(next(self._base))


class DataLoader:
    """Loads data from a dataset and returns mini-batches.

    See the module docstring for the pipeline/lifecycle contract and
    docs/PERF.md ("Input pipeline & overlap") for how the feed paths
    compose with training.

    Parameters beyond the reference set:

    prefetch : int, optional
        How many batch submissions each epoch keeps in flight in the
        worker pool (default ``max(2 * num_workers, 4)``; reference
        contrib DataLoader semantics).
    pin_memory : bool
        Batches are staged into page-locked host memory on a background
        feed thread.
    prefetch_to_device : device, optional
        Stage batches onto this device ahead of the consumer (the
        ``DeviceFeed`` path).
    worker_timeout : float or None
        Max seconds to wait for any single batch from the worker pool
        (default 300).  A pool worker killed outright never posts its
        result; the ceiling turns that permanent hang into a RuntimeError.
        ``None`` disables it.
    """

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, prefetch_to_device=None,
                 worker_timeout=300.0):
        self._dataset = dataset
        # ceiling on waiting for ONE batch from the pool: a worker process
        # killed outright never posts its result, and an unbounded wait
        # would wedge the consumer forever (docs/ROBUSTNESS.md).  None
        # disables the ceiling for datasets with legitimately unbounded
        # per-batch latency.
        self._worker_timeout = (None if worker_timeout is None
                                else float(worker_timeout))
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler is "
                                 "specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch must "
                             "not be specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = num_workers if num_workers >= 0 else 0
        if prefetch is not None and int(prefetch) < 1:
            raise ValueError("prefetch must be >= 1, got %r" % (prefetch,))
        self._prefetch = (int(prefetch) if prefetch is not None
                          else max(2 * self._num_workers, 4))
        self._pin_memory = bool(pin_memory)
        if prefetch_to_device is not None and not isinstance(
                prefetch_to_device, (torch.device, str, PinnedCPU)):
            raise TypeError("prefetch_to_device expects a device (e.g. "
                            "mx.gpu(0)), got %r" % (prefetch_to_device,))
        self._prefetch_to_device = prefetch_to_device
        if batchify_fn is None:
            self._batchify_fn = default_batchify_fn
        else:
            self._batchify_fn = batchify_fn
        # lifecycle state, guarded by _lock: the pool is shared by every
        # iterator this loader hands out, and close() races __iter__/
        # __next__ by design (close from another thread must be safe)
        self._lock = threading.Lock()
        self._closed = False
        self._in_flight = []      # AsyncResults not yet consumed
        self._pool = None
        self._work = _worker_fn
        if self._num_workers > 0 and not thread_pool:
            if _holds_cuda(dataset):
                raise MXNetError(_CUDA_IN_WORKERS)
            self._work = _fork_worker_fn
        if self._num_workers > 0:
            if thread_pool:
                from multiprocessing.pool import ThreadPool
                self._pool = ThreadPool(self._num_workers,
                                        initializer=_worker_init,
                                        initargs=(self._dataset,))
            else:
                ctx = _mp.get_context("fork")
                self._pool = ctx.Pool(self._num_workers,
                                      initializer=_process_worker_init,
                                      initargs=(self._dataset,))

    # -- pool plumbing (shared by concurrent iterators) -----------------
    def _submit(self, batch_indices):
        with self._lock:
            if self._closed:
                raise RuntimeError("DataLoader is closed")
            # backstop for abandoned epochs: completed results nobody will
            # consume must not accumulate across the loader's lifetime
            self._in_flight = [r for r in self._in_flight if not r.ready()]
            result = self._pool.apply_async(self._work, (batch_indices,))
            self._in_flight.append(result)
        return result

    def _untrack(self, result):
        with self._lock:
            try:
                self._in_flight.remove(result)
            except ValueError:
                pass   # already drained by close()

    # -- iteration ------------------------------------------------------
    def __iter__(self):
        with self._lock:
            if self._closed:
                raise RuntimeError("DataLoader is closed")
        base = (_SimpleIter(self) if self._num_workers == 0
                else _MultiWorkerIter(self))
        ctx = self._prefetch_to_device
        if ctx is None and not self._pin_memory:
            return _BatchifyIter(base, self._batchify_fn)
        if ctx is None:
            ctx = cpu_pinned()
        from ...io.device_feed import DeviceFeed
        return iter(DeviceFeed(base, ctx=ctx, depth=2,
                               transform=self._batchify_fn,
                               name="dataloader"))

    def __len__(self):
        return len(self._batch_sampler)

    # -- lifecycle ------------------------------------------------------
    def close(self):
        """Tear the worker pool down deterministically.  Idempotent.

        Drains results still in flight first (waiting, not raising — a
        worker exception belongs to the iterator that submitted it), then
        close()+join()s the pool so workers exit cleanly instead of the
        historical bare ``terminate()``.  A worker wedged past the drain
        timeout (hung ``__getitem__``) falls back to ``terminate()`` —
        ``pool.join()`` has no timeout, and a ``close()`` that can hang
        forever (reachable from ``__del__``) is worse than a hard stop.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pool, self._pool = self._pool, None
            in_flight, self._in_flight = self._in_flight, []
        if pool is None:
            return
        # one shared deadline across the whole drain — per-result waits
        # would stack to 5s * prefetch-window on a wedged worker, and
        # close() is reachable from __del__/GC
        import time as _time
        deadline = _time.monotonic() + 5.0
        wedged = False
        for result in in_flight:
            try:
                result.wait(timeout=max(0.0, deadline - _time.monotonic()))
                wedged = wedged or not result.ready()
            except Exception:
                pass
        if wedged:
            pool.terminate()
        else:
            pool.close()
        pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter teardown: pool internals may be half-gone
