"""The robustness primitives every recoverable boundary shares
(counterpart of ``mxnet_tpu/util.py``): :func:`retry` (:49), and the
crash-consistent file writes of checkpoints, :func:`write_atomic` (:96)
and :func:`sha256_file` (:159).

The serving registry and the decode engine wrap each execution in
:func:`retry`, so that a transient failure costs latency instead of a
failed batch.  The retryable class is ``faults.TransientFault`` unless the
caller names others (``retryable=``); it is re-exported here as the JAX
package's ``util`` does.
"""
from __future__ import annotations

import functools
import os
import random as _random
import threading
import time as _time

from . import faults
from .faults import TransientFault

__all__ = ["TransientFault", "retry", "write_atomic", "sha256_file"]

# instance RNG (not the global random module): jitter draws must not
# perturb seeded streams
_JITTER_RNG = _random.Random(0x5EED)


def retry(attempts=3, backoff=0.01, jitter=0.5, retryable=None,
          on_retry=None):
    """Decorator: re-run the wrapped callable on a retryable failure.

    ``attempts`` total tries; sleep ``backoff * 2**i`` with up to ``jitter``
    fractional randomization between tries.  ``retryable`` is an exception
    class or a tuple of them (default :class:`TransientFault`).  ``on_retry(exc, attempt)`` is
    called before each re-try.  The last failure re-raises
    unchanged once attempts are exhausted.
    """
    if attempts < 1:
        raise ValueError("retry needs attempts >= 1, got %r" % attempts)

    kinds = TransientFault if retryable is None else retryable

    def decorate(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            for attempt in range(attempts):
                try:
                    return fn(*args, **kwargs)
                except kinds as exc:
                    if attempt == attempts - 1:
                        raise
                    if on_retry is not None:
                        on_retry(exc, attempt)
                    delay = backoff * (2 ** attempt)
                    if jitter:
                        delay *= 1.0 + jitter * _JITTER_RNG.random()
                    if delay > 0:
                        _time.sleep(delay)
        return wrapped
    return decorate


_ATOMIC_CHUNK = 4 << 20


def write_atomic(path, data):
    """All-or-nothing whole-file write: a sibling temporary file, fsync,
    then ``os.replace`` over ``path`` (and an fsync of the directory, the
    rename being the commit).  A crash at any point leaves the old
    complete file or the new one, never a torn one.

    ``data`` is bytes (or str, written as utf-8).  The temporary file is
    ``<path>.tmp-<pid>-<thread id>``, so two threads writing one path never
    share it; ``model.prune_checkpoints`` sweeps such files that a killed
    writer left.  Writes go in 4 MiB chunks with the fault sites
    ``checkpoint.write`` (after each chunk), ``checkpoint.replace`` (before
    the rename) and ``checkpoint.replaced`` (after it) between them.  A
    :class:`faults.SimulatedCrash` leaves the temporary file on disk, as
    ``kill -9`` would; any other failure removes it.
    """
    if isinstance(data, str):
        data = data.encode("utf-8")
    path = os.fspath(path)
    tmp = "%s.tmp-%d-%d" % (path, os.getpid(), threading.get_ident())
    f = open(tmp, "wb")
    try:
        total = len(data)
        written = 0
        while True:
            chunk = data[written:written + _ATOMIC_CHUNK]
            if chunk:
                f.write(chunk)
                written += len(chunk)
            faults.fault_point("checkpoint.write", path=path, fileobj=f,
                               written=written, total=total)
            if written >= total:
                break
        f.flush()
        os.fsync(f.fileno())
    except BaseException as exc:
        f.close()
        if not isinstance(exc, faults.SimulatedCrash):
            try:
                os.remove(tmp)
            except OSError:
                pass
        raise
    f.close()
    faults.fault_point("checkpoint.replace", path=path)
    os.replace(tmp, path)
    try:
        dirfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
    except OSError:
        pass   # a filesystem without directory fsync
    faults.fault_point("checkpoint.replaced", path=path)


def sha256_file(path, chunk=1 << 20):
    """Hex sha256 of a file's bytes (the checkpoint manifest's hashes)."""
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()
