"""Runtime device-memory accounting (counterpart of
``mxnet_tpu/memory_accounting.py``).

A thread-safe per-region byte accountant.  Producers call
:func:`record_alloc` / :func:`record_free` where device-sized buffers enter
and leave service: the paged KV cache at its four accounting increments
(attach, grow, copy-on-write fork, free), the decode engine when it makes
a set of K/V pools.  :func:`record_temp` charges a temporary to the
innermost :func:`track_region` scope of the calling thread, freed when the
scope ends.

The model is deliberately conservative: no buffer reuse, no aliasing.  A
region's ``peak_bytes`` is the worst-case sum of everything live at once
under a no-reuse allocator, the quantity the JAX package's static memory
pass predicts, so both packages report the same bytes for the same
geometry and traffic.

Counters mirror into profiler Counters ("C" trace events) in a "memory"
Domain, gated on ``profiler.profiling_active()``: an ungated per-alloc
write would grow the event buffer between dumps.
:func:`device_memory_stats` adds the CUDA caching allocator's own view
(``torch.cuda.memory_stats``) for each visible card, or None without one.
"""
from __future__ import annotations

import threading

_LOCK = threading.Lock()
# region -> {"allocs", "frees", "temps", "alloc_bytes", "freed_bytes",
#            "live_bytes", "peak_bytes"}
_REGIONS = {}
_PROF_COUNTERS = {}   # region -> profiler.Counter (live_bytes)
_TLS = threading.local()

_FIELDS = ("allocs", "frees", "temps", "alloc_bytes", "freed_bytes",
           "live_bytes", "peak_bytes")


def _mirror(region, live_bytes):
    """Profiler Counter mirror of a region's live bytes (gated)."""
    from . import profiler
    if not profiler.profiling_active():
        return
    with _LOCK:
        ctr = _PROF_COUNTERS.get(region)
        if ctr is None:
            ctr = profiler.Domain("memory").new_counter(
                "mem:%s:live" % region)
            _PROF_COUNTERS[region] = ctr
    ctr.set_value(live_bytes)


def _frames():
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def current_region():
    """The innermost :func:`track_region` scope on this thread, or None."""
    stack = _frames()
    return stack[-1][0] if stack else None


def record_alloc(nbytes, region=None, count=1):
    """Account ``count`` device allocation(s) totalling ``nbytes`` against
    ``region`` (default: the active :func:`track_region` scope, else
    "untracked")."""
    if region is None:
        region = current_region() or "untracked"
    nbytes = int(nbytes)
    with _LOCK:
        cell = _REGIONS.setdefault(region, dict.fromkeys(_FIELDS, 0))
        cell["allocs"] += count
        cell["alloc_bytes"] += nbytes
        cell["live_bytes"] += nbytes
        if cell["live_bytes"] > cell["peak_bytes"]:
            cell["peak_bytes"] = cell["live_bytes"]
        live = cell["live_bytes"]
    _mirror(region, live)
    return region


def record_free(nbytes, region=None, count=1):
    """Account ``count`` device free(s) totalling ``nbytes``."""
    if region is None:
        region = current_region() or "untracked"
    nbytes = int(nbytes)
    with _LOCK:
        cell = _REGIONS.setdefault(region, dict.fromkeys(_FIELDS, 0))
        cell["frees"] += count
        cell["freed_bytes"] += nbytes
        cell["live_bytes"] -= nbytes
        live = cell["live_bytes"]
    _mirror(region, live)
    return region


def record_temp(x_or_nbytes):
    """Account a region-scoped temporary (a staging buffer): allocated now,
    freed automatically when the innermost :func:`track_region` scope
    exits.  Accepts a tensor or array (``numel``/``size`` and the element
    size; unsized objects count 0 bytes)
    or a byte count.  No-op returning False when no scope is active, so
    that callers may call it unconditionally and unscoped execution stays
    free."""
    stack = _frames()
    if not stack:
        return False
    try:
        if hasattr(x_or_nbytes, "element_size"):      # a torch tensor
            nbytes = x_or_nbytes.numel() * x_or_nbytes.element_size()
        else:
            nbytes = int(x_or_nbytes.size) * x_or_nbytes.dtype.itemsize
    except (AttributeError, TypeError):
        try:
            nbytes = int(x_or_nbytes)
        except (TypeError, ValueError):
            nbytes = 0
    region = stack[-1][0]
    with _LOCK:
        cell = _REGIONS.setdefault(region, dict.fromkeys(_FIELDS, 0))
        cell["allocs"] += 1
        cell["temps"] += 1
        cell["alloc_bytes"] += nbytes
        cell["live_bytes"] += nbytes
        if cell["live_bytes"] > cell["peak_bytes"]:
            cell["peak_bytes"] = cell["live_bytes"]
        live = cell["live_bytes"]
    stack[-1][1] += nbytes
    stack[-1][2] += 1
    _mirror(region, live)
    return True


class track_region(object):
    """Context manager scoping :func:`record_temp` to a named region on the
    current thread.  On exit every temp recorded inside the scope is freed
    in one batch — the conservative no-reuse model: everything allocated in
    the region is live until the region ends, so ``peak_bytes`` is the sum
    of all temps (plus any explicit allocs charged to the same region)."""

    __slots__ = ("region",)

    def __init__(self, region):
        self.region = str(region)

    def __enter__(self):
        _frames().append([self.region, 0, 0])
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        region, temp_bytes, temp_count = _frames().pop()
        if temp_count:
            record_free(temp_bytes, region=region, count=temp_count)
        return False


def memory_counters():
    """Snapshot of the accountant: ``{region: {field: int}}`` with fields
    allocs/frees/temps/alloc_bytes/freed_bytes/live_bytes/peak_bytes."""
    with _LOCK:
        return {region: dict(cell) for region, cell in _REGIONS.items()}


def memory_totals(snapshot=None):
    """Aggregate a :func:`memory_counters` snapshot across regions.  Peak
    is summed (each region's worst case can land at a different instant;
    the sum is the conservative fleet-wide bound)."""
    snap = memory_counters() if snapshot is None else snapshot
    out = dict.fromkeys(_FIELDS, 0)
    for cell in snap.values():
        for field in _FIELDS:
            out[field] += cell.get(field, 0)
    return out


def region_peak_bytes(region):
    """A single region's ``peak_bytes`` (0 if never seen)."""
    with _LOCK:
        cell = _REGIONS.get(region)
        return cell["peak_bytes"] if cell else 0


def reset_memory_counters():
    """Zero the accountant (and drop the profiler Counter mirrors so a
    fresh profiling session starts its gauges from zero)."""
    with _LOCK:
        _REGIONS.clear()
        _PROF_COUNTERS.clear()


def device_memory_stats():
    """The CUDA caching allocator's own view of each visible card:
    ``{"cuda:i": torch.cuda.memory_stats(i)}``, or None without CUDA."""
    import torch
    if not torch.cuda.is_available():
        return None
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out["cuda:%d" % i] = dict(stats)
    return out or None
