"""Profiler (counterpart of ``mxnet_tpu/profiler.py``).

Reference: src/profiler/ + python/mxnet/profiler.py: op profiling into
chrome://tracing JSON (DumpProfile), an aggregate per-op table
(aggregate_stats.cc), user Domain/Task/Counter/Marker objects
(profiler.py:198-283), autostart through MXNET_PROFILER_AUTOSTART.

The host half is the JAX package's, event for event: ``set_config`` /
``set_state`` / ``dump`` / ``dumps`` and Domain, Task, Frame, Event,
Counter and Marker write chrome-trace events to one buffer, and the
aggregate table is made from their host timings.  The device half is
``torch.profiler``: ``set_state("run")`` starts it (CPU and, where there is
a card, CUDA activity), and stopping writes its chrome trace to
``<filename>_xplane/torch_trace.json``, the directory where the JAX package
keeps its XPlane trace.  Spans are ``torch.profiler.record_function``
ranges as well, so they show on that trace beside the kernels.
"""
from __future__ import annotations

import os
import time
import json
import threading
from collections import defaultdict

__all__ = ["set_config", "set_state", "state", "dump", "dumps", "merge_dumps",
           "pause", "resume", "memory_summary",
           "Domain", "Task", "Frame", "Event", "Counter", "Marker"]

_config = {"profile_all": False, "profile_symbolic": True, "profile_imperative": True,
           "profile_memory": False, "profile_api": False,
           "filename": "profile.json", "aggregate_stats": False}
_state = {"running": False, "trace_dir": None, "device_trace": None}
_events = []
_lock = threading.Lock()
_agg = defaultdict(lambda: [0, 0.0])  # name -> [count, total_ms]


def set_config(**kwargs):
    with _lock:
        _config.update(kwargs)


def set_state(state_="stop", profile_process="worker"):
    return _set_state(state_, fresh=True)


def _start_device_trace():
    """A started ``torch.profiler.profile`` (CPU, and CUDA with a card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_device_trace(prof, trace_dir):
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "torch_trace.json"))


def _set_state(state_, fresh):
    if state_ == "run":
        with _lock:
            if _state["running"]:
                return       # atomic check-and-claim: one starter wins
            _state["running"] = True
            if fresh:
                # each session is a fresh trace: without this, a long-lived
                # process that profiles periodically re-emits every prior
                # session's spans on dump() and grows the buffer unboundedly.
                # resume() passes fresh=False so a pause/resume cycle keeps
                # the pre-pause spans.  The per-op aggregate table resets
                # with the trace.
                _events.clear()
                _agg.clear()
            trace_dir = os.path.splitext(_config["filename"])[0] + "_xplane"
        # torch.profiler starts unlocked; the claim above excludes a second
        # start, but a concurrent stop() may land in this window — detected
        # and honored below
        try:
            prof = _start_device_trace()
        except Exception:
            prof = None
        with _lock:
            if _state["running"]:
                _state["trace_dir"] = trace_dir
                _state["device_trace"] = prof
                prof = None
        if prof is not None:
            # a stop() interleaved before our trace existed and could not
            # stop it; honor the stop rather than leak an active trace
            try:
                prof.stop()
            except Exception:
                pass
    elif state_ == "stop":
        with _lock:
            if not _state["running"]:
                return
            _state["running"] = False
            trace_dir = _state["trace_dir"]
            prof = _state["device_trace"]
            _state["trace_dir"] = None
            _state["device_trace"] = None
        if prof is not None:
            try:
                _stop_device_trace(prof, trace_dir)
            except Exception:
                pass


def state():
    return "run" if _state["running"] else "stop"


def pause(profile_process="worker"):
    _set_state("stop", fresh=False)


def resume(profile_process="worker"):
    _set_state("run", fresh=False)


def profiling_imperative():
    """True when imperative op dispatch should be recorded — the gate the
    dispatch hot path checks (ProfileOperator's `IsProfiling` analog)."""
    return _state["running"] and _config.get("profile_imperative", True)


def profiling_active():
    """True while a profiling session is running.

    High-rate counter writers (the serving queue-depth / batch-latency
    gauges update on every request) must gate on this: Counter.set_value
    appends a trace event unconditionally, so an ungated per-request update
    in a long-lived server grows the event buffer without bound between
    dumps."""
    return _state["running"]


def record_op_span(name, t0_s, t1_s, cat="operator"):
    """One imperative op dispatch: B/E trace events + aggregate-table bump
    (src/profiler ProfileOperator analog).  Times are ``time.time()``
    seconds (the same timebase _record uses, so spans line up with
    Domain/Task events in the dumped trace) and measure host dispatch
    cost; device-side op timing is the torch.profiler trace captured
    alongside (see set_state)."""
    with _lock:
        for ph, ts in (("B", t0_s), ("E", t1_s)):
            _events.append({"name": name, "cat": cat, "ph": ph,
                            "ts": ts * 1e6, "pid": os.getpid(),
                            "tid": threading.get_ident(), "args": {}})
        a = _agg[name]
        a[0] += 1
        a[1] += (t1_s - t0_s) * 1e3


def _record(name, cat, ph, ts=None, args=None):
    with _lock:
        _events.append({"name": name, "cat": cat, "ph": ph,
                        "ts": (ts if ts is not None else time.time() * 1e6),
                        "pid": os.getpid(), "tid": threading.get_ident(),
                        "args": args or {}})


def dump(finished=True, profile_process="worker"):
    """Write accumulated host events as chrome://tracing JSON; the
    device-side torch.profiler trace (if any) is in <filename>_xplane.
    ``finished=True`` (the reference default) also retires the event
    buffer, so a later session starts clean."""
    with _lock:
        payload = {"traceEvents": list(_events)}
        if finished:
            _events.clear()
    with open(_config["filename"], "w") as f:
        json.dump(payload, f)


def dumps(reset=False):
    """Return the aggregate per-op stats table (aggregate_stats.cc analog)."""
    lines = ["%-40s %10s %14s %14s" % ("Name", "Calls", "Total(ms)", "Avg(ms)")]
    with _lock:
        for name, (cnt, total) in sorted(_agg.items(), key=lambda kv: -kv[1][1]):
            lines.append("%-40s %10d %14.3f %14.3f"
                         % (name, cnt, total, total / max(cnt, 1)))
        if reset:
            _agg.clear()
    return "\n".join(lines)


def memory_summary(device=None):
    """Live-allocation table: one row per (dtype, shape) bucket of the
    tensors alive on ``device`` (every device if None), sorted by resident
    bytes: the storage-profiler analog (reference
    src/profiler/storage_profiler.h).  A storage shared by several views
    counts once, under the first tensor found over it.  With a CUDA card
    the caching allocator's allocated and reserved bytes follow the total
    (``torch.cuda.memory_stats``): its view includes what no live tensor
    holds (graph pools, workspaces).

    Returns the formatted table; the TOTAL line sums bytes and count."""
    import gc

    import torch
    want = None if device is None else torch.device(device)
    buckets = defaultdict(lambda: [0, 0])   # (dtype, shape) -> [count, bytes]
    seen = set()
    total = n = 0
    for obj in gc.get_objects():
        try:
            # type(), not isinstance: isinstance reads __class__, which some
            # lazy module objects answer with a deprecation warning
            if not issubclass(type(obj), torch.Tensor) or obj.is_meta:
                continue
            dev = obj.device
            if want is not None and (dev.type != want.type or (
                    want.index is not None and dev.index != want.index)):
                continue
            storage = obj.untyped_storage()
            key = (str(dev), storage.data_ptr())
            if key in seen:
                continue
            seen.add(key)
            nbytes = storage.nbytes()
        except Exception:
            continue
        bucket = buckets[(str(obj.dtype).replace("torch.", ""),
                          tuple(obj.shape))]
        bucket[0] += 1
        bucket[1] += nbytes
        total += nbytes
        n += 1
    lines = ["%-12s %-28s %8s %14s" % ("Dtype", "Shape", "Count", "Bytes")]
    for (dt, shp), (cnt, b) in sorted(buckets.items(),
                                      key=lambda kv: -kv[1][1]):
        lines.append("%-12s %-28s %8d %14d" % (dt, str(shp), cnt, b))
    lines.append("%-12s %-28s %8d %14d" % ("TOTAL", "", n, total))
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            if want is not None and (want.type != "cuda" or (
                    want.index is not None and want.index != i)):
                continue
            stats = torch.cuda.memory_stats(i)
            lines.append("%-12s %-28s %8s %14d" % (
                "cuda:%d" % i, "allocated", "",
                stats.get("allocated_bytes.all.current", 0)))
            lines.append("%-12s %-28s %8s %14d" % (
                "cuda:%d" % i, "reserved", "",
                stats.get("reserved_bytes.all.current", 0)))
    return "\n".join(lines)


def merge_dumps(filenames, out=None):
    """Aggregate per-op stats across several workers' trace dumps
    (the distributed analog of ``dumps()``; reference server-side profiling,
    include/mxnet/kvstore.h:49 SetServerProfilerCommand +
    tests/nightly/test_server_profiling.py).

    ``filenames``: per-rank chrome-trace JSON files written by ``dump()``.
    ``out``: optional path for the combined trace (events from all ranks in
    one timeline; pids distinguish the workers).  Returns the merged table.
    """
    events = []
    for fn in filenames:
        with open(fn) as f:
            events.extend(json.load(f).get("traceEvents", []))
    if out is not None:
        with open(out, "w") as f:
            json.dump({"traceEvents": events}, f)
    # pair B/E spans per (worker pid, thread, name) to recover durations
    open_spans = defaultdict(list)
    agg = defaultdict(lambda: [0, 0.0])
    for ev in sorted(events, key=lambda e: e.get("ts", 0)):
        name = ev.get("name")
        if name is None or ev.get("ph") not in ("B", "E"):
            # external tools emit name-less metadata ('M') events; skip
            # anything that isn't a named duration span
            continue
        key = (ev.get("pid"), ev.get("tid"), name)
        if ev.get("ph") == "B":
            open_spans[key].append(ev["ts"])
        elif open_spans[key]:
            begin = open_spans[key].pop()
            entry = agg[name]
            entry[0] += 1
            entry[1] += (ev["ts"] - begin) / 1e3
    lines = ["%-40s %10s %14s %14s" % ("Name", "Calls", "Total(ms)",
                                       "Avg(ms)")]
    for name, (cnt, total) in sorted(agg.items(), key=lambda kv: -kv[1][1]):
        lines.append("%-40s %10d %14.3f %14.3f"
                     % (name, cnt, total, total / max(cnt, 1)))
    return "\n".join(lines)


class Domain:
    def __init__(self, name):
        self.name = name

    def __str__(self):
        return self.name

    def new_task(self, name):
        return Task(self, name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)


class _Span:
    def __init__(self, domain, name):
        self.domain = domain
        self.name = name
        self._start = None
        self._annotation = None

    def start(self):
        import torch
        self._start = time.time()
        _record(self.name, str(self.domain), "B")
        try:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        except Exception:
            self._annotation = None
        return self

    def stop(self):
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        _record(self.name, str(self.domain), "E")
        if self._start is not None:
            with _lock:
                a = _agg[self.name]
                a[0] += 1
                a[1] += (time.time() - self._start) * 1e3
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()


class Task(_Span):
    pass


class Frame(_Span):
    pass


class Event(_Span):
    def __init__(self, name):
        super().__init__(Domain("event"), name)


class Counter:
    def __init__(self, domain, name, value=None):
        self.domain = domain
        self.name = name
        self._value = 0
        if value is not None:
            self.set_value(value)

    def set_value(self, value):
        self._value = value
        _record(self.name, str(self.domain), "C", args={"value": value})

    def increment(self, delta=1):
        self.set_value(self._value + delta)

    def decrement(self, delta=1):
        self.set_value(self._value - delta)

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self


class Marker:
    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        _record(self.name, str(self.domain), "i", args={"s": scope[0]})


# env autostart (reference: MXNET_PROFILER_AUTOSTART, docs/faq/env_var.md:152
# — begin profiling at import so short scripts profile without code changes;
# registered in env.py); a failing device profiler cannot break import.
if os.environ.get("MXNET_PROFILER_AUTOSTART", "0").lower() in ("1", "true"):
    try:
        set_state("run")
    except Exception:
        pass
