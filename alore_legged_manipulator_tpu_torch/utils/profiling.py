"""Spans and counters of the program's layers, and the device trace
(port of utils/profiling.py).

The reference instruments stage wall-times ad hoc (optimizer.cpp:294-344
chrono spans, mpc.cpp:339-344 EWMA latency log, RViz text markers as a
live dashboard).  Here one tracer records them at the program's layer
boundaries: `span(name)` around a layer, `count(name, n)` charged to the
innermost open span; `device_trace` is a `torch.profiler` context for
per-kernel device timelines.

The tracer is off by default, and a span then costs one flag check: it
enters no `record_function`, allocates nothing and touches no CUDA
setting.  It is on while a `torch.profiler` records in this process, or
between `enable()` and `disable()`.  While on, each span keeps, in a
bounded buffer: its name, its start and end on the host (`time.time_ns`,
the Unix-epoch clock `torch.profiler` stamps its events with, so a span
lies over the device timeline), its id, its parent's id and the id of
its root (one request: a tick).  Under a profiler it also opens
`record_function(name)`, so the Chrome trace shows it beside the
kernels.  Once CUDA is initialised it records CUDA events at its start
and end on the current stream: the stream's time across the span, idle
included, read by `snapshot()` and never waited for inside the span.
While a root span is open, every synchronising CUDA call is counted as
`host_syncs` (torch.cuda's sync debug mode at "warn", its warnings
caught and charged to the innermost open span, the mode restored on
exit).  The span stack is per thread; the sync debug mode and the
warning hook are the process's, so one thread traces at a time.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import warnings
from collections import defaultdict

import torch

# Chrome-trace categories of device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

SYNC_COUNTER = "host_syncs"
# torch's warning for each synchronising CUDA call in sync debug mode, and
# the one it gives once when the mode is first set
_SYNC_WARNING = "called a synchronizing CUDA operation"
_MODE_WARNING = "Synchronization debug mode is a prototype feature"
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Off:
    """What `span` returns while the tracer is off: records nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _SyncCount:
    """Counts every synchronising CUDA call made while open as
    `host_syncs` of the tracer's innermost open span; other warnings
    pass on.  A mode of "error" set by the caller is left as it is."""

    def __init__(self, tracer):
        self.tracer = tracer

    def __enter__(self):
        self._mode = torch.cuda.get_sync_debug_mode()
        self._caught = warnings.catch_warnings()
        self._caught.__enter__()
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        warnings.filterwarnings("ignore", message=_MODE_WARNING)
        self._show = warnings.showwarning
        warnings.showwarning = self._on_warning
        if self._mode == 0:                  # 1 is "warn", 2 "error"
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None):
        if str(message).startswith(_SYNC_WARNING):
            self.tracer._charge(SYNC_COUNTER, 1)
        else:
            self._show(message, category, filename, lineno, file, line)

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self._mode)
        self._caught.__exit__(*exc)
        return False


class _Span:
    """One open span of a tracer that is on; kept when it closes."""
    __slots__ = ("tracer", "name", "lanes", "id", "parent", "root",
                 "start_ns", "end_ns", "counts", "events", "stream_ms",
                 "_rf", "_sync")

    def __init__(self, tracer, name, lanes):
        self.tracer, self.name, self.lanes = tracer, name, lanes
        self.id = next(tracer._ids)
        self.counts = {}
        self.events = self.stream_ms = self._rf = self._sync = None

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        cuda = torch.cuda.is_initialized()
        if not stack and cuda:
            self.counts[SYNC_COUNTER] = 0
            self._sync = _SyncCount(tr).__enter__()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.events = (start, None)
        stack.append(self)
        # the host clock brackets the profiler's event of the same name
        self.start_ns = tr.clock()
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.end_ns = tr.clock()
        tr._stack().pop()
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events = (self.events[0], end)
        if self._sync is not None:
            self._sync.__exit__(*exc)
            self._sync = None
        tr._keep(self)
        return False


class Tracer:
    """Spans and counters of one process's requests (the module's
    `TRACER` is the program's); `clock` returns host nanoseconds on the
    profiler's clock.  At most `capacity` spans are kept."""

    capacity = 1 << 16

    def __init__(self, clock=time.time_ns):
        self.clock = clock
        self._enabled = False
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._records = []
        self.dropped = 0

    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    def reset(self):
        """Forget every span kept so far."""
        self._records = []
        self.dropped = 0

    def span(self, name: str, lanes: int = None):
        """A context manager around one layer; `lanes` the batch it
        carries.  Off: the shared no-op."""
        if not (self._enabled or _profiler_enabled()):
            return _OFF
        return _Span(self, name, lanes)

    def count(self, name: str, n: int = 1):
        """Add n to counter `name` of the innermost open span."""
        if self._enabled or _profiler_enabled():
            self._charge(name, n)

    def _charge(self, name, n):
        stack = self._stack()
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n

    def _stack(self):
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _keep(self, span):
        if len(self._records) < self.capacity:
            self._records.append(span)
        else:
            self.dropped += 1

    def snapshot(self) -> dict:
        """{"records": every kept span (name, id, parent, root, start_ns,
        end_ns, lanes, counts, stream_ms), "requests": per root span, its
        name and lanes and, per span name under it, the number of spans
        `n`, their host time `host_ms`, self time `self_ms` (each span's
        duration less its children's), stream time `stream_ms` (None
        without CUDA events) and counters; the root's counters summed in
        `counts`, "dropped": spans past the capacity}.  Waits for the
        CUDA events of the spans kept, never inside one."""
        records = []
        for s in self._records:
            if s.events is not None:
                start, end = s.events
                end.synchronize()
                s.stream_ms, s.events = start.elapsed_time(end), None
            records.append({"name": s.name, "id": s.id, "parent": s.parent,
                            "root": s.root, "start_ns": s.start_ns,
                            "end_ns": s.end_ns, "lanes": s.lanes,
                            "counts": dict(s.counts),
                            "stream_ms": s.stream_ms})
        child_ns = defaultdict(int)
        for r in records:
            if r["parent"] is not None:
                child_ns[r["parent"]] += r["end_ns"] - r["start_ns"]
        requests = {}
        for r in records:
            q = requests.setdefault(r["root"], {"name": None, "lanes": None,
                                                "spans": {}, "counts": {}})
            if r["id"] == r["root"]:
                q["name"], q["lanes"] = r["name"], r["lanes"]
            a = q["spans"].setdefault(r["name"], {
                "n": 0, "host_ms": 0.0, "self_ms": 0.0, "stream_ms": 0.0,
                "counts": {}})
            dur = r["end_ns"] - r["start_ns"]
            a["n"] += 1
            a["host_ms"] += dur * 1e-6
            a["self_ms"] += (dur - child_ns[r["id"]]) * 1e-6
            a["stream_ms"] = None if a["stream_ms"] is None \
                or r["stream_ms"] is None else a["stream_ms"] + r["stream_ms"]
            for k, v in r["counts"].items():
                a["counts"][k] = a["counts"].get(k, 0) + v
                q["counts"][k] = q["counts"].get(k, 0) + v
        return {"records": records,
                # a request whose root span was dropped is left out
                "requests": [q for q in requests.values()
                             if q["name"] is not None],
                "dropped": self.dropped}


TRACER = Tracer()
span, count = TRACER.span, TRACER.count
enable, disable = TRACER.enable, TRACER.disable
snapshot, reset = TRACER.snapshot, TRACER.reset


@contextlib.contextmanager
def device_trace(log_dir: str):
    """`torch.profiler` trace of the block: host activity and, where a
    card is present, its kernels and copies.  On exit the Chrome trace is
    written to `<log_dir>/trace.json`.  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def trace_summary(path: str) -> dict:
    """From a Chrome trace (`device_trace`'s): the number of kernels, the
    device-busy time (the union of kernel, copy and set intervals), the
    window from the first event's start to the last one's end, and the
    busy share of that window.  Times in microseconds."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, float("-inf")
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    if events:
        lo = min(float(e["ts"]) for e in events)
        hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    else:
        lo = hi = 0.0
    window = hi - lo
    return {"kernels": sum(e.get("cat") == "kernel" for e in events),
            "device_busy_us": busy, "window_us": window,
            "busy_share": busy / window if window > 0 else 0.0}
