"""Structured stage timing and the device trace (port of
utils/profiling.py).

The reference instruments stage wall-times ad hoc (optimizer.cpp:294-344
chrono spans, mpc.cpp:339-344 EWMA latency log, RViz text markers as a
live dashboard).  Here the same signals are structured: named stages
with EWMA smoothing on the host clock, queryable as a dict, and a
`torch.profiler` context for per-kernel device timelines.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict

import torch

# Chrome-trace categories of device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class StageTimer:
    """EWMA per-stage wall-clock timing (mpc.cpp:340 smoothing = 0.9).
    Host clock: a stage that launches device work and does not wait for
    it measures the launch, not the work."""

    alpha: float = 0.9
    ewma: Dict[str, float] = field(default_factory=dict)
    last: Dict[str, float] = field(default_factory=dict)
    count: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.last[name] = dt
            self.count[name] = self.count.get(name, 0) + 1
            prev = self.ewma.get(name)
            self.ewma[name] = dt if prev is None \
                else self.alpha * prev + (1.0 - self.alpha) * dt

    def report(self) -> str:
        rows = [f"{k}: {v * 1e3:.2f} ms (last {self.last[k] * 1e3:.2f}, "
                f"n={self.count[k]})" for k, v in sorted(self.ewma.items())]
        return "\n".join(rows)


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
