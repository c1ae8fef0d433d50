"""A bounded stretch of a run, traced under `torch.profiler` and reduced
in memory.

The stretch (the next ticks of the loop, or plan calls) runs first with
the card's activity alone.  Its host-clock span, from a synchronize
before it to one after it, is the window; the device operations
(kernels, copies, sets) of that same pass are counted, and their union
is the busy time.  The profiler's callback on every launch slows a
launch-bound stretch, so the window is longer than the same work
untraced and reads as more idle: the idle share is that of the traced
timeline, and PERF.md gives the overhead.  Then a quarter of the stretch
runs with the host's activity too, inside one annotation
("portbench.stretch"), for the breakdown alone: the device operations
that took most time, and each idle gap put down to what the host was
doing at its middle (the innermost host event then open, or "host
python" where none was).  Recording every host operation costs the
most, in the run and in reducing its events.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import NamedTuple

import torch

STRETCH = "portbench.stretch"
_TOP = 10
_BACK = 64            # host events looked at behind a gap's middle
_NAME = 160           # characters of a kernel's name kept


class TraceSummary(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: int
    device_top: list      # [[name, seconds], ...] most device time first
    idle_gaps: list       # [[host activity, seconds], ...] longest first


def _top(acc: dict) -> list:
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
            [:_TOP]]


def summarize(window, device, host) -> TraceSummary:
    """window (start_ns, end_ns); device and host: (start_ns, end_ns,
    name) tuples.  Device intervals are clipped to the window."""
    w0, w1 = window
    dev = sorted((max(a, w0), min(b, w1), n) for a, b, n in device
                 if b > w0 and a < w1)
    per_name = defaultdict(float)
    merged = []
    for a, b, n in dev:
        per_name[n[:_NAME]] += (b - a) * 1e-9
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    host = sorted(host)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        label = "host python"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - _BACK, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        gaps[label] += (g1 - g0) * 1e-9
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                        device_ops=len(dev), device_top=_top(per_name),
                        idle_gaps=_top(gaps))


def _events(prof):
    """(device (start, end, name), host (start, end, name)) of a trace;
    the annotations' spans on the card's timeline are left out."""
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        item = (a, a + e.duration_ns(), e.name())
        if e.device_type() != cuda:
            host.append(item)
        elif e.name() != STRETCH and not getattr(
                e, "is_user_annotation", lambda: False)():
            device.append(item)
    return device, host


def profile_stretch(fn) -> tuple:
    """Run the stretch fn(brief=False) once traced and fn(brief=True)
    once for the breakdown, as the module says.  Returns (its summary,
    the requests the whole stretch ran)."""
    P = torch.profiler
    with P.profile(activities=[P.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    # every operation of this pass was launched after t0 and ended
    # before the last synchronize: its union lies inside the window
    device, _ = _events(prof)
    span = (min((a for a, _, _ in device), default=0),
            max((b for _, b, _ in device), default=0))
    quiet = summarize(span, device, [])._replace(window_s=window_s)
    with P.profile(activities=[P.ProfilerActivity.CPU,
                               P.ProfilerActivity.CUDA]) as prof:
        with P.record_function(STRETCH):
            fn(brief=True)
            torch.cuda.synchronize()
    device, host = _events(prof)
    span = [(a, b) for a, b, name in host if name == STRETCH]
    if not span:
        raise RuntimeError("the profiler recorded no stretch annotation")
    full = summarize(span[0], device, [h for h in host if h[2] != STRETCH])
    return quiet._replace(device_top=full.device_top,
                          idle_gaps=full.idle_gaps), n
