"""Per-layer numbers from the spans and counters the port records inside
its tick (`alore_legged_manipulator_tpu_torch/utils/profiling.py`).

The traced stretch runs under `torch.profiler`, which turns the port's
tracer on; the timed window runs with it off.  After the stretch each
reader takes the tracer's `snapshot()`: every value is the median over
the stretch's traced ticks, so the pass with the card's activity alone
(four fifths of them) sets it and the pass with the host's activity,
slower, does not.  A program without the tracer, or a run without a
traced tick, gives None.
"""
import statistics

ROOT = "tick"


def snapshot():
    """The port tracer's snapshot, or None where the program has none."""
    try:
        from alore_legged_manipulator_tpu_torch.utils import profiling
    except ImportError:
        return None
    snap = getattr(profiling, "snapshot", None)
    return snap() if callable(snap) else None


def ticks():
    """The traced ticks: the snapshot's requests whose root is `tick`."""
    snap = snapshot() or {}
    return [q for q in snap.get("requests", ()) if q["name"] == ROOT]


def span_ms(field, *names):
    """Median over the traced ticks of `field` ("host_ms", "self_ms" or
    "stream_ms") summed over the named spans; None without them."""
    vals = []
    for q in ticks():
        parts = [q["spans"].get(n, {}).get(field) for n in names]
        if None not in parts:
            vals.append(sum(parts))
    return float(statistics.median(vals)) if vals else None


def counter(name):
    """Median over the traced ticks of counter `name` summed over each
    tick's spans; None where no tick counted it."""
    vals = [q["counts"][name] for q in ticks() if name in q["counts"]]
    return float(statistics.median(vals)) if vals else None
