"""What the port's tracer costs when it is on: windows of the benchmark's
`track-b1` cell (`portbench/`, one robot, each tick's command read to the
host) with the tracer off and after `enable()`, in turns, in one process
on the card; then the same for `track-fleet16k`.

    python tests/tracing_cost.py [--seed N] [--seconds S] [--fleet-seconds S]

Prints one JSON object: the card and its power limit; per cell and
window whether the tracer was on, the ticks, `tick_p95_ms` and the
lane-ticks per second (each as the benchmark reads them); and the
medians over the ticks traced by `enable()` alone (no profiler) of each
layer's host, self and stream time and host syncs, and of the tick's
host syncs.  Needs a card.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import run  # noqa: E402

LAYERS = ("tick", "ref", "nmpc.linearize", "nmpc.feedback", "ekf.predict",
          "plant", "ekf.update")


def _medians(requests):
    out = {}
    for name in LAYERS:
        for field in ("host_ms", "self_ms", "stream_ms"):
            vals = [q["spans"][name][field] for q in requests
                    if q["name"] == "tick" and name in q["spans"]]
            if vals and None not in vals:
                out[f"{name}.{field}"] = statistics.median(vals)
        syncs = [q["spans"][name]["counts"].get("host_syncs", 0)
                 for q in requests if name in q["spans"]]
        if any(syncs):
            out[f"{name}.host_syncs"] = statistics.median(syncs)
    syncs = [q["counts"].get("host_syncs") for q in requests]
    out["host_syncs"] = statistics.median(syncs) if syncs and \
        None not in syncs else None
    return out


def cell_windows(workload, seed, seconds, order):
    from alore_legged_manipulator_tpu_torch.utils import profiling
    cell = run.make_cell(workload, seed, "cuda")[0]
    cell.setup()
    rows = []
    profiling.reset()
    for on in order:
        (profiling.enable if on else profiling.disable)()
        rec = cell.window(seconds)
        profiling.disable()
        lat = np.asarray(rec["latencies_s"])
        rows.append({"tracer": "on" if on else "off",
                     "ticks": rec["requests"],
                     "tick_p95_ms": float(np.percentile(lat, 95) * 1e3),
                     "tick_p50_ms": float(np.percentile(lat, 50) * 1e3),
                     "lane_ticks_per_s":
                         rec["lanes"] * rec["requests"] / rec["elapsed_s"]})
    snap = profiling.snapshot()
    profiling.reset()
    cell.release()
    torch.cuda.empty_cache()
    return {"windows": rows, "traced_ticks": len(snap["requests"]),
            "dropped": snap["dropped"],
            "medians_on": _medians(snap["requests"])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=3_000_000_019)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--fleet-seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tracing_cost: needs a CUDA card")
    run.set_cache_dirs()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": card.strip(),
           "track-b1": cell_windows("track-b1", args.seed, args.seconds,
                                    (False, True, True, False)),
           "track-fleet16k": cell_windows("track-fleet16k", args.seed,
                                          args.fleet_seconds,
                                          (False, True, True, False))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
