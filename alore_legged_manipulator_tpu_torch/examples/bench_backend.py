"""Isolated back-end planner throughput: full MINCO plans/s (twin of
examples/bench_backend.py).

The reference budgets `max_replan_time` 0.05 s per plan on one CPU
(plan_manager/launch/planner_sim.launch:65), i.e. ~20 plans/s.  This
bench plans the COMPLETE back end -- stage-1 path pre-process, stage-2
L-BFGS under the ALM outer loop, collision recheck + time-weight anneal
(`planner/backend.py::plan_backend`) -- for a randomized goal fleet as
one batch on `--device` and reports plans/s plus solution quality.  The
first call is timed apart (`first_call_s`: first-use costs), then five
calls, each ended by a synchronize.

    BACKEND_FLEET=512 python -m \
        alore_legged_manipulator_tpu_torch.examples.bench_backend [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..bench import (bench_goals, device_fields, mission_map_esdf,
                     rate_band, straight_flats, timed)
from ..planner.backend import BackendConfig, plan_backend
from ..utils.precision import resolve_device, set_precision_policy


def backend_fleet_line(B: int = 512, direction: str = "compact",
                       reps: int = 5, first_call: bool = True, device=None):
    """(line, out): out holds the last call's per-lane final XY error,
    collision flags and total durations (numpy).  first_call=False (a
    cut run) skips the separate first call: `first_call_s` is then
    null."""
    dev = resolve_device(device)
    set_precision_policy()
    esdf = mission_map_esdf(dev)
    cfg = BackendConfig(solver_direction=direction)
    goals = bench_goals(B, dev)

    def fleet():
        res = plan_backend(straight_flats(goals), esdf, cfg)
        return (torch.linalg.vector_norm(res.final_xy_err, dim=-1),
                res.collision, res.times.sum(-1))

    with torch.no_grad():
        first = timed(fleet, dev)[0] if first_call else None
        times = []
        for _ in range(reps):
            t, out = timed(fleet, dev)
            times.append(t)
    med = float(np.median(times))
    err, coll, dur = (x.cpu().numpy() for x in out)
    line = {
        "metric": "backend_full_plans_per_s_per_chip",
        "fleet": B,
        "plans_per_s": round(B / med, 1),
        "ms_per_fleet_call": round(med * 1e3, 1),
        "first_call_s": None if first is None else round(first, 1),
        "goal_ok_frac": float(np.mean(err < 0.05)),
        "collision_frac": float(np.mean(coll)),
        "vs_ref_20_plans_per_s": round(B / med / 20.0, 1),
        **device_fields(dev),
        "rate_min_max": rate_band(B, times),
        "timed_iters": len(times),
    }
    return line, {"final_xy_err": err, "collision": coll, "duration": dur}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(ap.parse_args(argv).device)
    line, _ = backend_fleet_line(
        int(os.environ.get("BACKEND_FLEET", "512")),
        os.environ.get("BENCH_BACKEND_DIRECTION", "compact"), device=dev)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
