"""Batched full mission legs (twin of examples/bench_mission_legs.py).

One mission LEG = everything between two FSM waypoints: MINCO back-end
plan (stage-1 + stage-2 ALM + collision anneal) for a randomized goal,
Polynome handoff, TrajAnal rebuild, then closed-loop tracking (NMPC RTI
+ ICR-EKF + 500 Hz noisy plant) to the end of the trajectory -- the
whole planner->controller stack over a scenario fleet as one batch on
`--device`.  The first call is timed apart (`first_call_s`), then five,
each ended by a synchronize.

    LEGS_FLEET=256 LEGS_TICKS=200 python -m \
        alore_legged_manipulator_tpu_torch.examples.bench_mission_legs [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..bench import (ICR, bench_goals, device_fields, mission_map_esdf,
                     rate_band, straight_flats, timed)
from ..control.tracked_traj import build_tracked_traj
from ..planner.backend import BackendConfig, plan_backend
from ..planner.flat_traj import Polynome
from ..runtime.closed_loop import LoopConfig, simulate_tracking
from ..utils.precision import resolve_device, set_precision_policy


def legs_line(B: int = 256, n_ticks: int = 200, reps: int = 5,
              direction: str = "compact", first_call: bool = True,
              device=None):
    """(line, out): out holds the first call's per-lane max tracking
    error and the last call's final XY errors and collision flags.
    first_call=False (a cut run) skips the separate first call: the
    first timed call's errors stand for it and `first_call_s` is null."""
    dev = resolve_device(device)
    set_precision_policy()
    esdf = mission_map_esdf(dev)
    cfg = BackendConfig(solver_direction=direction)
    loop_cfg = LoopConfig()
    goals = bench_goals(B, dev)
    icr_vec = torch.tensor([ICR.yr, ICR.yl, ICR.xv],
                           device=dev).expand(B, 3)

    def fleet():
        flat = straight_flats(goals)
        res = plan_backend(flat, esdf, cfg)
        msg = Polynome(
            traj_start_time=torch.zeros((B,), device=dev),
            inner_points=res.inner, piece_times=res.times,
            init_state=flat.start_state, tail_state=res.tail_state,
            start_position=flat.start_xytheta, icr=icr_vec)
        tt = build_tracked_traj(msg, n_grid=256)
        tr = simulate_tracking(tt, ICR, n_ticks, loop_cfg, seed=0)
        return (torch.amax(tr.pos_err, dim=1),
                torch.linalg.vector_norm(res.final_xy_err, dim=-1),
                res.collision)

    with torch.no_grad():
        first, first_out = (timed(fleet, dev) if first_call
                            else (None, None))
        times = []
        for _ in range(reps):
            t, out = timed(fleet, dev)
            times.append(t)
            first_out = first_out or out
    max_err = first_out[0].cpu().numpy()
    med = float(np.median(times))
    err, coll = out[1].cpu().numpy(), out[2].cpu().numpy()
    line = {
        "metric": "full_mission_legs_per_s_per_chip",
        "fleet": B,
        "ticks_per_leg": n_ticks,
        "legs_per_s": round(B / med, 1),
        "first_call_s": None if first is None else round(first, 1),
        "tracking_err_p95_m": round(float(np.percentile(max_err, 95)), 4),
        "goal_ok_frac": float(np.mean(err < 0.05)),
        "collision_frac": float(np.mean(coll)),
        **device_fields(dev),
        "rate_min_max": rate_band(B, times),
        "timed_iters": len(times),
    }
    return line, {"track_err_max": max_err, "final_xy_err": err,
                  "collision": coll}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(ap.parse_args(argv).device)
    line, _ = legs_line(int(os.environ.get("LEGS_FLEET", "256")),
                        int(os.environ.get("LEGS_TICKS", "200")),
                        direction=os.environ.get("BENCH_BACKEND_DIRECTION",
                                                 "compact"), device=dev)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
