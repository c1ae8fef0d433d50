"""Whole arrangement missions: the fleet-scale headline (twin of
examples/bench_mission_fleet.py).

Each mission is the COMPLETE multi-object loop the reference demos on
one robot (README.md:28 -- 32 chairs in ~40 min): per object, a
kinematic FSM approach (b2z1_object_fsm.py control laws), grasp ramp, a
full MINCO back-end push plan, the NMPC+EKF closed-loop push at
reference rates (or the contact plant, PLANT=physics), release.
`runtime/mission_fleet.py::run_mission` composes all of it over a
randomized mission fleet on `--device`.  CORRECTION=<ticks> adds a
correction leg: CORRECTION_MODE=inline runs it in every lane,
`redispatch` re-dispatches ONLY the missed lanes after the fleet
(`correct_missed_legs`; its time model is exact).  The first call is
timed apart (`first_call_s`), then three, each ended by a synchronize.

    FLEET=256 OBJECTS=3 python -m \
        alore_legged_manipulator_tpu_torch.examples.bench_mission_fleet [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..bench import (ICR, device_fields, mission_map_esdf, rate_band,
                     timed)
from ..runtime.mission_fleet import (MissionFleetConfig,
                                     correct_missed_legs, mission_seconds,
                                     mission_seconds_exact, run_mission,
                                     spaced_scenarios)
from ..utils.precision import resolve_device, set_precision_policy


def mission_fleet_line(B: int = 256, K: int = 3, plant: str = "kinematic",
                       corr: int = 0, mode=None, iters: int = 3,
                       approach_ticks: int = 700, push_ticks: int = 550,
                       first_call: bool = True, device=None):
    """(line, out): out holds the last call's per-leg object errors and
    delivered flags, before and after its correction (numpy), and the
    legs it corrected.  first_call=False
    (a cut run) skips the separate first fleet call: `first_call_s` is
    then null."""
    dev = resolve_device(device)
    set_precision_policy()
    esdf = mission_map_esdf(dev)
    cfg = MissionFleetConfig(approach_ticks=approach_ticks,
                             push_ticks=push_ticks, plant=plant,
                             correction_ticks=corr)
    # items on the left, targets on the right: legs are 3-6.3 m, within
    # the push-tick time budget; same-side spacing per spaced_scenarios
    items, targets = spaced_scenarios(B, K, np.random.default_rng(0))
    ij = torch.as_tensor(items).to(dtype=torch.float32, device=dev)
    tj = torch.as_tensor(targets).to(dtype=torch.float32, device=dev)
    rj = torch.tensor([1.0, 4.0, 0.0], device=dev).repeat(B, 1)
    mode = mode or ("inline" if corr else "none")
    redispatch = mode == "redispatch"
    if redispatch:
        cfg = cfg._replace(correction_ticks=0)

    def fleet():
        base = run_mission(ij, tj, rj, esdf, ICR, cfg, device=dev)
        res, n_corrected = base, 0
        if redispatch:
            res, n_corrected = correct_missed_legs(
                base, tj, esdf, ICR, cfg, correction_ticks=corr or 300)
        float(res.object_err.sum())
        return base, res, n_corrected

    with torch.no_grad():
        first = timed(lambda: run_mission(ij, tj, rj, esdf, ICR, cfg,
                                          device=dev), dev)[0] \
            if first_call else None
        times = []
        for _ in range(iters):
            t, (base, res, n_corrected) = timed(fleet, dev)
            times.append(t)
    med = float(np.median(times))
    err = res.object_err.cpu().numpy()
    delivered = res.delivered.cpu().numpy()
    if redispatch:
        # billed against PRE-correction misses: the legs that ran one
        sim_s = mission_seconds_exact(base, cfg, corr or 300) / B
    else:
        sim_s = mission_seconds(cfg, K)
    missions_per_s = B / med
    line = {
        "metric": "full_missions_per_s_per_chip",
        "plant": plant,
        "correction_ticks": corr,
        "fleet": B,
        "objects_per_mission": K,
        "correction_mode": mode,
        "corrected_lanes": int(n_corrected),
        "missions_per_s": round(missions_per_s, 1),
        "objects_per_s": round(missions_per_s * K, 1),
        # inline mode: mission_seconds counts the correction leg for
        # every object, so with correction_ticks > 0 these are UPPER
        # BOUNDS (see its doc); redispatch mode is exact per lane
        "sim_seconds_per_mission": round(sim_s, 1),
        "aggregate_realtime_x": round(missions_per_s * sim_s, 1),
        "delivered_frac": float(delivered.mean()),
        "object_err_p95_m": round(float(np.percentile(err, 95)), 4),
        "first_call_s": None if first is None else round(first, 1),
        "ms_per_fleet_call": round(med * 1e3, 1),
        **device_fields(dev),
        "rate_min_max": rate_band(B, times),
        "timed_iters": len(times),
    }
    return line, {"object_err": err, "delivered": delivered,
                  "object_err_before": base.object_err.cpu().numpy(),
                  "delivered_before": base.delivered.cpu().numpy(),
                  "corrected_lanes": int(n_corrected)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(ap.parse_args(argv).device)
    env = os.environ.get
    line, _ = mission_fleet_line(
        int(env("FLEET", "256")), int(env("OBJECTS", "3")),
        env("PLANT", "kinematic"), int(env("CORRECTION", "0")),
        env("CORRECTION_MODE"), device=dev)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
