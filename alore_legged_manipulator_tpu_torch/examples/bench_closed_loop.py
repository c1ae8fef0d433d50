"""Batched closed-loop throughput (twin of examples/bench_closed_loop.py).

Measures scenario-ticks/s for the FULL closed loop -- NMPC RTI at the
reference horizon + ICR-EKF predict/update + 500 Hz rate-limited noisy
plant (`parallel/mesh.py::batched_tracking_step`) -- over a scenario
fleet on `--device`.  Each call runs `chain` dependent ticks (the JAX
bench's chain inside one jit, here an eager loop ended by one
synchronize), continuing from the last call's state; one call warms
up, then 20 are timed.

    BENCH_FLEET=1024 BENCH_CHAIN=10 python -m \
        alore_legged_manipulator_tpu_torch.examples.bench_closed_loop [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..bench import device_fields, rate_band, timed
from ..control.nmpc import NmpcConfig
from ..parallel.mesh import batched_tracking_step
from ..parallel.scaling import _tiny_traj, make_fleet
from ..utils.precision import resolve_device, set_precision_policy


def closed_loop_line(fleet: int = 1024, chain: int = 10, iters: int = 20,
                     device=None, noise=None):
    """(line, out), out["state"] the last (plants, ekfs, carries, u_prev).
    noise: None draws the plant noise from `make_fleet`'s generator; else
    an iterable of (fleet, 5, 2) standard normals, one a tick in order
    (warm-up first)."""
    dev = resolve_device(device)
    set_precision_policy()
    tt, icr = _tiny_traj()
    cfg = NmpcConfig()              # the full reference horizon N=50
    step = batched_tracking_step(tt, icr, nmpc_cfg=cfg)
    plants, ekfs, carries, u_prev, gen = make_fleet(fleet, cfg, device=dev)
    draws = None if noise is None else iter(noise)

    def chained(state):
        plants, ekfs, carries, u_prevs = state
        for k in range(chain):
            src = gen if draws is None else next(draws).to(dev)
            plants, ekfs, carries, u_prevs, _ = step(
                plants, ekfs, carries, u_prevs, src, k * cfg.dt)
        return plants, ekfs, carries, u_prevs

    with torch.no_grad():
        state = chained((plants, ekfs, carries, u_prev))        # warm
        times = []
        for _ in range(iters):
            t, state = timed(lambda: chained(state), dev)
            times.append(t)
    med = float(np.median(times)) / chain
    line = {
        "metric": "closed_loop_scenario_ticks_per_s_1chip",
        "fleet": fleet,
        "chain": chain,
        "value": round(fleet / med, 1),
        "unit": "scenario-ticks/s",
        "ms_per_tick": round(med * 1e3, 2),
        "realtime_factor_per_scenario": round(0.01 / med * fleet, 1),
        **device_fields(dev),
        "rate_min_max": rate_band(fleet * chain, times),
        "timed_iters": len(times),
    }
    return line, {"state": state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(ap.parse_args(argv).device)
    line, _ = closed_loop_line(int(os.environ.get("BENCH_FLEET", "1024")),
                               int(os.environ.get("BENCH_CHAIN", "10")),
                               device=dev)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
