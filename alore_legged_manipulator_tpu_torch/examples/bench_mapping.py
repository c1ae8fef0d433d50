"""Occupancy-mapping throughput: fused lidar scans/s (twin of
examples/bench_mapping.py).

The reference SDFmap fuses one scan per occupancy-update tick on one
CPU (updateOccupancyCallback at the mapping rate, ~10 Hz budget per
robot).  Here the golden-exact fusion pipeline (Bresenham raycast +
hit-vote log-odds + RemoveOutliers + sticky gridmap, `world/lidar.py`)
runs for a robot fleet, `chain` ticks a call: scan rendering against the
true map + full fusion per robot and tick.  The port's scan and fusion
take one robot a call (their scatter-adds do not batch under
`torch.vmap`), so each tick loops over the fleet; one call warms up,
then 3 are timed, each ended by a synchronize.

    MAP_FLEET=256 MAP_CHAIN=10 python -m \
        alore_legged_manipulator_tpu_torch.examples.bench_mapping [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..bench import device_fields, rate_band, timed
from ..utils.precision import resolve_device, set_precision_policy
from ..world.lidar import (LidarConfig, OccupancyConfig, OccupancyState,
                           lidar_scan, occupancy_init, occupancy_update)


def mapping_scene(B: int, dev):
    """(true occupancy (120, 120), robot poses (B, 3) f32) from numpy's
    generator seeded 0: a walled room with 24 4x4 blocks."""
    H, W = 120, 120
    rng = np.random.default_rng(0)
    occ = np.zeros((H, W), bool)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
    for _ in range(24):
        x, y = rng.integers(8, H - 12), rng.integers(8, W - 12)
        occ[x:x + 4, y:y + 4] = True
    poses = np.stack([rng.uniform(2.0, 10.0, B), rng.uniform(2.0, 10.0, B),
                      rng.uniform(-np.pi, np.pi, B)], 1)
    return (torch.as_tensor(occ, device=dev),
            torch.as_tensor(poses).to(dtype=torch.float32, device=dev))


def mapping_line(B: int = 256, K: int = 10, reps: int = 3, device=None):
    """(line, out), out = {"sums": (K,) sum over the fleet of log_odds[0,
    0] after each tick of the last call, "state": its maps (B, ...)}."""
    dev = resolve_device(device)
    set_precision_policy()
    res = torch.tensor(0.1, dtype=torch.float32, device=dev)
    lcfg = LidarConfig(n_beams=128, fov_rad=2 * np.pi, max_range=4.0,
                       n_steps=192)
    ocfg = OccupancyConfig()
    true_occ, poses0 = mapping_scene(B, dev)
    H, W = true_occ.shape
    lower = torch.zeros(2, dtype=torch.float32, device=dev)
    one = occupancy_init((H, W), ocfg, device=dev)
    states0 = OccupancyState(*(x.expand(B, H, W) for x in one))

    def tick(state, pose):
        ranges, hits = lidar_scan(true_occ, lower, res, pose, lcfg)
        return occupancy_update(state, lower, res, pose, ranges, hits, lcfg,
                                ocfg)

    def chained(states, poses):
        sums = []
        for i in range(K):
            # robots turn a little each tick so successive scans differ
            p = poses.clone()
            p[:, 2] += 0.05 * torch.tensor(float(i), dtype=p.dtype,
                                           device=dev)
            lanes = [tick(OccupancyState(*(x[b] for x in states)), p[b])
                     for b in range(B)]
            states = OccupancyState(*(torch.stack(f) for f in zip(*lanes)))
            sums.append(states.log_odds[:, 0, 0].sum())
        return states, torch.stack(sums)

    with torch.no_grad():
        chained(states0, poses0)                                # warm
        times = []
        for _ in range(reps):
            t, (st, sums) = timed(lambda: chained(states0, poses0), dev)
            times.append(t)
    dt = float(np.sum(times)) / reps
    rate = B * K / dt
    line = {
        "metric": "fused_lidar_scans_per_s_per_chip",
        "value": round(rate, 1), "unit": "scans/s",
        "fleet": B, "chain": K,
        "vs_baseline": round(rate / 10.0, 1),  # 10 Hz mapping budget
        **device_fields(dev),
        "rate_min_max": rate_band(B * K, times),
        "timed_iters": len(times),
    }
    return line, {"sums": sums, "state": st}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(ap.parse_args(argv).device)
    line, _ = mapping_line(int(os.environ.get("MAP_FLEET", "256")),
                           int(os.environ.get("MAP_CHAIN", "10")), device=dev)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
