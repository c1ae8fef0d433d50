"""Scenario-fleet scaling measurement over a device mesh (port of
parallel/scaling.py).

The BASELINE.md north-star asks for >= 80% scaling efficiency from 1 to
N >= 2 devices at 10k+ batched scenarios.  The steady-state closed loop
needs *no* cross-scenario communication, so weak scaling is gated by
dispatch and by the fleet-level reductions alone.

`measure_scaling` runs the full closed-loop control tick (NMPC + EKF +
plant) with the scenario axis split over growing sub-meshes of the
process group and reports throughput and efficiency.  Each rank times
its own block (ended by `torch.cuda.synchronize` on the card, the host
clock on the CPU); the fleet's tick is the slowest rank's, one max
all-reduce.  Gloo ranks on one host share its cores, so their numbers
are indicative only.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..control.nmpc import NmpcConfig, nmpc_init
from ..control.tracked_traj import build_tracked_traj
from ..core.dynamics import ICRParams
from ..estimator.icr_ekf import ekf_init
from ..planner.flat_traj import Polynome
from ..utils.precision import resolve_device
from ..world.plant import plant_init
from .mesh import (batched_tracking_step, fleet_reduce, make_mesh,
                   shard_scenarios)


class ScalingPoint(NamedTuple):
    n_devices: int
    fleet: int
    ticks_per_s: float
    scenario_ticks_per_s: float
    efficiency: float


def _tiny_traj(dtype=torch.float32):
    """A two-piece 2 m trajectory (lane axis 1, on the CPU) and its ICR."""
    icr = ICRParams(yr=-0.3, yl=0.3, xv=0.2)
    msg = Polynome(
        traj_start_time=torch.zeros((1,), dtype=dtype),
        inner_points=torch.tensor([[[0.0], [1.0]]], dtype=dtype),
        piece_times=torch.tensor([[1.0, 1.0]], dtype=dtype),
        init_state=torch.zeros((1, 2, 3), dtype=dtype),
        tail_state=torch.tensor([[[0.0, 0, 0], [2.0, 0, 0]]], dtype=dtype),
        start_position=torch.zeros((1, 3), dtype=dtype),
        icr=torch.tensor([[icr.yr, icr.yl, icr.xv]], dtype=dtype))
    return build_tracked_traj(msg, n_grid=128), icr


def make_fleet(n, cfg: NmpcConfig, dtype=torch.float32, device=None):
    """(plants, ekfs, carries, u_prev, gen) of `n` scenarios at rest at
    the origin on `device` (None means the card); `gen` a generator
    there seeded 0 (the plant noise), in place of the JAX package's
    per-lane keys."""
    device = resolve_device(device)
    z = torch.zeros((n, 3), dtype=dtype, device=device)
    plants = plant_init(z, dtype)
    ekfs = ekf_init(z, (-0.2, 0.2, 0.1), dtype=dtype)
    carries = nmpc_init(cfg, z, dtype)
    u_prev = torch.zeros((n, 2), dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    return plants, ekfs, carries, u_prev, gen


def measure_scaling(mesh_sizes: Sequence[int], batch_per_device: int = 64,
                    horizon: int = 16, iters: int = 5, device=None):
    """Time the sharded closed-loop tick at each mesh size (every rank
    calls this; a rank outside a sub-mesh skips that size).  device:
    None is the card."""
    tt, icr = _tiny_traj()
    cfg = NmpcConfig(horizon=horizon)
    step = batched_tracking_step(tt, icr, nmpc_cfg=cfg)
    results = []
    base = None
    for nd in mesh_sizes:
        mesh = make_mesh(nd, device=device)
        if mesh.rank < 0:
            continue
        fleet = batch_per_device * nd
        plants, ekfs, carries, u_prev, _ = shard_scenarios(
            mesh, make_fleet(fleet, cfg, device=mesh.device))
        gen = torch.Generator(device=mesh.device).manual_seed(mesh.rank)

        def sync():
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)

        out = step(plants, ekfs, carries, u_prev, gen, 0.0)
        sync()
        times = []
        for _ in range(iters):
            t = time.perf_counter()
            out = step(*out, 0.0)
            sync()
            times.append(time.perf_counter() - t)
        med = float(fleet_reduce(
            mesh, torch.tensor(float(np.median(times)), dtype=torch.float64,
                               device=mesh.device), "max"))
        scen_rate = fleet / med
        if base is None:
            base = scen_rate / nd
        results.append(ScalingPoint(nd, fleet, 1.0 / med, scen_rate,
                                    scen_rate / (nd * base)))
    return results
