"""Throughput drivers of the port (twin of the repo's `bench.py`).

Five JSON lines, each with the metric name and keys of its JAX twin:

  1. `nmpc_rti_solves_per_s_per_chip_N50`: K chained NMPC RTI ticks at
     the reference horizon (N=50) over B scenarios, against the reference
     C++ NMPC's 100 Hz budget on one CPU (1 / 0.0097 s);
  2. `nmpc_solve_latency_onchip_ms`: a B=1 chain of dependent ticks, p50
     and p99 per tick against the 9.7 ms budget;
  3. `backend_full_plans_per_s_per_chip`: full MINCO back-end plans over
     a goal fleet, then a B=1 chain of dependent plans over several
     goals, p50 and p99 per plan against the 50 ms replan budget;
  4. `wavefront_frontend_paths_per_s_per_chip`: the packed wavefront
     field (kernel K1, `csrc/wavefront.cu`, on the card) and its
     turn-compressed descent over a 16384-lane fleet on the 100x100
     two-wall map;
  5. `full_missions_per_s_per_chip`: B three-object missions through
     `run_mission`, then `correct_until_delivered`.

Each JAX "chain of K inside one jit" is a Python loop of K eager steps
with the same data dependence, ended by one `torch.cuda.synchronize()`
before the host clock stops; the warm-up (the first-use build of the
wavefront kernels, cuBLAS handles) runs outside the timed region, and
the per-repetition perturbations of the JAX bench are kept so that the
work is the same.  Beside the JAX keys each line carries `device` (the
card's name, or "cpu"), `power_limit_w` (from nvidia-smi; null on the
CPU) and, where the JAX line reports only a median, `rate_min_max` and
`timed_iters`.

    python -m alore_legged_manipulator_tpu_torch.bench [--device cpu]

reads the JAX bench's environment variables with its defaults:
BENCH_BATCH, BENCH_CHAIN, BENCH_NMPC_LATENCY, BENCH_NMPC_LAT_CHAIN,
BENCH_NMPC_LAT_CALLS, BENCH_BACKEND_FLEET, BENCH_BACKEND_DIRECTION,
BENCH_BACKEND_CHAIN, BENCH_BACKEND_UNROLL (inert: the port's L-BFGS has
no unroll), BENCH_BACKEND_LAT_GOALS, BENCH_WAVEFRONT,
BENCH_WAVEFRONT_FLEET, BENCH_WAVEFRONT_IMPL (`pallas`, the default,
runs the CUDA kernel on the card and its plain version on the CPU; `jnp`
or `xla` the plain PyTorch version), BENCH_MISSION,
BENCH_MISSION_FLEET, BENCH_MISSION_ITERS.  Only `main` reads them; each
line is a function of explicit sizes and a device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from .control.nmpc import NmpcCarry, NmpcConfig, nmpc_rti_step
from .core.dynamics import ICRParams
from .ops.esdf import esdf_from_occupancy
from .planner.backend import BackendConfig, plan_backend
from .planner.flat_traj import FlatTraj
from .utils.precision import resolve_device, set_precision_policy

ICR = ICRParams(yr=-0.3, yl=0.3, xv=0.2)
# BENCH_WAVEFRONT_IMPL of the JAX bench -> the port's impl ("auto": the
# kernel on the card, its plain version on CPU tensors)
WAVEFRONT_IMPLS = {"pallas": "auto", "jnp": "torch", "xla": "torch"}


# ---------------------------------------------------------------------------
# shared by the lines here and the example twins' benches
# ---------------------------------------------------------------------------

def device_fields(dev: torch.device) -> dict:
    """{"device": the card's name or "cpu", "power_limit_w": the card's
    power limit from nvidia-smi (None on the CPU or without it)}."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    watts = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
        watts = float(out.rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        pass
    return {"device": torch.cuda.get_device_name(idx), "power_limit_w": watts}


def sync(dev: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev: torch.device):
    """(seconds, fn()) on the host clock, the card's work included."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return time.perf_counter() - t0, out


def rate_band(work: float, times) -> list:
    """[slowest, fastest] rate of `work` units over the timed runs."""
    return [round(work / float(np.max(times)), 1),
            round(work / float(np.min(times)), 1)]


def straight_flats(goals, dtype=torch.float32, n_pieces: int = 6) -> FlatTraj:
    """The benches' straight front-end guess from (1, 4) to each goal
    (B, 2): n_pieces equal pieces at 2L/3 s (at least 1 s), yaw along
    the line, at rest at both ends."""
    g = torch.as_tensor(goals).to(dtype)
    B, dev = g.shape[0], g.device
    start = torch.tensor([1.0, 4.0], dtype=dtype, device=dev)
    d = g - start
    L = torch.linalg.vector_norm(d, dim=-1)
    yaw = torch.atan2(d[:, 1], d[:, 0])
    fr = torch.arange(1, n_pieces, dtype=dtype, device=dev) / n_pieces
    inner = torch.stack([yaw[:, None].expand(B, n_pieces - 1),
                         L[:, None] * fr], dim=1)
    pos = torch.cat([start + fr[None, :, None] * d[:, None], g[:, None]], 1)
    pos = torch.cat([pos, yaw[:, None, None].expand(B, n_pieces, 1)], 2)
    total_t = torch.clamp(L / 3.0 * 2.0, min=1.0)
    z = torch.zeros_like(yaw)
    return FlatTraj(
        inner_yaw_s=inner, init_piece_time=total_t / n_pieces,
        inner_positions=pos,
        start_state=torch.stack([torch.stack([yaw, z, z], -1),
                                 torch.stack([z, z, z], -1)], 1),
        final_state=torch.stack([torch.stack([yaw, z, z], -1),
                                 torch.stack([L, z, z], -1)], 1),
        start_xytheta=torch.cat([start.expand(B, 2), yaw[:, None]], 1),
        final_xytheta=torch.cat([g, yaw[:, None]], 1),
        if_cut=torch.zeros((B,), dtype=torch.bool, device=dev))


def mission_map_esdf(dev, dtype=torch.float32):
    """The mission benches' 80x80 map of 0.1 m with one 1 x 0.6 m block."""
    occ = np.zeros((80, 80), bool)
    occ[30:40, 44:50] = True
    return esdf_from_occupancy(torch.as_tensor(occ, device=dev),
                               torch.zeros(2, dtype=dtype), 0.1)


def bench_goals(B: int, dev, dtype=torch.float32):
    """The back-end benches' goal fleet, numpy's generator seeded 0."""
    rng = np.random.default_rng(0)
    goals = np.stack([rng.uniform(5.0, 7.0, B), rng.uniform(3.0, 5.0, B)], 1)
    return torch.as_tensor(goals).to(dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# 1-2. the NMPC RTI tick
# ---------------------------------------------------------------------------

def nmpc_inputs(B: int, n: int, dev, dtype=torch.float32):
    """(x_traj, u_traj, x_est, ref_x, ref_u) as the JAX bench draws them:
    numpy's generator seeded 0, the reference a circle of radius 2."""
    rng = np.random.default_rng(0)
    x_traj = rng.standard_normal((B, n + 1, 3)) * 0.1
    u_traj = rng.standard_normal((B, n, 2)) * 0.1
    x_est = rng.standard_normal((B, 3)) * 0.1
    ts = 0.01 * np.arange(1, n + 2)
    circle = np.stack([2 * np.sin(ts), 2 * (1 - np.cos(ts)), ts])
    ref_x = np.broadcast_to(circle, (B, 3, n + 1))
    ref_u = np.ones((B, 2, n + 1))
    return tuple(torch.as_tensor(np.array(a)).to(dtype=dtype, device=dev)
                 for a in (x_traj, u_traj, x_est, ref_x, ref_u))


def nmpc_chain(x_traj, u_traj, x_est, ref_x, ref_u, K: int,
               cfg: NmpcConfig = NmpcConfig()):
    """K dependent RTI ticks, each warm-started from the last; returns
    the sum over the ticks of sum(u_cmd) (a 0-d tensor)."""
    total = torch.zeros((), dtype=x_traj.dtype, device=x_traj.device)
    for _ in range(K):
        carry, u_cmd, _, _ = nmpc_rti_step(
            NmpcCarry(x_traj=x_traj, u_traj=u_traj), x_est, ref_x, ref_u,
            ICR, cfg)
        x_traj, u_traj = carry.x_traj, carry.u_traj
        total = total + u_cmd.sum()
    return total


def nmpc_rti_line(B: int = 16384, chain: int = 10, iters: int = 8,
                  device=None):
    """Line 1: (line, out) with out = {"checksum": the last timed chain's
    sum of commands, "peak_mem_bytes": on the card, else None}."""
    dev = resolve_device(device)
    set_precision_policy()
    cfg = NmpcConfig()
    x_traj, u_traj, x_est, ref_x, ref_u = nmpc_inputs(B, cfg.horizon, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        nmpc_chain(x_traj, u_traj, x_est, ref_x, ref_u, chain, cfg)  # warm
        times = []
        for it in range(iters):
            # the JAX bench's per-rep 1e-6 jitter of the estimate
            xe = x_est + 1e-6 * (it + 1)
            t, total = timed(lambda: nmpc_chain(x_traj, u_traj, xe, ref_x,
                                                ref_u, chain, cfg), dev)
            times.append(t)
    med = float(np.median(times)) / chain
    solves_per_s = B / med
    baseline = 1.0 / 0.0097
    line = {
        "metric": "nmpc_rti_solves_per_s_per_chip_N50",
        "value": round(solves_per_s, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / baseline, 2),
        **device_fields(dev),
        "rate_min_max": rate_band(B * chain, times),
        "timed_iters": len(times),
    }
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return line, {"checksum": float(total), "peak_mem_bytes": peak}


def nmpc_latency_line(chain: int = 100, calls: int = 12, device=None):
    """Line 2: (line, out), out = {"checksum": the last call's sum}."""
    dev = resolve_device(device)
    set_precision_policy()
    cfg = NmpcConfig()
    x_traj, u_traj, x_est, ref_x, ref_u = nmpc_inputs(1, cfg.horizon, dev)
    with torch.no_grad():
        nmpc_chain(x_traj, u_traj, x_est, ref_x, ref_u, chain, cfg)  # warm
        per_step = []
        for it in range(calls):
            xt = x_traj + 1e-6 * (it + 1)
            t, total = timed(lambda: nmpc_chain(xt, u_traj, x_est, ref_x,
                                                ref_u, chain, cfg), dev)
            per_step.append(t / chain)
    lat_ms = np.asarray(per_step) * 1e3
    p50 = float(np.percentile(lat_ms, 50))
    p99 = float(np.percentile(lat_ms, 99))
    budget_ms = 9.7
    line = {
        "metric": "nmpc_solve_latency_onchip_ms",
        "value": round(p50, 3),
        "unit": "ms p50",
        "vs_baseline": round(budget_ms / max(p99, 1e-9), 2),
        "p50_ms": round(p50, 3),
        "p99_ms": round(p99, 3),
        "budget_ms": budget_ms,
        **device_fields(dev),
        "timed_iters": len(per_step),
    }
    return line, {"checksum": float(total)}


# ---------------------------------------------------------------------------
# 3. the wavefront front end
# ---------------------------------------------------------------------------

def wavefront_bench_esdf(dev):
    """The 100x100 two-wall bench map's ESDF on `dev` (also the front-end
    example's map)."""
    occ = np.zeros((100, 100), bool)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
    occ[40:44, 10:70] = True
    occ[70:74, 30:95] = True
    return esdf_from_occupancy(torch.as_tensor(occ, device=dev),
                               torch.zeros(2), 0.1)


def wavefront_bench_map(dev):
    """The bench map's blocked cells (ESDF below the front end's safe
    distance), (H, W) on `dev`."""
    from .planner.frontend import FrontendConfig
    return wavefront_bench_esdf(dev).dist < FrontendConfig().safe_dis


def wavefront_starts_goals(B: int, dev):
    """(start cells, goal cells), (B, 2) int64, from numpy's generator
    seeded 0 as the JAX bench draws them."""
    rng = np.random.default_rng(0)
    s = rng.uniform([1.0, 1.0], [3.0, 8.5], (B, 2))
    g = rng.uniform([8.0, 1.0], [9.5, 8.5], (B, 2))
    return tuple(torch.as_tensor((a / 0.1).astype(np.int32)).to(
        dtype=torch.int64, device=dev) for a in (s, g))


def wavefront_fleet(blk, s_cells, g_cells, impl: str):
    """Field + 256-step path for every lane of the (B, H, W) blocked
    grids `blk`; returns (sum of the start cells' distances, number of
    valid path cells)."""
    from .ops import wavefront as wf
    lanes = torch.arange(s_cells.shape[0], device=blk.device)
    dist, _, valid = wf.wavefront_path(blk, g_cells, s_cells, 256,
                                       impl=impl)
    return dist[lanes, s_cells[:, 0], s_cells[:, 1]].sum(), valid.sum()


def wavefront_line(B: int = 16384, impl: str = "auto", reps: int = 4,
                   device=None):
    """Line 4: (line, out), out = {"dist_sum", "path_cells": of the first
    timed rep's batch}.  impl: "cuda" (K1), "torch" (plain) or "auto"
    (K1 on the card)."""
    dev = resolve_device(device)
    set_precision_policy()
    if impl == "auto":
        impl = "cuda" if dev.type == "cuda" else "torch"
    blocked = wavefront_bench_map(dev)
    # every lane plans on the one map (the JAX bench's vmap closes over
    # it); the kernels take a contiguous (B, H, W) batch
    blk = blocked.expand(B, *blocked.shape).contiguous()
    s_cells, g_cells = wavefront_starts_goals(B, dev)
    with torch.no_grad():
        wavefront_fleet(blk, s_cells, g_cells, impl)            # warm
        ts, sums = [], []
        for it in range(reps):
            # the JAX bench rolls the batch to defeat a result cache
            s2 = torch.roll(s_cells, it, 0)
            g2 = torch.roll(g_cells, it, 0)
            t, out = timed(lambda: wavefront_fleet(blk, s2, g2, impl), dev)
            ts.append(t)
            sums.append(out)
    paths_per_s = B / float(np.median(ts))
    line = {
        "metric": "wavefront_frontend_paths_per_s_per_chip",
        "value": round(paths_per_s, 1),
        "unit": "paths/s",
        "vs_baseline": round(paths_per_s / 700.0, 2),
        "fleet": B,
        "impl": impl,
        **device_fields(dev),
        "rate_min_max": rate_band(B, ts),
        "timed_iters": len(ts),
    }
    return line, {"dist_sum": float(sums[0][0]),
                  "path_cells": int(sums[0][1])}


# ---------------------------------------------------------------------------
# 2-3. the back end
# ---------------------------------------------------------------------------

def backend_config(direction: str = "compact", unroll=None) -> BackendConfig:
    """The bench profile (the solver direction; `unroll` is kept in the
    config as the JAX bench keeps it, and no solver of the port reads
    it)."""
    cfg = BackendConfig(solver_direction=direction)
    if unroll is None:
        return cfg
    return cfg._replace(
        lbfgs=cfg.lbfgs._replace(two_loop_unroll=unroll),
        path_lbfgs=cfg.path_lbfgs._replace(two_loop_unroll=unroll))


def backend_chain(goal, K: int, esdf, cfg: BackendConfig):
    """K dependent B=1 plans: each goal moves by 1e-6 tanh of the last
    plan's final XY error.  Returns the sum of their piece times."""
    total = torch.zeros((), dtype=goal.dtype, device=goal.device)
    g = goal[None]
    for _ in range(K):
        res = plan_backend(straight_flats(g), esdf, cfg)
        g = g + 1e-6 * torch.tanh(res.final_xy_err)
        total = total + res.times.sum()
    return total


def backend_line(B: int = 512, direction: str = "compact", chain: int = 6,
                 lat_goals: int = 4, unroll=None, reps: int = 4,
                 lat_reps: int = 4, warmup: bool = True, device=None):
    """Line 3: (line, out), out = {"times_sum", "collisions",
    "goal_err_max": of the fleet's first timed call; "lat_checksum": of
    the last latency chain}."""
    dev = resolve_device(device)
    set_precision_policy()
    esdf = mission_map_esdf(dev)
    cfg = backend_config(direction)
    goals = bench_goals(B, dev)

    def fleet(g):
        res = plan_backend(straight_flats(g), esdf, cfg)
        return (res.times.sum(), res.collision.sum(),
                torch.linalg.vector_norm(res.final_xy_err, dim=-1).max())

    lat_cfg = backend_config(direction, unroll if unroll is not None
                             else 2 * cfg.lbfgs.mem_size)
    with torch.no_grad():
        if warmup:
            fleet(goals)
        times, outs = [], []
        for it in range(reps):
            g2 = goals + 1e-6 * (it + 1)
            t, out = timed(lambda: fleet(g2), dev)
            times.append(t)
            outs.append(out)
        if warmup:
            backend_chain(goals[0], chain, esdf, lat_cfg)
        lat = []
        for gi in range(lat_goals):
            for it in range(lat_reps):
                g2 = goals[gi] + 1e-6 * (it + 1)
                t, lat_sum = timed(lambda: backend_chain(g2, chain, esdf,
                                                         lat_cfg), dev)
                lat.append(t / chain)
    plans_per_s = B / float(np.median(times))
    lat_ms = np.asarray(lat) * 1e3
    line = {
        "metric": "backend_full_plans_per_s_per_chip",
        "value": round(plans_per_s, 1),
        "unit": "plans/s",
        "vs_baseline": round(plans_per_s / 20.0, 2),
        "plan_latency_onchip_p50_ms": round(float(np.percentile(lat_ms, 50)),
                                            2),
        "plan_latency_onchip_p99_ms": round(float(np.percentile(lat_ms, 99)),
                                            2),
        "budget_ms": 50.0,
        **device_fields(dev),
        "rate_min_max": rate_band(B, times),
        "timed_iters": len(times),
    }
    t_sum, coll, err = outs[0]
    return line, {"times_sum": float(t_sum), "collisions": int(coll),
                  "goal_err_max": float(err),
                  "lat_checksum": float(lat_sum)}


# ---------------------------------------------------------------------------
# 5. the mission fleet
# ---------------------------------------------------------------------------

def mission_config(direction: str = "compact", approach_ticks: int = 700,
                   push_ticks: int = 550):
    from .runtime.mission_fleet import MissionFleetConfig
    return MissionFleetConfig(approach_ticks=approach_ticks,
                              push_ticks=push_ticks,
                              backend=BackendConfig(solver_direction=direction))


def mission_summary(B: int, K: int, times, res, miss_counts, cfg,
                    corr_ticks: int, dev) -> dict:
    """The mission line of a fleet timed `times` (s per fleet and its
    rounds) whose last result is `res` after the rounds `miss_counts`."""
    from .runtime.mission_fleet import mission_seconds_exact
    med = float(np.median(times))
    missions_per_s = B / med
    sim_s = mission_seconds_exact(res, cfg, corr_ticks,
                                  miss_counts=miss_counts) / B
    return {
        "metric": "full_missions_per_s_per_chip",
        "value": round(missions_per_s, 1),
        "unit": "missions/s",
        "vs_baseline": round(missions_per_s * K / (32.0 / 2400.0), 1),
        "objects_per_mission": K,
        "delivered_frac": round(float(res.delivered.float().mean()), 4),
        "corrected_legs": int(sum(miss_counts)),
        "correction_rounds": len(miss_counts),
        "aggregate_realtime_x": round(missions_per_s * sim_s, 1),
        "rate_min_max": rate_band(B, times),
        "timed_iters": len(times),
        **device_fields(dev),
    }


def mission_line(B: int = 64, iters: int = 4, direction: str = "compact",
                 K: int = 3, approach_ticks: int = 700, push_ticks: int = 550,
                 corr_ticks: int = 300, warmup: bool = True, device=None):
    """Line 5: (line, out), out = the last fleet's {"delivered_before":
    delivered fraction before its rounds, "object_err_before",
    "object_err": (B, K) object errors before and after them (numpy)}."""
    from .runtime.mission_fleet import (correct_until_delivered, run_mission,
                                        spaced_scenarios)
    dev = resolve_device(device)
    set_precision_policy()
    esdf = mission_map_esdf(dev)
    cfg = mission_config(direction, approach_ticks, push_ticks)
    items_np, targets_np = spaced_scenarios(B, K, np.random.default_rng(0))
    items = torch.as_tensor(items_np).to(dtype=torch.float32, device=dev)
    targets = torch.as_tensor(targets_np).to(dtype=torch.float32, device=dev)
    robot0 = torch.tensor([1.0, 4.0, 0.0], device=dev).repeat(B, 1)

    def one(r0):
        base = run_mission(items, targets, r0, esdf, ICR, cfg, device=dev)
        res, miss = correct_until_delivered(base, targets, esdf, ICR, cfg,
                                            corr_ticks)
        float(res.object_err.sum())
        return base, res, miss

    if warmup:
        one(robot0)
    times = []
    for it in range(iters):
        # the JAX bench's 1e-6 m start jitter (it can change the miss
        # pattern, bench.py warns)
        r0 = robot0.clone()
        r0[:, 0] += 1e-6 * (it + 1)
        t, (base, res, miss_counts) = timed(lambda: one(r0), dev)
        times.append(t)
    line = mission_summary(B, K, times, res, miss_counts, cfg, corr_ticks,
                           dev)
    return line, {"delivered_before": float(base.delivered.float().mean()),
                  "object_err_before": base.object_err.cpu().numpy(),
                  "object_err": res.object_err.cpu().numpy()}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(ap.parse_args(argv).device)
    env = os.environ.get
    lines = []

    def emit(line_out):
        lines.append(line_out[0])
        print(json.dumps(line_out[0]), flush=True)

    emit(nmpc_rti_line(int(env("BENCH_BATCH", "16384")),
                       int(env("BENCH_CHAIN", "10")), device=dev))
    if env("BENCH_NMPC_LATENCY", "1") != "0":
        emit(nmpc_latency_line(int(env("BENCH_NMPC_LAT_CHAIN", "100")),
                               int(env("BENCH_NMPC_LAT_CALLS", "12")),
                               device=dev))
    unroll = env("BENCH_BACKEND_UNROLL")
    emit(backend_line(int(env("BENCH_BACKEND_FLEET", "512")),
                      env("BENCH_BACKEND_DIRECTION", "compact"),
                      int(env("BENCH_BACKEND_CHAIN", "6")),
                      int(env("BENCH_BACKEND_LAT_GOALS", "4")),
                      None if unroll is None else int(unroll), device=dev))
    if env("BENCH_WAVEFRONT", "1") != "0":
        emit(wavefront_line(int(env("BENCH_WAVEFRONT_FLEET", "16384")),
                            WAVEFRONT_IMPLS[env("BENCH_WAVEFRONT_IMPL",
                                                "pallas")], device=dev))
    if env("BENCH_MISSION", "1") != "0":
        emit(mission_line(int(env("BENCH_MISSION_FLEET", "64")),
                          int(env("BENCH_MISSION_ITERS", "4")),
                          env("BENCH_BACKEND_DIRECTION", "compact"),
                          device=dev))
    return lines


if __name__ == "__main__":
    main()
