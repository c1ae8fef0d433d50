"""The multi-device dry run (port of `__graft_entry__.py::dryrun_multichip`).

Four sharded programs over a mesh, each with its outcome assertions:

  1. the full closed-loop tracking tick (NMPC at the reference horizon
     N=50 + ICR-EKF + 5 plant substeps): finite commands;
  2. the contact-physics env step (rl/env_physics.py), the training
     path's simulator: a finite mean reward;
  3. the back-end planner (MINCO + ALM + anneal) at its production solver
     caps over a goal fleet around one obstacle: every lane's plan
     collision-free, on its goal, with finite positive times;
  4. whole arrangement missions (approach + grasp + wavefront front end +
     back-end plan + NMPC push) at delivering tick budgets: every lane
     delivered within `deliver_tol`.

Every global fleet is drawn from a fixed seed, and each rank runs its
contiguous block of it (`shard_scenarios`); the fleet statistics are
`fleet_reduce`s, the only collectives.  The per-rank sizes and the
mission's tick budgets are arguments, so that a test can run the same
programs small.  Every rank calls `dryrun_multichip`; rank 0 prints.

As a program it starts one process per rank on this host, joined over
`tcp://localhost:<free port>` (NCCL on the cards, one card a rank; gloo
with `--device cpu`), runs the four programs and, with `--train-iters`,
trains on the mesh at float64 (`train(mesh=...)`, B=`--train-envs`,
contact plant) against rank 0 training the same configuration alone:

    python -m alore_legged_manipulator_tpu_torch.parallel.dryrun \
        --ranks 4 [--device cpu] [--train-iters 2]
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..control.nmpc import NmpcConfig
from ..control.tracked_traj import build_tracked_traj
from ..core.dynamics import ICRParams
from ..ops.esdf import esdf_from_occupancy
from ..planner.backend import BackendConfig, plan_backend
from ..planner.flat_traj import FlatTraj, Polynome
from ..runtime.mission_fleet import MissionFleetConfig, run_mission
from .mesh import (Mesh, batched_tracking_step, fleet_reduce,
                   shard_scenarios)
from .scaling import make_fleet

ICR = ICRParams(yr=-0.3, yl=0.3, xv=0.2)


def dryrun_traj(dtype=torch.float32):
    """The dry run's planned trajectory: two 0.6 s pieces to x = 1 m
    (lane axis 1, on the CPU)."""
    msg = Polynome(
        traj_start_time=torch.zeros((1,), dtype=dtype),
        inner_points=torch.tensor([[[0.0], [0.5]]], dtype=dtype),
        piece_times=torch.tensor([[0.6, 0.6]], dtype=dtype),
        init_state=torch.zeros((1, 2, 3), dtype=dtype),
        tail_state=torch.tensor([[[0.0, 0, 0], [1.0, 0, 0]]], dtype=dtype),
        start_position=torch.zeros((1, 3), dtype=dtype),
        icr=torch.tensor([[ICR.yr, ICR.yl, ICR.xv]], dtype=dtype))
    return build_tracked_traj(msg, n_grid=64)


def tick_program(mesh: Mesh, batch: int = 256, dtype=torch.float32,
                 noise=None):
    """One sharded tracking tick at N=50 over `batch` scenarios a rank.
    noise: the global (B, 5, 2) plant noise (None: a generator on the
    rank's device seeded with its rank).  Returns this rank's
    (plants, ekfs, carries, u_cmds) and the fleet's mean |u|."""
    cfg = NmpcConfig()
    step = batched_tracking_step(dryrun_traj(dtype), ICR, nmpc_cfg=cfg)
    B = batch * mesh.size
    state = shard_scenarios(mesh, make_fleet(B, cfg, dtype, mesh.device)[:4])
    if noise is None:
        noise = torch.Generator(device=mesh.device).manual_seed(mesh.rank)
    else:
        (noise,) = shard_scenarios(mesh, (noise,))
    plants, ekfs, carries, u_cmds, _ = step(*state, noise, 0.0)
    mean_cmd = float(fleet_reduce(mesh, torch.abs(u_cmds), "mean"))
    if not (bool(torch.isfinite(u_cmds).all()) and math.isfinite(mean_cmd)):
        raise AssertionError(f"non-finite commands (mean |u| {mean_cmd})")
    return (plants, ekfs, carries, u_cmds), mean_cmd


def env_program(mesh: Mesh, batch: int = 64, dtype=torch.float32):
    """One sharded contact-plant env step at `batch` lanes a rank, every
    lane pushing forward at 0.4.  Returns this rank's rewards and the
    fleet's mean reward."""
    from ..rl import env_physics as penv
    pcfg = penv.PhysicsEnvConfig()
    B = batch * mesh.size
    gen = torch.Generator().manual_seed(1)
    sts = penv.env_reset(gen, pcfg, dtype, n_envs=B, device="cpu")
    acts = torch.zeros((B, 9), dtype=dtype)
    acts[:, 0] = 0.4
    sts, acts = shard_scenarios(mesh, (sts, acts))
    _, _, r, _ = penv.env_step(sts, acts, pcfg)
    mean_r = float(fleet_reduce(mesh, r, "mean"))
    if not math.isfinite(mean_r):
        raise AssertionError(f"non-finite mean reward {mean_r}")
    return r, mean_r


def synth_flats(goals, dtype=torch.float32, n_pieces: int = 3) -> FlatTraj:
    """Straight 3-piece front-end paths from (0.5, 1) to (0.5 + goal, 1)
    past the obstacle of `plan_esdf`, one lane per goal."""
    g = torch.as_tensor(goals, dtype=dtype)
    B = g.shape[0]
    fr = torch.arange(1, n_pieces, dtype=dtype) / n_pieces
    gf = g[:, None] * fr                                    # (B, n-1)
    inner_pos = torch.stack([0.5 + gf, torch.ones_like(gf),
                             torch.zeros_like(gf)], dim=-1)
    last = torch.stack([0.5 + g, torch.ones_like(g), torch.zeros_like(g)],
                       dim=-1)
    final = torch.zeros((B, 2, 3), dtype=dtype)
    final[:, 1, 0] = g
    return FlatTraj(
        inner_yaw_s=torch.stack([torch.zeros_like(gf), gf], dim=1),
        init_piece_time=torch.full((B,), 0.5, dtype=dtype),
        inner_positions=torch.cat([inner_pos, last[:, None]], dim=1),
        start_state=torch.zeros((B, 2, 3), dtype=dtype),
        final_state=final,
        start_xytheta=torch.tensor([0.5, 1.0, 0.0],
                                   dtype=dtype).expand(B, 3).clone(),
        final_xytheta=last,
        if_cut=torch.zeros((B,), dtype=torch.bool))


def plan_esdf(device, dtype=torch.float32):
    """40x40 cells of 0.1 m with one 0.4 x 0.6 m obstacle."""
    occ = np.zeros((40, 40), bool)
    occ[18:22, 14:20] = True
    return esdf_from_occupancy(torch.as_tensor(occ, device=device),
                               torch.zeros(2, dtype=dtype), 0.1)


def plan_program(mesh: Mesh, batch: int = 64, dtype=torch.float32):
    """Back-end plans at the production caps for `batch` goals a rank
    (goals 1.5-2.5 m).  Returns this rank's (times, collision,
    final_xy_err)."""
    B = batch * mesh.size
    (flats,) = shard_scenarios(
        mesh, (synth_flats(torch.linspace(1.5, 2.5, B, dtype=dtype), dtype),))
    res = plan_backend(flats, plan_esdf(mesh.device, dtype), BackendConfig())
    times, coll, err = res.times, res.collision, res.final_xy_err
    n_coll = int(fleet_reduce(mesh, coll.to(torch.float64), "sum"))
    err_max = float(fleet_reduce(mesh, torch.abs(err), "max"))
    t_min = float(fleet_reduce(mesh, times, "min"))
    if not (bool(torch.isfinite(times).all()) and t_min > 0):
        raise AssertionError(f"invalid plan times (min {t_min})")
    if n_coll:
        raise AssertionError(f"{n_coll} sharded lanes still colliding")
    if not err_max < 1e-2:
        raise AssertionError(f"max |final_xy_err| {err_max}")
    return (times, coll, err), n_coll, err_max


def mission_scenarios(B: int, dtype=torch.float32):
    """(items, targets, robots) of the dry run's mission fleet: one
    object from around (2, 2.5) to around (6, 2.5), robot at (1, 4)."""
    rng = np.random.default_rng(3)
    items = torch.as_tensor(rng.uniform([1.8, 2.3], [2.2, 2.7], (B, 1, 2)),
                            dtype=dtype)
    targets = torch.as_tensor(rng.uniform([5.8, 2.3], [6.2, 2.7],
                                          (B, 1, 2)), dtype=dtype)
    robots = torch.tensor([1.0, 4.0, 0.0], dtype=dtype).expand(B, 3).clone()
    return items, targets, robots


def mission_program(mesh: Mesh, batch: int = 2, approach_ticks: int = 300,
                    push_ticks: int = 400, dtype=torch.float32):
    """Whole one-object missions for `batch` lanes a rank on the 80x80
    map (approach 300 / push 400 ticks deliver).  Returns this rank's
    (object_err, delivered)."""
    occ = np.zeros((80, 80), bool)
    occ[30:40, 44:50] = True
    esdf = esdf_from_occupancy(torch.as_tensor(occ, device=mesh.device),
                               torch.zeros(2), 0.1)
    mcfg = MissionFleetConfig(backend=BackendConfig(),
                              approach_ticks=approach_ticks,
                              push_ticks=push_ticks)
    items, targets, robots = shard_scenarios(
        mesh, mission_scenarios(batch * mesh.size, dtype))
    res = run_mission(items, targets, robots, esdf, ICR, mcfg,
                      device=mesh.device)
    errs, dels = res.object_err, res.delivered
    n_missed = int(fleet_reduce(mesh, (~dels).to(torch.float64), "sum"))
    err_max = float(fleet_reduce(mesh, errs, "max"))
    if not bool(torch.isfinite(errs).all()):
        raise AssertionError("non-finite object errors")
    if n_missed:
        raise AssertionError(f"{n_missed} lanes failed: max err {err_max}")
    if not err_max < mcfg.deliver_tol:
        raise AssertionError(f"max object err {err_max}")
    return (errs, dels), err_max


def dryrun_multichip(mesh: Mesh, tick_batch: int = 256, env_batch: int = 64,
                     plan_batch: int = 64, mission_batch: int = 2,
                     approach_ticks: int = 300, push_ticks: int = 400,
                     dtype=torch.float32) -> dict:
    """The four sharded programs with the JAX package's production
    per-device sizes by default; returns their fleet statistics."""
    def say(msg):
        if mesh.rank == 0:
            print(msg, flush=True)

    _, mean_cmd = tick_program(mesh, tick_batch, dtype)
    say(f"dryrun_multichip OK: {mesh.size} devices, fleet "
        f"{tick_batch * mesh.size}, horizon {NmpcConfig().horizon}, "
        f"mean|u| = {mean_cmd:.4f}")
    _, mean_r = env_program(mesh, env_batch, dtype)
    say(f"dryrun_multichip physics OK: fleet {env_batch * mesh.size}, "
        f"mean reward = {mean_r:.3f}")
    _, n_coll, plan_err = plan_program(mesh, plan_batch, dtype)
    say(f"dryrun_multichip planner OK: fleet {plan_batch * mesh.size}, "
        f"collisions = {n_coll}, max |final_xy_err| = {plan_err:.2e}")
    _, mission_err = mission_program(mesh, mission_batch, approach_ticks,
                                     push_ticks, dtype)
    say(f"dryrun_multichip mission OK: fleet {mission_batch * mesh.size}, "
        f"all delivered, max object err = {mission_err:.3f} m")
    return {"mean_cmd": mean_cmd, "mean_reward": mean_r,
            "plan_collisions": n_coll, "plan_err_max": plan_err,
            "mission_err_max": mission_err}


def train_check(mesh: Mesh, iterations: int, num_envs: int) -> dict:
    """`train(mesh=...)` at float64 on the contact plant against rank 0
    training the same configuration alone: the largest relative gap of
    the history and absolute gap of the parameters (on rank 0), and the
    wall of each run.  Every rank first trains one iteration of 6 lanes
    alone, untimed, so that neither timed run pays the first use of the
    training path's kernels."""
    import time

    from ..rl import registry
    from ..rl.runner import Models, init_models, train

    def cfg_of(n, iters):
        return registry.make("Alore-Push-Flat-v0", num_envs=n,
                             iterations=iters, physics_env=True)

    def run(cfg, m):
        models, _ = init_models(cfg, device=mesh.device)
        models = Models(*(x.double() for x in models))
        t0 = time.perf_counter()
        _, hist = train(cfg, mesh=m, models=models)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return hist, models, time.perf_counter() - t0

    run(cfg_of(6, 1), None)
    cfg = cfg_of(num_envs, iterations)
    hist, models, wall = run(cfg, mesh)
    out = {"num_envs": num_envs, "iterations": iterations,
           "wall_s_mesh": wall, "rewards": [h["mean_reward"] for h in hist]}
    if mesh.rank == 0:
        ref, ref_models, ref_wall = run(cfg, None)
        out["wall_s_one_rank_alone"] = ref_wall
        out["history_max_rel_gap"] = max(
            abs(h[k] - r[k]) / max(abs(r[k]), 1e-300)
            for h, r in zip(hist, ref) for k in r)
        out["params_max_abs_gap"] = max(
            float((a - b).abs().max()) for m, rm in zip(models, ref_models)
            for a, b in zip(m.state_dict().values(),
                            rm.state_dict().values()))
    return out


def _rank_main(rank: int, world: int, port: int, args: dict):
    import json

    import torch.distributed as dist

    from .mesh import make_mesh
    device = args.pop("device")
    train_iters, train_envs = args.pop("train_iters"), args.pop("train_envs")
    kw = {}
    if device == "cpu":
        torch.set_num_threads(1)        # the ranks share the host's cores
    else:
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group("gloo" if device == "cpu" else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world, **kw)
    try:
        mesh = make_mesh(world, device=device)
        out = {"ranks": world, "device": str(mesh.device),
               "backend": dist.get_backend(mesh.group)}
        if mesh.device.type == "cuda":
            out["card"] = torch.cuda.get_device_name(mesh.device)
        out["programs"] = dryrun_multichip(mesh, **args)
        if train_iters:
            out["training"] = train_check(mesh, train_iters, train_envs)
        if rank == 0:
            print("dryrun_multichip result: " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    import argparse
    import socket

    import torch.multiprocessing as mp
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ranks", type=int, default=None,
                   help="processes (default: the cards of this host)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--tick-batch", type=int, default=256)
    p.add_argument("--env-batch", type=int, default=64)
    p.add_argument("--plan-batch", type=int, default=64)
    p.add_argument("--mission-batch", type=int, default=2)
    p.add_argument("--approach-ticks", type=int, default=300)
    p.add_argument("--push-ticks", type=int, default=400)
    p.add_argument("--train-iters", type=int, default=0)
    p.add_argument("--train-envs", type=int, default=1536)
    a = p.parse_args(argv)
    ranks = a.ranks or torch.cuda.device_count()
    if ranks < 1:
        raise SystemExit("no card found: pass --ranks (with --device cpu "
                         "for gloo ranks on this host)")
    if a.device == "cuda" and torch.cuda.device_count() < ranks:
        raise SystemExit(f"{ranks} ranks need {ranks} cards; "
                         f"{torch.cuda.device_count()} found")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    args = {k: v for k, v in vars(a).items() if k != "ranks"}
    mp.spawn(_rank_main, args=(ranks, port, args), nprocs=ranks, join=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
