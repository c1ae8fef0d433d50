"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing lines of its own under a header with the seconds
since the script started:

1. Card and build: the card's name and power limit, the precision
   policy, and the build of the wavefront kernels from
   alore_legged_manipulator_tpu_torch/csrc/ with nvcc (sm_90a).
2. Kernels against their plain PyTorch versions on the card: K1
   (`wavefront_packed_cuda`) and K2 (`octile_distance_field_cuda`) on
   random-obstacle 80x80 grids at the mission's launch shape (B=64) and
   at B=192, and on the 100x100 bench map (B=4096).  Fields, packed
   words and sweep counts must be bit-identical and the extracted paths
   identical; each kernel and its plain version are timed with CUDA
   events after a warm-up.  Also bit-identical: a serpentine grid whose
   relaxation `n_iters` cuts short, goals outside the grid and on blocked
   cells, and a 150x150 grid; a 162x162 grid, the first square one that
   fits no block, must be refused with ValueError.  The runtime's
   occupancy report is printed for each instantiation used.
3. The production mission on the card at full width: B=64 three-object
   missions on the 80x80 map (wavefront front end, MINCO back end with
   the compact solver direction, NMPC + ICR-EKF closed-loop push) through
   `run_mission`, then `correct_until_delivered` with 300-tick correction
   legs for the missed lanes and `mission_seconds_exact`, and the fleet's
   first-leg field once more through the public `octile_distance_field`
   (K2).  The kernels' launch counts are set to 0 just before and read
   just after: K1 must have run once per leg and once per correction
   round, K2 once.  Lanes delivered before the rounds must come out of
   them bit for bit.
4. The ring-direction fleet of the first slice, cut in depth to K=1,
   approach_ticks=300, push_ticks=100 (B=64, no corrections), with its
   own launch counts: its plans must reach their goals, its pushes follow
   them, and its objects advance as far as the production fleet's first
   leg does in as many ticks.  Then the host wall time of each phase of
   the production fleet's first leg with the push cut to 30 ticks
   (shares, per-tick times and dispatched operations per tick; both
   plants are run a few ticks first), with the ring back end and the
   same push on the contact plant beside it.  Then the first legs of 2
   missions, cut to 300/200 ticks, with plant noise off, on the card
   through the kernel and on the CPU through the plain versions: the
   front end agrees to 1e-9 in f64; on each device the plans reach their
   goals and the pushes follow them, and the card's objects advance at
   the CPU's pace.
5. The contact plant.  The fleet at full width on it: B=64, K=1,
   plant="physics", the production profile otherwise, then
   `correct_until_delivered` with 300-tick legs; K1 must run 1 + rounds
   times, delivered lanes must come out of the rounds bit for bit, and
   `delivered_frac` after the rounds must reach 0.75.  Then 4 lanes
   through 100 `physics_substep`s (servo, grasp weld, contact, a static
   box) in float64 on the card and on the CPU, agreeing to 1e-9.  Then
   the known-map arrangement of tests/test_arrangement.py's scene cut in
   depth to its push's plan (`PlanManager`, JPS front end, MINCO back
   end) and the push's first KNOWN_MAP_PUSH_S simulated seconds on the
   contact plant, held to that test's p95 tracking bound; then the
   arrangement mission on the contact plant on the card (ordering ->
   task FSM -> JPS front end -> PlanManager -> push), its first object,
   on a map that starts empty and is fused from 3 m lidar scans
   (`mapped=True`, MappedPlanManager), so that the wall is discovered on
   the way, held to the mapped test's bounds, sensing timed as its own
   phase; both with host wall time by phase.
6. The planner simulation (`run_planner_sim`) at the goldens' full width
   (140x60 corridor, 360 beams to 5 m, LTV horizon 30 with 3 x 150 ADMM
   passes, NMPC N=50, float32), cut in depth to PS_LTV_T and PS_NMPC_T
   simulated seconds: the `corridor` golden under the LTV-MPC with
   perspective fusion, and `nmpc_corridor_raycast` under the NMPC with
   the host beam scan and raycast fusion.  Each is held to the compiled
   reference's golden over its prefix (gate attempts at its plan ticks,
   trajectory starts, FSM edges, the truth-pose band, no pose in an
   occupied cell), with wall time by phase, per plan and per tick.
   `planner_probe()` runs both for 0.1 s alone.
7. Variants on the card at B=64, N=50: the NMPC tick in its dense
   triangular, assoc and seq modes against the matrix-free path, a
   32-piece spline by cyclic reduction against the dense 6N system, and
   the ring, compact and dense solver directions on a batched quadratic.
8. The trained high-level pushing policy, served
   (models/weights/highlevel_physics_6000.npz, the JAX package's
   6000-iteration contact-plant checkpoint): its mean actions and
   velocity estimates on 256 contact-plant histories on the card against
   the CPU (f32, 1e-4), the B=1 forward's p50/p99 latency against the
   20 ms of a 50 Hz tick and its dispatched operations; the fixed-command
   tracking eval of examples/train_and_deploy_highlevel.py on the contact
   plant (256 lanes x 100 steps, held to the JAX package's value + 0.05
   per axis); the perception -> FSM -> policy bus mission with the
   policy and the contact plant on the card (DONE within 0.5 m, wall by
   phase); the frozen low-level WBC with seeded random weights, card
   against CPU (50 deployment ticks at f32 within 1e-4, 10 contact-plant
   hierarchy steps at f64 within 1e-9).  `served_probe()` runs these and
   the known-map push alone.
9. Training the high-level policy and the camera perception path: PPO
   at full width (B=1536 x 24 contact-plant steps, TRAIN_ITERS
   iterations) from the JAX package's seed-0 initial parameters
   (models/weights/train_init_physics_seed0.npz), each iteration printed
   beside examples/artifacts/train_physics_6000.csv, iteration 0's KL
   and lr and the rewards of iterations 0 and 9 held to REWARD_BANDS
   (set by `training_bands()`), the estimator loss within 3x of the
   CSV's; the trained state through the checkpoint round trip (mean
   actions bit for bit); one f64 PPO update card vs CPU (1e-9); the
   camera's frame card vs CPU and the depth cloud into the voxel map;
   the bus mission on camera perception (every object delivered within
   0.35 m, wall by phase).  `train_camera_probe()` runs these alone.
10. The `kernels` JSON line (with K1 and K2's launches on each path, 0
   on the planner simulation, the mapped mission, the served policy,
   training and the camera mission, whose paths hold no wavefront), the
   script's wall time, and as the last line {"ok": true, "device":
   {...}}.

Fails (non-zero exit, no result line) without a CUDA card or without the
package beside it.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# shared memory: 132 SMs x 128 B/clock x 1.98 GHz
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9
T_START = time.perf_counter()
# simulated seconds of the two planner-simulation phases (depth cut)
PS_LTV_T = 0.5
PS_NMPC_T = 0.3
# simulated seconds of the known-map arrangement's push (depth cut)
KNOWN_MAP_PUSH_S = 1.0
# push ticks of the ring fleet and of the timed first leg (depth cuts)
RING_PUSH_TICKS = 100
LEG_PUSH_TICKS = 30
# the JAX package's fixed-command eval of the trained contact-plant
# policy, per axis (vx, vy, wz), on the CPU (tests/jax_tracking_eval.py)
JAX_EVAL_ERR = (0.111050, 0.053142, 0.103891)
POLICY_BUDGET_MS = 20.0         # one tick of the 50 Hz high-level loop
# the JAX package's contact-plant training run, and the iterations the
# training phase runs from its start
TRAIN_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "examples", "artifacts", "train_physics_6000.csv")
TRAIN_ITERS = 10
# mean reward bands around the CSV's iterations 0 and 9, from the port's
# own runs of the same configuration under generator seeds 1-3
# (`training_bands()`): half-width 1.5x the range of their values and
# the CSV's
REWARD_BANDS = {0: (0.5782137215137482, 0.6098267734050751),
                9: (0.6905695199966431, 2.223431944847107)}
# pixels of differing label or mask allowed between two f32 renders
# (tests/test_torch_camera.py holds the port to JAX with the same count)
EDGE_PIXELS_F32 = 4


def _phase(name):
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


def check_identical(wf, wfc, label, occ, goals, n_iters=None):
    """K1 and K2 against the plain versions on one input: field, packed
    word and sweep count bit for bit.  Returns the kernel's outputs and
    the largest absolute field error of each kernel (0.0 when it passes)."""
    blk = torch.as_tensor(occ, device="cuda")
    g = torch.as_tensor(goals, device="cuda")
    d_k, p_k, sweeps = wfc.wavefront_packed_cuda(blk, g, n_iters,
                                                 return_sweeps=True)
    d_f, sweeps_f = wfc.octile_distance_field_cuda(blk, g, n_iters,
                                                   return_sweeps=True)
    d_p, p_p, sweeps_p = wf.wavefront_packed_torch(blk, g, n_iters,
                                                   return_sweeps=True)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p), f"{label}: K1 dist differs from plain"
    assert torch.equal(p_k, p_p), f"{label}: K1 packed differs from plain"
    assert torch.equal(d_f, d_p), f"{label}: K2 dist differs from plain"
    assert torch.equal(sweeps, sweeps_p), f"{label}: K1 sweep counts differ"
    assert torch.equal(sweeps_f, sweeps_p), f"{label}: K2 sweep counts differ"
    return blk, g, sweeps, (float((d_k - d_p).abs().max()),
                            float((d_f - d_p).abs().max()))


def check_kernels(wf, wfc, label, occ, goals, starts, path_len, iters):
    """Bit-exactness and timings of K1 and K2 against the plain versions
    at one shape; returns {kernel: measurements}."""
    from alore_legged_manipulator_tpu_torch.ops.wavefront_bench import (
        bound, time_ms)
    B, H, W = occ.shape
    blk, g, sweeps, (err1, err2) = check_identical(wf, wfc, label, occ, goals)
    s = torch.as_tensor(starts, device="cuda")
    _, c_k, v_k = wf.wavefront_path(blk, g, s, path_len, impl="cuda")
    _, c_p, v_p = wf.wavefront_path(blk, g, s, path_len, impl="torch")
    assert torch.equal(c_k, c_p) and torch.equal(v_k, v_p), \
        f"{label}: wavefront_path cells/valid differ"
    # what a sweep of this design moves through shared memory when every
    # strip recomputes: two rows of S + 2 floats and two border cells
    # read, S floats written, for S cells
    S = wfc.strip_geometry(H, W, None, B <= 2 * wfc._sm_count(0)).strip
    smem_bytes_cell = 4.0 * (2 * (S + 2) + 2 + S) / S

    sw = int(sweeps.to(torch.int64).sum())             # sum over lanes
    out = {}
    for name, fn, plain, err in (
            ("wavefront_packed",
             lambda: wfc.wavefront_packed_cuda(blk, g),
             lambda: wf.wavefront_packed_torch(blk, g), err1),
            ("octile_distance_field",
             lambda: wfc.octile_distance_field_cuda(blk, g),
             lambda: wf.octile_distance_field_torch(blk, g), err2)):
        ms = time_ms(fn, iters)
        plain_ms = time_ms(plain, 1, warmup=1)
        bound_ms, bound_by = bound(B, H, W, sw, name == "wavefront_packed")
        out[name] = dict(
            shape=f"{B}x{H}x{W}", ms=ms, plain_ms=plain_ms, max_abs_err=err,
            bound_ms=bound_ms, bound_by=bound_by,
            smem_full_sweeps_ms=(sw * H * W * smem_bytes_cell
                                 / SMEM_BYTES_PER_S * 1e3),
            smem_bound_first_design_ms=(sw * H * W * 9 * 4
                                      / SMEM_BYTES_PER_S * 1e3),
            strip=S, sweeps_mean=sw / B, sweeps_max=int(sweeps.max()),
            **{k: v for k, v in wfc.occupancy(
                H, W, name == "wavefront_packed", S).items()
               if k in ("blocks_per_sm", "registers", "threads",
                        "smem_bytes", "spill_bytes")})
        print(f"{label} {name}: bit-identical to plain; "
              + json.dumps(out[name]), flush=True)
    mean_turn_cells = float(v_k.sum(1).to(torch.float32).mean())
    print(f"{label} wavefront_path: cells and valid identical "
          f"(mean valid cells {mean_turn_cells:.1f})", flush=True)
    return out


def dispatched_ops(fn, grad=False) -> int:
    """Number of PyTorch operations `fn` dispatches, views included: what
    a launch-bound path pays for on any device (`grad`: with autograd on,
    the backward's operations included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count(), torch.set_grad_enabled(grad):
        fn()
    return Count.n


def ops_per_tick(tt, icr, loop_cfg):
    """Operations one closed-loop tick dispatches on each plant, for the
    lanes of `tt` (the difference of a 4-tick and a 2-tick run)."""
    from alore_legged_manipulator_tpu_torch.runtime.closed_loop import (
        simulate_tracking)
    from alore_legged_manipulator_tpu_torch.runtime.closed_loop_physics import (
        PhysicsLoopConfig, simulate_tracking_physics)
    runs = {"kinematic": lambda k: simulate_tracking(tt, icr, k, loop_cfg),
            "physics": lambda k: simulate_tracking_physics(
                tt, k, PhysicsLoopConfig())}
    return {name: (dispatched_ops(lambda: run(4))
                   - dispatched_ops(lambda: run(2))) // 2
            for name, run in runs.items()}


def leg_phases(mf, items, targets, robot0, esdf, icr, cfg, push_ticks):
    """Host wall time of each phase of the fleet's first leg, each phase
    ended by a synchronize: the steps of run_mission and _push_leg, with
    the push cut to `push_ticks` ticks and the closed loop also reported
    per tick.  Beside the total: the ring back end on the same leg, and
    the same push on the contact plant (`simulate_tracking_physics`)."""
    from alore_legged_manipulator_tpu_torch.control.tracked_traj import (
        build_tracked_traj)
    from alore_legged_manipulator_tpu_torch.planner.backend import plan_backend
    from alore_legged_manipulator_tpu_torch.planner.flat_traj import Polynome
    from alore_legged_manipulator_tpu_torch.runtime.closed_loop import (
        simulate_tracking)
    from alore_legged_manipulator_tpu_torch.runtime.closed_loop_physics import (
        PhysicsLoopConfig, simulate_tracking_physics)
    dev = torch.device("cuda")
    it = torch.as_tensor(items, device=dev)
    tg = torch.as_tensor(targets, device=dev)
    robot = torch.as_tensor(robot0, device=dev)
    B = it.shape[0]
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    with torch.no_grad():
        leg_esdf = timed("paint_esdf", lambda: mf._painted_esdf(
            esdf, it[:, 1:], cfg.paint_half_extents))
        robot = timed("approach", lambda: mf._approach(
            robot, it[:, 0], cfg.fsm, cfg.approach_ticks))
        flat = timed("front_end", lambda: mf._wavefront_flat(
            leg_esdf, it[:, 0], robot[:, 2], tg[:, 0], cfg))
        res = timed("back_end", lambda: plan_backend(flat, leg_esdf,
                                                     cfg.backend))
        icr_vec = torch.tensor([icr.yr, icr.yl, icr.xv], device=dev).expand(B, 3)
        tt = timed("tracked_traj", lambda: build_tracked_traj(Polynome(
            traj_start_time=torch.zeros(B, device=dev), inner_points=res.inner,
            piece_times=res.times, init_state=flat.start_state,
            tail_state=res.tail_state, start_position=flat.start_xytheta,
            icr=icr_vec), n_grid=256))
        # counting runs a few ticks of both plants first: the timed ticks
        # carry no first-use costs of the contact plant
        ops = ops_per_tick(tt, icr, cfg.loop)
        timed("closed_loop", lambda: simulate_tracking(
            tt, icr, push_ticks, cfg.loop, seed=0, x0=tt.seq[:, 0]))
        # beside the total: the ring direction on the very same leg, and
        # the same push on the contact plant
        res_ring = timed("back_end_ring", lambda: plan_backend(
            flat, leg_esdf,
            cfg.backend._replace(solver_direction="ring")))
        timed("closed_loop_physics", lambda: simulate_tracking_physics(
            tt, push_ticks, PhysicsLoopConfig(), seed=0))
    ring_s = times.pop("back_end_ring")
    phys_s = times.pop("closed_loop_physics")
    total = sum(times.values())
    print("first-leg phases (s): " + json.dumps(
        {**times, "leg_total": total, "push_ticks": push_ticks,
         "shares": {k: v / total for k, v in times.items()},
         "closed_loop_s_per_tick": times["closed_loop"] / push_ticks,
         "approach_s_per_tick": times["approach"] / cfg.approach_ticks,
         "closed_loop_physics_s_per_tick": phys_s / push_ticks,
         "physics_over_kinematic_tick": phys_s / times["closed_loop"],
         "ops_per_tick": ops,
         "solver_direction": cfg.backend.solver_direction,
         "back_end_stage2_iters_max": int(res.stage2_iters.max()),
         "back_end_replans_max": int(res.replans.max()),
         "back_end_ring": ring_s,
         "back_end_ring_stage2_iters_max": int(res_ring.stage2_iters.max()),
         "back_end_ring_replans_max": int(res_ring.replans.max())}),
        flush=True)


def mission_field_through_k2(wf, esdf, targets32, cfg, B):
    """The field alone, as a user asks for it: the first leg's targets on
    the mission's inflated map through the public entry point (K2).
    Returns the field and its inputs."""
    blk_m = (esdf.dist < cfg.wf_safe_dis).expand(B, 80, 80).contiguous()
    goal_m = torch.clamp(torch.as_tensor(targets32[:, 0] / 0.1,
                                         device="cuda").to(torch.int32),
                         0, 79)
    field_m = wf.octile_distance_field(blk_m, goal_m)
    torch.cuda.synchronize()
    return field_m, blk_m, goal_m


def fleet_summary(res):
    err = res.object_err
    return {
        "delivered_frac": float(res.delivered.float().mean()),
        "delivered_per_leg": res.delivered.sum(0).tolist(),
        "object_err_mean": float(err.mean()),
        "object_err_max": float(err.max()),
        "plan_err_max": float(res.plan_err.max()),
        "collision_frac": float(res.collision.float().mean()),
        "track_err_max": float(res.track_err_max.max())}


def assert_finite(res, shape_bk, push_ticks):
    B, K = shape_bk
    assert res.object_err.shape == (B, K) and res.push_traj.shape == \
        (B, K, push_ticks, 3)
    for name, v in res._asdict().items():
        assert v.device.type == "cuda", f"{name} left the card"
        if v.dtype.is_floating_point:
            assert bool(torch.isfinite(v).all()), f"non-finite {name}"


def advance(traj):
    """How far each object moved over a push trace (B, T, 3)."""
    return torch.linalg.vector_norm(traj[:, -1, :2] - traj[:, 0, :2], dim=-1)


def ring_fleet(mf, wf, wfc, items32, targets32, robot0, esdf, icr, field_m,
               prod):
    """The first slice's ring-direction fleet, cut in depth to K=1, 300
    approach and RING_PUSH_TICKS push ticks, with its own launch counts; `prod` is the production
    fleet's result before its rounds.  Returns the launches."""
    _phase("ring fleet B=64 K=1 on the card (no corrections, cut in depth)")
    B = items32.shape[0]
    cfg_ring = mf.MissionFleetConfig(approach_ticks=300,
                                     push_ticks=RING_PUSH_TICKS)
    assert cfg_ring.backend.solver_direction == "ring"
    wfc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_ring = mf.run_mission(items32[:, :1], targets32[:, :1], robot0, esdf,
                              icr, cfg_ring)
    torch.cuda.synchronize()
    wall_ring = time.perf_counter() - t0
    field_r, _, _ = mission_field_through_k2(wf, esdf, targets32, cfg_ring, B)
    launches_ring = dict(wfc.LAUNCHES)
    print("launches during the ring fleet:", json.dumps(launches_ring),
          flush=True)
    assert launches_ring["wavefront_packed"] == 1
    assert launches_ring["octile_distance_field"] == 1
    assert torch.equal(field_r, field_m)
    assert_finite(res_ring, (B, 1), cfg_ring.push_ticks)
    ring = fleet_summary(res_ring)
    # a 1 s push delivers no 4-7 m leg.  Its outcome: how far the objects
    # advance, against the production fleet's first leg (same items and
    # targets, its map painted with the other objects) over as many ticks
    n = cfg_ring.push_ticks
    adv_ring = advance(res_ring.push_traj[:, 0])
    adv_prod = advance(prod.push_traj[:, 0, :n])
    ring["advance_mean_m"] = float(adv_ring.mean())
    ring["advance_min_m"] = float(adv_ring.min())
    ring["production_advance_mean_m"] = float(adv_prod.mean())
    ring["advance_ratio"] = ring["advance_mean_m"] \
        / ring["production_advance_mean_m"]
    print(json.dumps({"missions": B, "objects": 1, "solver_direction": "ring",
                      "approach_ticks": cfg_ring.approach_ticks,
                      "push_ticks": cfg_ring.push_ticks,
                      "fleet_wall_s": wall_ring, **ring}), flush=True)
    # the plans reach their goals, the pushes follow them, and the
    # objects advance at the production fleet's pace
    assert ring["plan_err_max"] < 0.02, ring
    assert ring["track_err_max"] < 0.2, ring
    assert ring["collision_frac"] == 0.0, ring
    assert 0.8 <= ring["advance_ratio"] <= 1.25, ring
    return launches_ring


def small_fleet(dev, items, targets, robot0, occ, cfg, icr):
    """The first legs of a few missions on one device: the front end in
    f64 and the f32 mission.  Returns (FlatTraj, MissionFleetResult) on
    the CPU."""
    from alore_legged_manipulator_tpu_torch.ops.esdf import esdf_from_occupancy
    from alore_legged_manipulator_tpu_torch.runtime import mission_fleet as mf
    e = esdf_from_occupancy(torch.as_tensor(occ, device=dev), torch.zeros(2),
                            0.1)

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)
    B = items.shape[0]
    flat = mf._wavefront_flat(e, f64(items[:, 0]), f64(np.zeros(B)),
                              f64(targets[:, 0]), cfg)
    r = mf.run_mission(items, targets, robot0, e, icr, cfg, device=dev)
    return (type(flat)(*(t.cpu() for t in flat)),
            type(r)(*(t.cpu() for t in r)))


def small_fleet_card_vs_cpu(items32, targets32, robot0, occ, cfg, icr):
    """The first legs of 2 of the production missions (unpainted map, cut
    to 300/200 ticks, plant noise off) on the card through the kernel and
    on the CPU through the plain versions.  The front end agrees to 1e-9
    in f64 (only libm rounding differs).  The f32 back ends settle on
    plans apart (the back end is chaotic: tests/test_torch_arrangement.py),
    so a 2 s push ends at another point of its path: each device's plans
    must reach their goals and its pushes follow them, and the card's
    objects advance at the CPU's pace."""
    Bs = 2
    loop = cfg.loop._replace(plant=cfg.loop.plant._replace(add_noise=False))
    cfg_s = cfg._replace(approach_ticks=300, push_ticks=200, loop=loop)
    args = (items32[:Bs, :1], targets32[:Bs, :1], robot0[:Bs], occ, cfg_s,
            icr)
    out, wall = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[dev] = small_fleet(dev, *args)
        wall[dev] = time.perf_counter() - t0
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        same = (torch.allclose(a, b, rtol=0, atol=1e-9)
                if a.dtype.is_floating_point else torch.equal(a, b))
        assert same, "front end differs between card and CPU"
    rc, rp = out["cuda"][1], out["cpu"][1]
    end_gap = torch.linalg.vector_norm(
        rc.push_traj[:, 0, -1, :2] - rp.push_traj[:, 0, -1, :2], dim=-1)
    adv = {dev: advance(r.push_traj[:, 0]) for dev, r in (("cuda", rc),
                                                          ("cpu", rp))}
    ratio = float(adv["cuda"].mean() / adv["cpu"].mean())
    print("front end agrees to 1e-9 (f64); " + json.dumps({
        "push_end_gap_m": end_gap.tolist(),
        "advance_card_m": adv["cuda"].tolist(),
        "advance_cpu_m": adv["cpu"].tolist(), "advance_ratio": ratio,
        "plan_err_card": rc.plan_err.flatten().tolist(),
        "plan_err_cpu": rp.plan_err.flatten().tolist(),
        "track_err_max_card": rc.track_err_max.flatten().tolist(),
        "track_err_max_cpu": rp.track_err_max.flatten().tolist(),
        "wall_s": wall}), flush=True)
    for r in (rc, rp):
        assert float(r.plan_err.max()) < 0.02, r.plan_err
        assert float(r.track_err_max.max()) < 0.2, r.track_err_max
        assert not bool(r.collision.any())
    assert 0.8 <= ratio <= 1.25, f"card advance ratio {ratio}"


def physics_fleet(mf, wfc, esdf, icr, backend_cfg):
    """The contact-plant fleet at full width: B=64, K=1, plant="physics",
    the production profile otherwise, then correct_until_delivered with
    300-tick legs.  Returns (K1 launches, summary)."""
    B, corr_ticks = 64, 300
    cfg = mf.MissionFleetConfig(approach_ticks=700, push_ticks=550,
                                backend=backend_cfg, plant="physics")
    items, targets = mf.spaced_scenarios(B, 1, np.random.default_rng(0))
    items, targets = items.astype(np.float32), targets.astype(np.float32)
    robot0 = np.tile(np.array([1.0, 4.0, 0.0], np.float32), (B, 1))
    # the largest grasp gap of every push, read from the plant's result
    gaps = []
    sim = mf.simulate_tracking_physics

    def recording(*a, **kw):
        out = sim(*a, **kw)
        gaps.append(float(out.grasp_gap.max()))
        return out
    mf.simulate_tracking_physics = recording
    try:
        wfc.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        base = mf.run_mission(items, targets, robot0, esdf, icr, cfg)
        torch.cuda.synchronize()
        wall_fleet = time.perf_counter() - t0
        t0 = time.perf_counter()
        res, miss_counts = mf.correct_until_delivered(base, targets, esdf,
                                                      icr, cfg, corr_ticks)
        torch.cuda.synchronize()
        wall_rounds = time.perf_counter() - t0
        launches = dict(wfc.LAUNCHES)
    finally:
        mf.simulate_tracking_physics = sim
    rounds = len(miss_counts)
    print("launches during the contact-plant fleet:", json.dumps(launches),
          flush=True)
    assert launches["wavefront_packed"] == 1 + rounds, \
        f"K1 ran {launches['wavefront_packed']} times, not 1 + {rounds}"
    assert_finite(base, (B, 1), cfg.push_ticks)
    assert_finite(res, (B, 1), cfg.push_ticks)
    before, after = fleet_summary(base), fleet_summary(res)
    keep = base.delivered
    for name in ("object_err", "track_err_max", "collision", "delivered",
                 "push_traj"):
        assert torch.equal(getattr(res, name)[keep],
                           getattr(base, name)[keep]), \
            f"{name} of a delivered lane changed in the rounds"
    summary = {"missions": B, "objects": 1, "plant": "physics",
               "correction_ticks": corr_ticks, "fleet_wall_s": wall_fleet,
               "rounds_wall_s": wall_rounds, "rounds": rounds,
               "miss_counts": miss_counts,
               "grasp_gap_max": max(gaps), "grasp_gap_max_per_push": gaps,
               "before_rounds": before, "after_rounds": after}
    print(json.dumps(summary), flush=True)
    assert np.isfinite(max(gaps))
    assert after["delivered_frac"] >= before["delivered_frac"]
    assert after["delivered_frac"] >= 0.75, \
        f"contact-plant delivered_frac {after['delivered_frac']} below 0.75"
    return launches, summary


def physics_card_vs_cpu():
    """4 lanes through 100 physics_substeps (servo, grasp weld, contact
    with the object and with a static box) in float64 on the card and on
    the CPU: poses and velocities agree to 1e-9."""
    from alore_legged_manipulator_tpu_torch.world import physics2d as ph
    rng = np.random.default_rng(2)
    B = 4
    yaw = rng.uniform(-np.pi, np.pi, B)
    pose = np.zeros((B, 3, 3))
    pose[:, :, 2] = yaw[:, None]
    for k, dist in ((1, 0.74), (2, 1.55)):
        pose[:, k, 0] = dist * np.cos(yaw)
        pose[:, k, 1] = dist * np.sin(yaw)
    mass = np.broadcast_to([60.0, 15.0, np.inf], (B, 3)).copy()
    he = np.broadcast_to([[0.45, 0.3], [0.3, 0.3], [0.3, 0.8]], (B, 3, 2)).copy()
    cmd = np.stack([rng.uniform(0.2, 0.5, B), rng.uniform(-0.1, 0.1, B),
                    rng.uniform(-0.3, 0.3, B)], -1)
    cfg = ph.PhysicsConfig(grasp_impulse_cap=600.0)
    out = {}
    for dev in ("cuda", "cpu"):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)
        st = ph.BodyState(pose=t(pose), vel=t(np.zeros((B, 3, 3))),
                          mass=t(mass), inertia=ph.box_inertia(t(mass), t(he)),
                          half_ext=t(he), box_off=t(np.zeros((B, 3, 2))),
                          mu_ground=t(np.full((B, 3), 0.4)))
        grasp = (torch.tensor(True, device=dev), 0, t([0.65, 0.0]), 1,
                 t([-0.3, 0.0]), torch.tensor(True, device=dev))
        mask = torch.tensor([True, False, False], device=dev)
        pn = 0.0
        for _ in range(100):
            w = ph.servo_forces(st, 0, t(cmd), cfg)
            st, dbg = ph.physics_substep(st, w, [(0, 1), (1, 2)], cfg,
                                         grasp=grasp, servo_mask=mask)
            pn = max(pn, float(dbg.pn.max()))
        out[dev] = (st, pn)
    (gpu, pn_gpu), (cpu, pn_cpu) = out["cuda"], out["cpu"]
    err = max(float((gpu.pose.cpu() - cpu.pose).abs().max()),
              float((gpu.vel.cpu() - cpu.vel).abs().max()))
    moved = float((cpu.pose[:, 1, :2] - torch.as_tensor(pose[:, 1, :2])).norm(
        dim=-1).min())
    print("contact plant, 4 lanes x 100 substeps (f64), card vs CPU: "
          + json.dumps({"max_abs_err": err, "pn_max": pn_cpu,
                        "object_moved_min_m": moved}), flush=True)
    assert np.isfinite(err) and err < 1e-9, f"card vs CPU physics: {err}"
    assert pn_cpu > 0 and pn_gpu > 0 and moved > 0.05
    assert bool(torch.isfinite(gpu.pose).all())
    return err


class PhaseClock:
    """Host wall time by phase of the functions it wraps, each call ended
    by a synchronize.  A wrapped call made inside another is billed to
    its own phase only, so the phases add up to their wall time."""

    def __init__(self):
        self.phases, self.calls = {}, {}
        self._stack, self._orig = [], []

    def wrap(self, owner, name, bucket):
        fn = getattr(owner, name)
        self._orig.append((owner, name, fn))

        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._stack.append(0.0)
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                inner = self._stack.pop()
                total = time.perf_counter() - t0
                self.phases[bucket] = self.phases.get(bucket, 0.0) \
                    + total - inner
                self.calls[bucket] = self.calls.get(bucket, 0) + 1
                if self._stack:
                    self._stack[-1] += total
        setattr(owner, name, wrapped)

    def restore(self):
        for owner, name, fn in reversed(self._orig):
            setattr(owner, name, fn)
        self._orig = []

    def report(self, wall):
        """Phases with the rest of the wall time as `other_host`."""
        return {**self.phases, "other_host": wall - sum(self.phases.values())}


def known_map_push_on_card(wfc, push_s=KNOWN_MAP_PUSH_S):
    """The known-map arrangement's push on the contact plant, on the
    card, cut in depth to its plan and the first `push_s` simulated
    seconds of its push: tests/test_arrangement.py's scene (100x100,
    wall occ[48:52, 20:45]) with every item painted, the pushed item
    unlocked, `PlanManager` planning item (2.5, 2.5) to target (8, 7.5)
    from the robot's heading on arrival (from its start (5, 1)), then
    `simulate_tracking_physics` for push_s.  Held to that test's p95
    tracking bound (0.25 m) over the simulated part.  Host wall time by
    phase.  Returns the summary and K1/K2 launches."""
    from alore_legged_manipulator_tpu_torch.mission import plan_manager as pm
    from alore_legged_manipulator_tpu_torch.runtime import (
        closed_loop_physics as clp)
    occ = np.zeros((100, 100), bool)
    occ[48:52, 20:45] = True
    item, target, start = (2.5, 2.5), (8.0, 7.5, 0.0), (5.0, 1.0)
    clock = PhaseClock()
    clock.wrap(pm, "plan_frontend", "front_end")
    clock.wrap(pm, "esdf_from_occupancy", "esdf_updates")
    clock.wrap(pm, "plan_backend", "back_end")
    clock.wrap(pm, "build_tracked_traj", "tracked_traj")
    clock.wrap(clp, "simulate_tracking_physics", "tracking")
    wfc.reset_launches()
    ticks = int(round(push_s / 0.01))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        man = pm.PlanManager(occ=occ.copy(), lower=(0.0, 0.0), res=0.1,
                             cfg=pm.PlanManagerConfig())
        man.paint_square(np.asarray(item), half_size=0.25)
        man.paint_square(np.asarray(item), half_size=0.3, make_obs=False)
        yaw = float(np.arctan2(item[1] - start[1], item[0] - start[0]))
        man.set_goal(target)
        msg = man.tick(0.0, np.array([item[0], item[1], yaw]))
        assert msg is not None, f"push planning failed: {man.state}"
        dur = float(man.tracked.duration[0])
        res = clp.simulate_tracking_physics(man.tracked, ticks,
                                            clp.PhysicsLoopConfig(), seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        clock.restore()
    launches = dict(wfc.LAUNCHES)
    perr = res.pos_err[0, :min(ticks, int(dur / 0.01))].cpu().numpy()
    summary = {"plan_duration_s": dur, "simulated_push_s": push_s,
               "push_tracking_err_p95": float(np.percentile(perr, 95)),
               "grasp_gap_max": float(res.grasp_gap.max()),
               "object_moved_m": float(np.linalg.norm(
                   res.obj_xytheta[0, -1, :2].cpu().numpy()
                   - np.asarray(item))),
               "wall_s": wall, "wall_by_phase_s": clock.report(wall),
               "kernel_launches": launches}
    print("known-map arrangement push, contact plant, plan and first "
          f"{push_s} s, on the card: " + json.dumps(summary), flush=True)
    assert summary["push_tracking_err_p95"] < 0.25, summary
    assert summary["object_moved_m"] > 0.1 * push_s, summary
    assert bool(torch.isfinite(res.obj_xytheta).all())
    return summary, launches


def arrangement_on_card(wfc):
    """The arrangement mission of tests/test_arrangement.py's scene on
    the contact plant, on the card, cut to its first object: item (2.5,
    2.5) to target (8, 7.5) past the wall occ[48:52, 20:45].  The
    planning map starts empty and is fused from 3 m lidar scans
    (MappedPlanManager, raycast), so the wall is found on the way.  Host
    wall time by phase, sensing its own.  Returns (summary, K1/K2
    launches)."""
    from alore_legged_manipulator_tpu_torch.mission import plan_manager as pm
    from alore_legged_manipulator_tpu_torch.runtime import arrangement as arr
    from alore_legged_manipulator_tpu_torch.world.lidar import LidarConfig
    occ = np.zeros((100, 100), bool)
    occ[48:52, 20:45] = True
    mission = arr.ArrangementMission(
        occ=occ, lower=(0.0, 0.0), res=0.1, items=[(2.5, 2.5, 0.0)],
        targets=[(8.0, 7.5, 0.0)], use_physics_plant=True, mapped=True,
        lidar_cfg=LidarConfig(max_range=3.0))
    clock = PhaseClock()
    clock.wrap(arr, "jps_search", "ordering_and_approach_jps")
    clock.wrap(pm, "plan_frontend", "front_end")
    clock.wrap(pm, "esdf_from_occupancy", "esdf_updates")
    clock.wrap(pm, "plan_backend", "back_end")
    clock.wrap(pm, "build_tracked_traj", "tracked_traj")
    clock.wrap(arr, "simulate_tracking_physics", "tracking")
    clock.wrap(pm.MappedPlanManager, "sense", "sensing")
    wfc.reset_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = mission.run(robot_start=(5.0, 1.0, 1.57))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        clock.restore()
    launches = dict(wfc.LAUNCHES)
    summary = {"mapped": True, "order": rep.order,
               "delivered": rep.delivered,
               "final_object_err": rep.final_object_err,
               "push_tracking_err_p95": rep.push_tracking_err_p95,
               "sim_time_s": rep.sim_time_s, "wall_s": wall,
               "wall_by_phase_s": clock.report(wall),
               "scans": clock.calls.get("sensing", 0),
               "kernel_launches": launches}
    print("arrangement mission, first object, contact plant, lidar-mapped "
          "map, on the card: " + json.dumps(summary), flush=True)
    assert all(rep.delivered), rep
    assert max(rep.final_object_err) < 0.15, rep.final_object_err
    assert len(rep.order) == 1
    assert summary["scans"] > 8, summary["scans"]
    return summary, launches


GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "golden", "e2e_oracle", "goldens")
# oracle StateMachine (plan_manager.hpp:26) -> PlanState name
STATE_NAMES = {1: "IDLE", 2: "PLANNING", 3: "REPLAN", 4: "GOING_TO_GOAL",
               5: "EMERGENCY_STOP"}


def _matched_ticks(golden_t, ticks, atol=1e-9):
    """How many golden plan ticks have a plan tick within atol."""
    return sum(1 for g in golden_t
               if any(abs(t - g) <= atol for t in ticks))


def planner_sim_on_card(wfc, golden_name, sim_T, tracker, pose_band):
    """run_planner_sim on the card at the goldens' full width (140x60
    corridor, 360 beams to 5 m, LTV horizon 30 with 3 x 150 ADMM passes
    or NMPC N=50, float32), cut to `sim_T`, with the configuration
    tests/test_e2e_parity.py builds (defaults, standard_diff back end,
    piece buckets (4, 8, 16, 24)).  Held to the compiled reference's
    golden over the prefix: the 1 kHz gate attempts at the golden's plan
    ticks (1e-9), at most 3 of them failing to plan, each trajectory
    starting at its tick (the first) or max_replan_time after it (1e-6:
    a float32 Polynome field), the FSM edges, the truth-pose deviation
    inside `pose_band` (mean, max), and no pose in an occupied cell.
    Wall time by phase, per plan and per tracker tick.  Returns (summary,
    K1/K2 launches)."""
    import gzip
    from alore_legged_manipulator_tpu_torch.mission import plan_manager as pmm
    from alore_legged_manipulator_tpu_torch.planner.backend import (
        BackendConfig)
    from alore_legged_manipulator_tpu_torch.planner.frontend import (
        FrontendConfig)
    from alore_legged_manipulator_tpu_torch.runtime import planner_sim as ps
    with gzip.open(os.path.join(GOLDENS, f"{golden_name}.json.gz"),
                   "rt") as f:
        golden = json.load(f)
    scn = ps.E2EScenario.from_golden(golden["scenario"])
    scn.sim_T = sim_T
    cfg = pmm.PlanManagerConfig(
        replan_period=scn.replan_time, max_replan_time=scn.max_replan_time,
        backend=BackendConfig(standard_diff=True),
        frontend=FrontendConfig(piece_buckets=(4, 8, 16, 24)))
    clock = PhaseClock()
    for owner, name, bucket in (
            (pmm, "plan_frontend", "front_end"),
            (pmm, "plan_backend", "back_end"),
            (pmm, "esdf_from_occupancy", "esdf_updates"),
            (pmm, "build_tracked_traj", "tracked_traj"),
            (ps, "build_tracked_traj", "tracked_traj"),
            (ps, "ltv_mpc_tick", "tracker_tick"),
            (ps, "nmpc_rti_step", "tracker_tick"),
            (ps, "nmpc_cold_start_step", "tracker_tick"),
            (ps, "ltv_ref_points", "tracker_refs"),
            (ps, "ref_points", "tracker_refs"),
            (ps, "occupancy_update", "fusion"),
            (ps, "occupancy_update_perspective", "fusion"),
            (ps, "ekf_predict", "ekf"), (ps, "ekf_update", "ekf")):
        clock.wrap(owner, name, bucket)
    wfc.reset_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trace = ps.run_planner_sim(scn, cfg, ps.LtvMpcConfig(),
                                   tracker=tracker)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        clock.restore()
    launches = dict(wfc.LAUNCHES)

    g_t = [p["t"] for p in golden["plans"] if p["t"] <= sim_T]
    t_t = [p["t"] for p in trace.plans]
    offs = [p["traj_start"] - p["t"] for p in trace.plans]
    g_edges = [(t, STATE_NAMES[s]) for t, s in golden["states"]
               if s in STATE_NAMES and t <= sim_T]
    t_edges = [(t, s.name) for t, s in trace.states]
    gp = np.array(golden["poses"])[:len(trace.poses)]
    dev = np.hypot(trace.poses[:, 1] - gp[:, 1], trace.poses[:, 2] - gp[:, 2])
    P = trace.poses
    ix = ((P[:, 1] - scn.lower[0]) / scn.res).astype(int).clip(
        0, scn.grid.shape[0] - 1)
    iy = ((P[:, 2] - scn.lower[1]) / scn.res).astype(int).clip(
        0, scn.grid.shape[1] - 1)
    phases = clock.report(wall)
    summary = {
        "golden": golden_name, "tracker": tracker,
        "laser_mode": scn.laser_mode, "sim_T": sim_T, "wall_s": wall,
        "attempts": len(trace.attempts), "plans": len(trace.plans),
        "golden_plans": len(g_t),
        "plans_matched": _matched_ticks(g_t, t_t),
        "pose_dev_mean_m": float(dev.mean()),
        "pose_dev_max_m": float(dev.max()),
        "commands": len(trace.cmds),
        "s_per_plan": phases.get("back_end", 0.0)
        / max(clock.calls.get("back_end", 1), 1),
        "s_per_tracker_tick": phases.get("tracker_tick", 0.0)
        / max(clock.calls.get("tracker_tick", 1), 1),
        "calls": clock.calls, "wall_by_phase_s": phases,
        "kernel_launches": launches}
    print(f"planner simulation, {golden_name}, {tracker}, on the card: "
          + json.dumps(summary), flush=True)
    assert len(trace.attempts) == len(g_t) and all(
        abs(a - g) <= 1e-9 for a, g in zip(trace.attempts, g_t)), \
        (trace.attempts, g_t)
    assert summary["plans_matched"] >= len(g_t) - 3, (t_t, g_t)
    assert abs(offs[0]) < 1e-6 and all(
        abs(o - scn.max_replan_time) < 1e-6 for o in offs[1:]), offs
    assert [s for _, s in t_edges] == [s for _, s in g_edges], \
        (t_edges, g_edges)
    assert all(abs(a[0] - b[0]) <= 1e-6 for a, b in zip(t_edges, g_edges))
    assert dev.mean() < pose_band[0] and dev.max() < pose_band[1], dev
    assert not scn.grid[ix, iy].any(), "a pose entered an occupied cell"
    for a in (trace.poses, trace.cmds, trace.ekf):
        assert np.isfinite(a).all()
    return summary, launches


def planner_probe():
    """One B=1 plan or two and a few ticks of each tracker on the card:
    the corridor under the LTV-MPC and the raycast corridor under the
    NMPC, each cut to 0.1 s (two plans, nine tracker ticks)."""
    from alore_legged_manipulator_tpu_torch.ops import wavefront_cuda as wfc
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    set_precision_policy()
    planner_sim_on_card(wfc, "corridor", 0.1, "ltv", (0.15, 0.45))
    planner_sim_on_card(wfc, "nmpc_corridor_raycast", 0.1, "nmpc",
                        (0.2, 1.0))


def served_probe():
    """The served policy's phases alone (the policy card vs CPU, the
    eval, the bus mission, the low-level WBC) and the known-map push
    cut, about two minutes of command time."""
    from alore_legged_manipulator_tpu_torch.ops import wavefront_cuda as wfc
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    set_precision_policy()
    for name, fn in (("policy", policy_card_vs_cpu),
                     ("eval", tracking_eval_on_card),
                     ("bus mission", lambda: bus_mission_on_card(wfc)),
                     ("low level", low_level_card_vs_cpu),
                     ("known-map push", lambda: known_map_push_on_card(wfc))):
        _phase(name)
        fn()

def variants_on_card():
    """The variants behind the production profile at B=64, N=50, on the
    card: catches tensors made on the wrong device, which CPU tests
    cannot see."""
    from alore_legged_manipulator_tpu_torch.control import nmpc
    from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams
    from alore_legged_manipulator_tpu_torch.solvers import bfgs, minco
    from alore_legged_manipulator_tpu_torch.solvers.lbfgs import LbfgsParams
    dev = torch.device("cuda")
    B, n = 64, 50
    rng = np.random.default_rng(0)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # the NMPC tick on the flagship entry's inputs
    x_traj = f32(rng.standard_normal((B, n + 1, 3)) * 0.1)
    u_traj = f32(rng.standard_normal((B, n, 2)) * 0.1)
    x_est = f32(rng.standard_normal((B, 3)) * 0.1)
    ts = 0.01 * np.arange(1, n + 2)
    ref_x = f32(np.broadcast_to(np.stack([ts, 0 * ts, 0 * ts]), (B, 3, n + 1)))
    ref_u = f32(np.ones((B, 2, n + 1)))
    icr = ICRParams(-0.3, 0.3, 0.2)
    outs = {}
    for name, kw in (("fast", {}),
                     ("dense-triangular", dict(qp_mode="dense")),
                     ("dense-assoc", dict(qp_mode="dense",
                                          condense_mode="assoc")),
                     ("dense-seq", dict(qp_mode="dense",
                                        condense_mode="seq")),
                     ("dense-seq-rk4", dict(qp_mode="dense",
                                            condense_mode="seq",
                                            integrator="rk4"))):
        _, u_cmd, x_pred, _ = nmpc.nmpc_rti_step(
            nmpc.NmpcCarry(x_traj, u_traj), x_est, ref_x, ref_u, icr,
            nmpc.NmpcConfig(**kw))
        assert u_cmd.device.type == "cuda" and x_pred.device.type == "cuda"
        assert bool(torch.isfinite(u_cmd).all())
        outs[name] = u_cmd
    errs = {k: float((v - outs["fast"]).abs().max()) for k, v in outs.items()}
    # the rk4 linearization is another model of the step (1e-3), the
    # condensers and the dense QP are the same arithmetic (1e-4, f32)
    for k, e in errs.items():
        assert e < (1e-3 if "rk4" in k else 1e-4), f"nmpc {k}: {e}"
    _, u_cold, _, _ = nmpc.nmpc_cold_start_step(x_est, ref_x, ref_u,
                                                nmpc.NmpcConfig())
    assert u_cold.device.type == "cuda" and bool(torch.isfinite(u_cold).all())
    print("nmpc modes vs the matrix-free path, max |u_cmd diff|: "
          + json.dumps(errs), flush=True)

    # a 32-piece spline: cyclic reduction against the dense 6N system (f64)
    m = 32
    head = torch.as_tensor(rng.standard_normal((B, 2, 3)), device=dev)
    tail = torch.as_tensor(rng.standard_normal((B, 2, 3)), device=dev)
    inner = torch.as_tensor(rng.standard_normal((B, 2, m - 1)), device=dev)
    times = torch.as_tensor(rng.uniform(0.3, 1.5, (B, m)), device=dev)
    c_cr = minco.minco_coeffs(head, tail, inner, times)
    c_de = minco.minco_coeffs_dense(head, tail, inner, times)
    rel = float((c_cr - c_de).abs().max() / c_de.abs().max())
    assert c_cr.device.type == "cuda" and rel < 1e-7, f"minco CR: {rel}"
    print(f"minco 32 pieces, cyclic reduction vs dense 6N: rel {rel:.2e}",
          flush=True)

    # ring / compact / dense on a batched quadratic, in f64: an Armijo
    # test on f32 costs of O(1) cannot place x closer than ~3e-4
    nq = 17
    A = rng.standard_normal((B, nq, nq))
    Q = torch.as_tensor(np.einsum("bij,bkj->bik", A, A) / nq + np.eye(nq),
                        device=dev)
    b = torch.as_tensor(rng.standard_normal((B, nq)), device=dev)
    sol = torch.linalg.solve(Q, b[..., None])[..., 0]

    def fun(x):
        Qx = (Q * x[:, None, :]).sum(-1)
        return 0.5 * (x * Qx).sum(-1) - (b * x).sum(-1), Qx - b

    p = LbfgsParams(g_epsilon=1e-8, delta=0.0, past=0, hard_iter_cap=300)
    derr = {}
    for d in ("ring", "compact", "dense"):
        x, _, st, k = bfgs.bfgs_minimize(fun, torch.zeros_like(b), p, d)
        assert x.device.type == "cuda"
        derr[d] = [float((x - sol).abs().max()), int(k.max())]
        assert derr[d][0] < 1e-4, f"direction {d}: {derr[d]}"
    print("solver directions on a quadratic, [max |x - x*|, iterations]: "
          + json.dumps(derr), flush=True)

    # the publisher-tick estimator extras, created with no device named
    # (that means the card) and stepped on card tensors
    from alore_legged_manipulator_tpu_torch.estimator import icr_ekf
    yr, yl, xv = (float(v) for v in icr)
    vl = f32(rng.uniform(0.2, 0.6, B))
    vr = f32(rng.uniform(1.0, 1.5, B))
    w = (vr - vl) / (yl - yr)
    vx = (vr * yl - vl * yr) / (yl - yr)
    flt = icr_ekf.FirstOrderFilter.create(0.5, 100.0)
    est_state = icr_ekf.SimpleIcrState.create(2.0, 100.0)
    mon = icr_ekf.ConvergenceMonitor.create((B,))
    for _ in range(800):
        flt, y = flt.step(vx)
        est_state, est = est_state.step(vx, -xv * w, w, vx - yl * w,
                                        vx - yr * w)
        mon = mon.step(est[:, [1, 0, 2]], (yr, yl, xv))
    truth = torch.tensor([yl, yr, xv], device=dev)
    aux = {"filter": float((y - vx).abs().max()),
           "simple_icr": float((est - truth).abs().max()),
           "latched_lanes": int(mon.converged.all(-1).sum()),
           "tick": int(mon.tick)}
    for t in (y, est, mon.count, mon.converged, mon.latch_tick, mon.tick):
        assert t.device.type == "cuda"
    # a steady turn without noise: the low-pass settles on its input and
    # the algebraic estimate on the true ICR (1e-3, f32), every lane
    # latches
    assert aux["filter"] < 1e-3 and aux["simple_icr"] < 1e-3, aux
    assert aux["latched_lanes"] == B and aux["tick"] == 800, aux
    st = icr_ekf.ekf_init(torch.zeros(B, 3, device=dev), (yr, yl, xv))
    pose_var, icr_var = icr_ekf.covariance_report(st)
    assert pose_var.device.type == "cuda" and pose_var.shape == (B, 3)
    assert icr_var.shape == (B, 3)
    print("estimator extras after 800 ticks of a steady turn: "
          + json.dumps(aux), flush=True)


def _to(tree, device):
    """A NamedTuple of tensors (nested) on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    return tree


def _contact_views(n, steps, seed):
    """Observation histories and graph inputs the served policy sees: `n`
    contact-plant scenes after `steps` random actions, on the CPU."""
    from alore_legged_manipulator_tpu_torch.rl import env_physics as ep
    cfg = ep.PhysicsEnvConfig()
    st = ep.env_reset(torch.Generator().manual_seed(seed), cfg, n_envs=n,
                      device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        a = torch.as_tensor(rng.uniform(-1, 1, (n, 9)), dtype=torch.float32)
        st = ep.env_step(st, a, cfg)[0]
    return ep.as_surrogate_view(st)


def policy_card_vs_cpu():
    """The trained policy (models/weights/highlevel_physics_6000.npz) at
    full width on the card against the CPU: mean actions and velocity
    estimates on 256 observation histories and graphs (the graphs built
    on each device), f32, within 1e-4; then the B=1 forward of the
    deployment node (`make_actor_policy`: graph build + actor), each call
    ended by a synchronize, p50 and p99 against the 50 Hz tick's budget,
    and its dispatched operations."""
    from alore_legged_manipulator_tpu_torch.models.gnn import (
        build_interaction_graph)
    from alore_legged_manipulator_tpu_torch.models.torch_convert import (
        load_highlevel_actor)
    from alore_legged_manipulator_tpu_torch.rl.env import graph_features
    from alore_legged_manipulator_tpu_torch.rl.eval import actor_mean
    from alore_legged_manipulator_tpu_torch.runtime.highlevel_controller \
        import make_actor_policy
    t0 = time.perf_counter()
    gpu = load_highlevel_actor()
    cpu = load_highlevel_actor(device="cpu")
    load_s = time.perf_counter() - t0
    view = _contact_views(256, 12, seed=5)
    with torch.no_grad():
        g_c = build_interaction_graph(*graph_features(view))
        m_c, _, v_c = cpu(view.obs_hist, g_c)
        vg = _to(view, "cuda")
        g_g = build_interaction_graph(*graph_features(vg))
        m_g, _, v_g = gpu(vg.obs_hist, g_g)
    err = {"mean_action": float((m_g.cpu() - m_c).abs().max()),
           "vel_estimate": float((v_g.cpu() - v_c).abs().max()),
           "graph": max(float((g_g.nodes.cpu() - g_c.nodes).abs().max()),
                        float((g_g.edge_attr.cpu() - g_c.edge_attr
                               ).abs().max())),
           "mean_action_abs_max": float(m_c.abs().max())}
    fn = make_actor_policy(gpu)
    one = _to(type(view)(*(v[:1] for v in view)), "cuda")
    for _ in range(20):
        fn(one.obs_hist[0], one)
    torch.cuda.synchronize()
    lat = []
    for _ in range(200):
        t1 = time.perf_counter()
        fn(one.obs_hist[0], one)
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t1))
    lat = np.asarray(lat)
    ops = dispatched_ops(lambda: fn(one.obs_hist[0], one))
    ops_batch = dispatched_ops(lambda: actor_mean(gpu, vg))
    summary = {"max_abs_err": err, "b1_forward_ms_p50": float(
        np.percentile(lat, 50)), "b1_forward_ms_p99": float(
        np.percentile(lat, 99)), "budget_ms": POLICY_BUDGET_MS,
        "dispatched_ops": ops, "dispatched_ops_b256": ops_batch,
        "load_s": load_s}
    print("trained policy, card vs CPU (256 contact-plant histories), B=1 "
          "latency: " + json.dumps(summary), flush=True)
    assert err["mean_action"] <= 1e-4 and err["vel_estimate"] <= 1e-4, err
    assert bool(torch.isfinite(m_g).all())
    return summary


def tracking_eval_on_card():
    """examples/train_and_deploy_highlevel.py's fixed-command eval on the
    contact plant, on the card: 256 lanes, 128 at (0.5, 0, 0) and 128 at
    (0.3, 0, 0.8), 100 steps, mean |velocity error| per axis over the
    last 50, held to the JAX package's value + 0.05 per axis."""
    from alore_legged_manipulator_tpu_torch.models.torch_convert import (
        load_highlevel_actor)
    from alore_legged_manipulator_tpu_torch.rl import env_physics as ep
    from alore_legged_manipulator_tpu_torch.rl.eval import (
        steady_state_tracking)
    actor = load_highlevel_actor()
    pcfg = ep.PhysicsEnvConfig()
    st = ep.env_reset(torch.Generator().manual_seed(0), pcfg, n_envs=256)
    step_ops = dispatched_ops(lambda: ep.env_step(
        st, torch.zeros(256, 9, device="cuda"), pcfg))
    cmds = np.concatenate([np.tile([[0.5, 0.0, 0.0]], (128, 1)),
                           np.tile([[0.3, 0.0, 0.8]], (128, 1))])
    times = []
    t0 = time.perf_counter()
    err = steady_state_tracking(actor, cmds, cfg=pcfg, seed=123,
                                step_times=times)
    wall = time.perf_counter() - t0
    summary = {"lanes": 256, "steps": 100, "err_per_axis": err.tolist(),
               "jax_err_per_axis": list(JAX_EVAL_ERR),
               "step_ms_median": 1e3 * float(np.median(times)),
               "step_ms_mean": 1e3 * float(np.mean(times)),
               "env_step_dispatched_ops": step_ops, "wall_s": wall}
    print("tracking eval on the contact plant, on the card: "
          + json.dumps(summary), flush=True)
    for a, ref in zip(err, JAX_EVAL_ERR):
        assert np.isfinite(a) and a <= ref + 0.05, (err, JAX_EVAL_ERR)
    return summary


def bus_mission_on_card(wfc):
    """The perception -> FSM -> trained-policy mission of
    examples/train_and_deploy_highlevel.py over one MessageBus, the
    contact-plant env on the card: item (2, 0.5), target (4, 2), dt 0.02,
    at most 20000 ticks; must reach DONE within 0.5 m.  Host wall time by
    phase (perception, FSM, policy, env step, host rest)."""
    from alore_legged_manipulator_tpu_torch.mission.object_fsm import (
        FsmState)
    from alore_legged_manipulator_tpu_torch.models.torch_convert import (
        load_highlevel_actor)
    from alore_legged_manipulator_tpu_torch.runtime.bus_mission import (
        MissionFsmNode, PerceptionNode, WorldState)
    from alore_legged_manipulator_tpu_torch.runtime.deploy import MessageBus
    from alore_legged_manipulator_tpu_torch.runtime.highlevel_controller \
        import HighLevelControllerNode, make_actor_policy
    items, targets = [(2.0, 0.5, 0.0)], [(4.0, 2.0, 0.0)]
    bus = MessageBus()
    world = WorldState(robot=np.zeros(3),
                       objects=[np.asarray(items[0], float).copy()]
                       + [np.zeros(3)] * 3)
    percept = PerceptionNode(bus, seed=7)
    fsm_node = MissionFsmNode(bus, items, targets, order=[0], dt=0.02)
    ctrl = HighLevelControllerNode(bus, world,
                                   make_actor_policy(load_highlevel_actor()),
                                   physics=True)
    clock = PhaseClock()
    clock.wrap(percept, "tick", "perception")
    clock.wrap(fsm_node, "tick", "fsm")
    clock.wrap(ctrl, "policy_fn", "policy")
    clock.wrap(ctrl, "_step", "env_step")
    wfc.reset_launches()
    ticks = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while fsm_node.fsm.state != FsmState.DONE and ticks < 20000:
            percept.tick(world)
            fsm_node.tick()
            ctrl.tick(dt=0.02)
            ticks += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        clock.restore()
    launches = dict(wfc.LAUNCHES)
    err = float(np.linalg.norm(world.objects[0][:2]
                               - np.asarray(targets[0])[:2]))
    summary = {"state": fsm_node.fsm.state.name, "ticks": ticks,
               "final_object_err_m": err, "wall_s": wall,
               "policy_ticks": clock.calls.get("policy", 0),
               "wall_by_phase_s": clock.report(wall),
               "kernel_launches": launches}
    print("bus mission with the trained policy, contact plant, on the "
          "card: " + json.dumps(summary), flush=True)
    assert fsm_node.fsm.state == FsmState.DONE and err < 0.5, summary
    return summary, launches


def low_level_card_vs_cpu():
    """The frozen low-level WBC with seeded random weights (no trained
    low-level checkpoint is in the repository), card against CPU: 50
    `DeployController` ticks through `run_obs_assembly_tick` at f32
    (joint targets within 1e-4), then 10 contact-plant
    `hierarchical_env_step`s at f64 on 4 lanes (poses, velocities and
    joints within 1e-9)."""
    import copy

    from alore_legged_manipulator_tpu_torch.rl import env_physics as ep
    from alore_legged_manipulator_tpu_torch.rl.hierarchy import (
        low_level_policy_cfg, robot_reset)
    from alore_legged_manipulator_tpu_torch.runtime import deploy as dp
    from alore_legged_manipulator_tpu_torch.runtime.obs_assembly import (
        LowObsState, split_obs799)
    torch.manual_seed(0)
    base = low_level_policy_cfg().eval()
    pols = {d: copy.deepcopy(base).to(d) for d in ("cuda", "cpu")}
    rng = np.random.default_rng(3)
    ctls = {d: dp.DeployController(
        bus=dp.MessageBus(), low_level_fn=dp.make_low_level_fn(pols[d]),
        cfg=dp.DeployConfig(move_to_default_s=0.04)) for d in pols}
    states = {d: LowObsState.create(device=d) for d in pols}
    for c in ctls.values():
        c.request_policy()
    t0 = time.perf_counter()
    q_err = 0.0
    for _ in range(50):
        ls = {"roll": rng.normal() * 0.05, "pitch": rng.normal() * 0.05,
              "ang_vel": rng.normal(size=3), "q": rng.normal(size=18) * 0.3,
              "dq": rng.normal(size=18)}
        cmd_v = rng.uniform(-1, 1, 3)
        out = {}
        for d, c in ctls.items():
            states[d], _, obs = dp.run_obs_assembly_tick(states[d], ls,
                                                         cmd_v, c.cfg)
            p, _, hist = split_obs799(obs)
            c.bus.publish("low_state", {"q": ls["q"], "dq": ls["dq"],
                                        "prop": p.cpu().numpy(),
                                        "prop_hist": hist.cpu().numpy()})
            out[d] = c.tick()
        assert ctls["cuda"].state == ctls["cpu"].state
        q_err = max(q_err, float(np.abs(out["cuda"].q_target
                                        - out["cpu"].q_target).max()))
    deploy_s = time.perf_counter() - t0
    assert ctls["cuda"].state == dp.DeployState.POLICY

    cfg = ep.PhysicsEnvConfig()
    st0 = ep.env_reset(torch.Generator().manual_seed(4), cfg, torch.float64,
                       n_envs=4, device="cpu")
    sides = {d: [_to(st0, d), robot_reset(torch.float64, 4, device=d),
                 pols[d].double()] for d in pols}
    acts = rng.uniform(-1, 1, (10, 4, 9)).astype(np.float32)
    t0 = time.perf_counter()
    for a in acts:
        for d, sd in sides.items():
            sd[0], sd[1], _, _, _ = ep.hierarchical_env_step(
                sd[0], sd[1], torch.as_tensor(a, device=d), sd[2], cfg)
    hier_s = time.perf_counter() - t0
    (sg, rg, _), (sc, rc, _) = sides["cuda"], sides["cpu"]
    h_err = max(float((sg.bodies.pose.cpu() - sc.bodies.pose).abs().max()),
                float((sg.bodies.vel.cpu() - sc.bodies.vel).abs().max()),
                float((rg.q.cpu() - rc.q).abs().max()),
                float((rg.obs_state.hist.cpu() - rc.obs_state.hist
                       ).abs().max()))
    summary = {"deploy_ticks": 50, "q_target_max_abs_err": q_err,
               "deploy_wall_s": deploy_s, "hierarchy_steps": 10,
               "hierarchy_max_abs_err_f64": h_err,
               "hierarchy_wall_s": hier_s}
    print("low-level WBC, card vs CPU: " + json.dumps(summary), flush=True)
    assert q_err <= 1e-4, q_err
    assert h_err <= 1e-9, h_err
    return summary


# ---------------------------------------------------------------------------
# 9. training the high-level policy, and the camera perception path
# ---------------------------------------------------------------------------

def _csv_rows(n):
    """The first `n` rows of the JAX package's contact-plant training
    run (examples/artifacts/train_physics_6000.csv), as floats."""
    import csv
    with open(TRAIN_CSV, newline="") as f:
        rows = list(csv.DictReader(f))[:n]
    return [{k: float(v) for k, v in r.items()} for r in rows]


def _train_cfg(**over):
    from alore_legged_manipulator_tpu_torch.rl import registry
    kw = dict(num_envs=1536, steps_per_env=24, iterations=TRAIN_ITERS,
              physics_env=True)
    kw.update(over)
    return registry.make("Alore-Push-Flat-v0", **kw)


def _init_models(device=None, dtype=torch.float32):
    """The JAX package's seed-0 initial parameters, the start of the
    CSV's run (models/weights/train_init_physics_seed0.npz)."""
    from alore_legged_manipulator_tpu_torch.models.torch_convert import (
        TRAIN_INIT_PHYSICS_SEED0, load_flax_npz)
    from alore_legged_manipulator_tpu_torch.rl.runner import load_models
    return load_models(load_flax_npz(TRAIN_INIT_PHYSICS_SEED0), device=device,
                       dtype=dtype)


def train_dispatches(cfg):
    """Operations one contact-plant env step dispatches at the config's
    width, and one PPO update of one minibatch (GAE, normalisation, the
    forward, the backward, the clip and one Adam step), on the card."""
    import copy

    from alore_legged_manipulator_tpu_torch.rl import ppo as pp
    from alore_legged_manipulator_tpu_torch.rl import runner as rn
    env = rn.make_env(cfg)
    gen = torch.Generator().manual_seed(11)
    st = env.reset(gen, cfg.num_envs)
    step = dispatched_ops(lambda: env.step(
        st, torch.zeros(cfg.num_envs, 9, device="cuda")))
    models = _init_models()
    params = {"actor": copy.deepcopy(models.actor),
              "critic": copy.deepcopy(models.critic)}
    small = cfg._replace(num_envs=6, steps_per_env=2)
    draws = rn.Draws(env, gen, torch.Generator("cuda").manual_seed(12))
    _, ro, last = rn.collect(params, env, env.reset(gen, 6), small, draws)
    one = pp.PpoConfig(epochs=1, minibatches=1)
    update = dispatched_ops(lambda: pp.ppo_update(
        pp.ppo_init(params, one), ro, last, rn._apply_all, one), grad=True)
    return {"env_step": step, "update_one_minibatch": update}


def training_on_card(seed=0, check=True):
    """PPO training at full width on the card from the CSV's start: the
    JAX package's seed-0 initial parameters, `registry.make(
    "Alore-Push-Flat-v0", num_envs=1536, steps_per_env=24, iterations=
    TRAIN_ITERS, physics_env=True)`, f32, the generators seeded `seed`.
    Prints each iteration's row beside the CSV's, the wall time per
    iteration split into collection and update, env steps/s (the number
    examples/train_and_deploy_highlevel.py prints).  Held (with `check`):
    every metric and parameter finite; iteration 0's KL above 0.02 and
    its lr 1e-3 / 1.5**5 to 1e-9 relative; the mean reward of iterations
    0 and 9 inside REWARD_BANDS around the CSV's, iteration 9's above
    iteration 0's; the estimator loss within 3x of the CSV's row.
    Returns (ppo_state, history, summary)."""
    from alore_legged_manipulator_tpu_torch.rl.runner import train
    cfg = _train_cfg(seed=seed)
    csv_rows = _csv_rows(TRAIN_ITERS)
    keys = ("mean_reward", "estimator_loss", "kl", "lr", "policy_loss",
            "value_loss")
    timings = []

    def progress(it, m):
        c, u = timings[-1]
        print(f"iter {it}: port " + json.dumps({k: m[k] for k in keys})
              + " | csv " + json.dumps({k: csv_rows[it][k] for k in keys})
              + f" | collect {c:.3f} s, update {u:.3f} s", flush=True)

    models = _init_models()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = train(cfg, progress=progress, models=models,
                        timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = cfg.iterations * cfg.num_envs * cfg.steps_per_env
    summary = {
        "seed": seed, "num_envs": cfg.num_envs,
        "steps_per_env": cfg.steps_per_env, "iterations": cfg.iterations,
        "wall_s": wall, "env_steps_per_s": steps / wall,
        "collect_s": [t[0] for t in timings],
        "update_s": [t[1] for t in timings],
        "reward_it0": hist[0]["mean_reward"],
        "reward_last": hist[-1]["mean_reward"]}
    print("training on the card: " + json.dumps(summary), flush=True)
    if check:
        lr0 = 1e-3 / 1.5 ** 5
        assert all(np.isfinite(v) for h in hist for v in h.values()), hist
        assert all(bool(torch.isfinite(p).all())
                   for m in state.params.values() for p in m.parameters())
        assert hist[0]["kl"] > 0.02, hist[0]
        assert abs(hist[0]["lr"] - lr0) <= 1e-9 * lr0, hist[0]["lr"]
        for it, (lo, hi) in REWARD_BANDS.items():
            r = hist[it]["mean_reward"]
            assert lo <= csv_rows[it]["mean_reward"] <= hi
            assert lo <= r <= hi, (it, r, (lo, hi))
        assert hist[-1]["mean_reward"] > hist[0]["mean_reward"]
        for h, c in zip(hist, csv_rows):
            e, ce = h["estimator_loss"], c["estimator_loss"]
            assert ce / 3 <= e <= 3 * ce, (e, ce)
    return state, hist, summary


def training_bands():
    """The training phase under generator seeds 1, 2 and 3 (same initial
    parameters, no holds): the mean reward of iterations 0 and 9 in each,
    and the bands they give around the CSV's values: half-width 1.5x the
    range of the three runs' values and the CSV's.  Alone:
    `python3 -c "import chip_smoke; chip_smoke.training_bands()"`."""
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    set_precision_policy()
    csv_rows = _csv_rows(TRAIN_ITERS)
    seen = {it: [] for it in REWARD_BANDS}
    for seed in (1, 2, 3):
        _, hist, _ = training_on_card(seed=seed, check=False)
        for it in seen:
            seen[it].append(hist[it]["mean_reward"])
    out = {}
    for it, vals in seen.items():
        ref = csv_rows[it]["mean_reward"]
        half = 1.5 * (max(vals + [ref]) - min(vals + [ref]))
        out[it] = {"runs": vals, "csv": ref, "band": (ref - half, ref + half),
                   "csv_inside_runs_range": min(vals) <= ref <= max(vals)}
    print("training bands: " + json.dumps(out), flush=True)
    return out


def train_camera_probe():
    """The training and camera phases alone, with the reward bands set
    first: `training_bands()`, then the seed-0 run held to them, the
    checkpoint round trip, the f64 update card vs CPU, the dispatch
    counts, the camera checks and the camera bus mission (about 5 min):
    `python3 -c "import chip_smoke; chip_smoke.train_camera_probe()"`."""
    from alore_legged_manipulator_tpu_torch.ops import wavefront_cuda as wfc
    bands = training_bands()
    REWARD_BANDS.update({it: tuple(b["band"]) for it, b in bands.items()})
    state, _, _ = training_on_card()
    print("training, dispatched operations: "
          + json.dumps(train_dispatches(_train_cfg())), flush=True)
    checkpoint_round_trip_on_card(state)
    ppo_update_card_vs_cpu()
    camera_card_vs_cpu()
    camera_bus_mission_on_card(wfc)
    print(f"probe wall time: {time.perf_counter() - T_START:.1f} s",
          flush=True)


def checkpoint_round_trip_on_card(state):
    """The trained state through `save_checkpoint` / `load_checkpoint`
    (build/chip_smoke_ckpt/step_<n>.npz) into a fresh PhysicActorCritic
    on the card: mean actions on 256 contact-plant histories bit for
    bit."""
    from alore_legged_manipulator_tpu_torch.models.actor_critic import (
        PhysicActorCritic)
    from alore_legged_manipulator_tpu_torch.models.gnn import (
        build_interaction_graph)
    from alore_legged_manipulator_tpu_torch.models.torch_convert import (
        state_dict_from_flax)
    from alore_legged_manipulator_tpu_torch.rl.env import graph_features
    from alore_legged_manipulator_tpu_torch.rl.runner import (
        load_checkpoint, save_checkpoint)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ckpt")
    out = save_checkpoint(path, state, TRAIN_ITERS)
    tree = load_checkpoint(path, TRAIN_ITERS)
    fresh = PhysicActorCritic()
    fresh.load_state_dict(state_dict_from_flax(tree["actor"]))
    fresh = fresh.to("cuda")
    view = _to(_contact_views(256, 12, seed=9), "cuda")
    with torch.no_grad():
        g = build_interaction_graph(*graph_features(view))
        m_trained = state.params["actor"](view.obs_hist, g)[0]
        m_loaded = fresh(view.obs_hist, g)[0]
    same = bool(torch.equal(m_trained, m_loaded))
    print(f"checkpoint round trip ({os.path.basename(out)}, "
          f"{os.path.getsize(out)} bytes): mean actions on 256 histories "
          f"bit for bit: {same}", flush=True)
    assert same


def ppo_update_card_vs_cpu():
    """One PPO update at f64 on the card and on the CPU: a contact-plant
    rollout of 6 lanes x 4 steps made on the CPU (from the seed-0 initial
    parameters) and copied to the card, the same permutations; parameters
    within 1e-9, metrics within 1e-9 relative."""
    from alore_legged_manipulator_tpu_torch.rl import ppo as pp
    from alore_legged_manipulator_tpu_torch.rl import runner as rn
    cfg = _train_cfg(num_envs=6, steps_per_env=4)
    sides = {d: _init_models(device=d, dtype=torch.float64)
             for d in ("cpu", "cuda")}
    params = {d: {"actor": m.actor, "critic": m.critic}
              for d, m in sides.items()}
    env = rn.make_env(cfg, torch.float64, "cpu")
    gen = torch.Generator().manual_seed(3)
    draws = rn.Draws(env, gen, torch.Generator().manual_seed(4))
    _, ro, last = rn.collect(params["cpu"], env, env.reset(gen, 6), cfg,
                             draws)
    perms = pp.draw_permutations(24, cfg.ppo.epochs,
                                 torch.Generator().manual_seed(5))
    metrics = {}
    for d in ("cpu", "cuda"):
        _, metrics[d] = pp.ppo_update(
            pp.ppo_init(params[d], cfg.ppo), _to(ro, d), last.to(d),
            rn._apply_all, cfg.ppo, perms=perms)
    p_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                for k in ("actor", "critic")
                for a, b in zip(params["cuda"][k].parameters(),
                                params["cpu"][k].parameters()))
    m_err = max(abs(float(metrics["cuda"][k]) - float(metrics["cpu"][k]))
                / max(abs(float(metrics["cpu"][k])), 1e-300)
                for k in metrics["cpu"])
    with torch.no_grad():
        moved = max(float((a - b).abs().max()) for a, b in zip(
            params["cpu"]["actor"].parameters(), _init_models(
                device="cpu", dtype=torch.float64).actor.parameters()))
    summary = {"params_max_abs_err": p_err, "metrics_max_rel_err": m_err,
               "params_moved_max": moved,
               "metrics_cpu": {k: float(v) for k, v in
                               metrics["cpu"].items()}}
    print("one PPO update, f64, card vs CPU: " + json.dumps(summary),
          flush=True)
    assert p_err <= 1e-9 and m_err <= 1e-9 and moved > 1e-6, summary


CAM_SCENE = ((96, 72, 90.0), [(4.0, 0.5, 0.3, 0.3, 0.3, 1.0, 1),
                              (3.0, -1.0, 0.0, 0.3, 0.3, 1.0, 2),
                              (6.0, 1.5, -0.2, 0.3, 0.3, 1.0, 3)],
             (0.1, 0.2, 0.5, 0.05))


def _cam_frame(dtype, device):
    from alore_legged_manipulator_tpu_torch.world import camera as cmr
    (w, h, f), boxes, (x, y, z, yaw) = CAM_SCENE
    a = torch.as_tensor(np.asarray(boxes), dtype=dtype, device=device)
    scene = cmr.BoxScene(center=a[:, 0:2], yaw=a[:, 2], half_ext=a[:, 3:5],
                         height=a[:, 5], sem_id=a[:, 6].to(torch.int32))
    cam = cmr.CameraModel(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h)
    R, t = cmr.pose_matrix((x, y, z), (cmr.ROBOT_CAM_RPY[0],
                                       cmr.ROBOT_CAM_RPY[1],
                                       cmr.ROBOT_CAM_RPY[2] + yaw),
                           dtype=dtype, device=device)

    def frame():
        depth, sem = cmr.render(cam, R, t, scene)
        rgb = cmr.render_color(cam, R, t, scene)
        return depth, sem, rgb, cmr.color_class_masks(rgb, 3)
    return cam, R, t, frame


def camera_card_vs_cpu():
    """The camera perception node's frame (96x72, three boxes) rendered
    on the card and on the CPU: at f64 semantics and color masks equal,
    depth and RGB within 1e-12; at f32 depth within 1e-5 and at most
    EDGE_PIXELS_F32 pixels of differing label or mask (the count
    tests/test_torch_camera.py allows against JAX).  Then the depth frame
    -> `cloud_for_mapping` -> `insert_point_cloud` -> `cast_rays` at f64
    on both devices, equal, on a map whose voxel boundaries miss the
    ground plane (on one whose boundary holds it, the ground hits' z, 0
    up to rounding, may floor to either side: the differing voxels are
    printed).  Also the time and dispatched operations of one f32 frame
    (render, color, masks) on the card."""
    from alore_legged_manipulator_tpu_torch.world import camera as cmr
    from alore_legged_manipulator_tpu_torch.world import voxel_map as vm
    out = {}
    for dt in (torch.float64, torch.float32):
        fr = {d: _cam_frame(dt, d)[3]() for d in ("cpu", "cuda")}
        (dg, sg, cg, mg), (dc, sc, cc, mc) = \
            [[x.cpu() for x in fr[d]] for d in ("cuda", "cpu")]
        fin = torch.isfinite(dc)
        assert torch.equal(torch.isfinite(dg), fin)
        name = str(dt).replace("torch.", "")
        out[name] = {
            "depth_max_abs_err": float((dg[fin] - dc[fin]).abs().max()),
            "rgb_max_abs_err": float((cg - cc).abs().max()),
            "sem_pixels_differing": int((sg != sc).sum()),
            "mask_pixels_differing": int((mg != mc).any(0).sum()),
            "mask_pixels": int(mc.sum())}
    o64, o32 = out["float64"], out["float32"]
    assert o64["sem_pixels_differing"] == 0 and \
        o64["mask_pixels_differing"] == 0, o64
    assert o64["depth_max_abs_err"] <= 1e-12 and \
        o64["rgb_max_abs_err"] <= 1e-12, o64
    assert o32["depth_max_abs_err"] <= 1e-5, o32
    assert o32["sem_pixels_differing"] <= EDGE_PIXELS_F32 and \
        o32["mask_pixels_differing"] <= EDGE_PIXELS_F32, o32
    assert o64["mask_pixels"] > 100

    maps = {}
    for name, lower in (("aligned", (-1.0, -4.0, -1.0)),
                        ("offset", (-1.05, -4.05, -1.1))):
        for d in ("cpu", "cuda"):
            cam, R, t, frame = _cam_frame(torch.float64, d)
            depth = frame()[0]
            pts = cmr.cloud_for_mapping(cam, R, t, depth, far=14.0)
            st = vm.voxel_map_init((40, 40, 20), dtype=torch.float64,
                                   device=d)
            st = vm.insert_point_cloud(st, np.asarray(lower), 0.2, t, pts,
                                       max_range=12.0)
            dirs = torch.tensor([[1.0, 0.0, 0.0], [0.8, 0.6, 0.0],
                                 [0.8, -0.6, 0.0], [0.0, -0.6, -0.8]],
                                dtype=torch.float64)
            rays = vm.cast_rays(st, np.asarray(lower), 0.2, t, dirs, 8.0)
            maps[name, d] = [x.cpu() for x in (st.log_odds, st.known, *rays)]
    # with the ground plane z = 0 on a voxel boundary, a ground hit's z
    # (0 up to rounding) floors to either side on the two devices
    out["aligned_voxels_differing"] = int(
        (maps["aligned", "cuda"][0] != maps["aligned", "cpu"][0]).sum())
    same_map = all(torch.equal(a, b) for a, b in zip(maps["offset", "cuda"],
                                                     maps["offset", "cpu"]))
    out["voxel_map_equal"] = same_map
    out["voxels_known"] = int(maps["offset", "cpu"][1].sum())
    out["rays_hit"] = maps["offset", "cpu"][2].tolist()
    frame = _cam_frame(torch.float32, "cuda")[3]
    for _ in range(5):
        frame()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        frame()
    torch.cuda.synchronize()
    out["frame_ms"] = 1e3 * (time.perf_counter() - t0) / 50
    out["frame_dispatched_ops"] = dispatched_ops(frame)
    print("camera, card vs CPU: " + json.dumps(out), flush=True)
    assert same_map and out["voxels_known"] > 100 and any(out["rays_hit"])
    return out


def camera_bus_mission_on_card(wfc):
    """tests/test_camera_perception.py::test_bus_mission_on_vision_perception
    on the card: `run_bus_mission(perception="camera")`, items (3, 0.5),
    (3, -1) to targets (6, 1.5), (6, -1.5), the camera frames rendered on
    the card; every object delivered, max final error < 0.35 m.  Host
    wall time by phase (render, estimate, FSM, controller, host rest)."""
    from alore_legged_manipulator_tpu_torch.runtime import bus_mission as bm
    from alore_legged_manipulator_tpu_torch.runtime import (
        camera_perception as cp)
    from alore_legged_manipulator_tpu_torch.world import camera as cmr
    clock = PhaseClock()
    for owner, name, bucket in (
            (cmr, "render", "render"), (cmr, "render_color", "render"),
            (cmr, "color_class_masks", "render"),
            (cp.CameraPerceptionNode, "_estimate_from_image", "estimate"),
            (bm.MissionFsmNode, "tick", "fsm"),
            (bm.ControllerNode, "tick", "controller")):
        clock.wrap(owner, name, bucket)
    wfc.reset_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = bm.run_bus_mission(
            items=[(3.0, 0.5, 0.0), (3.0, -1.0, 0.0)],
            targets=[(6.0, 1.5, 0.0), (6.0, -1.5, 0.0)],
            robot_start=(0.0, 0.0, 0.0), perception="camera")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        clock.restore()
    launches = dict(wfc.LAUNCHES)
    summary = {"delivered": rep.delivered, "ticks": rep.ticks,
               "final_err_m": rep.final_err, "wall_s": wall,
               "renders": clock.calls.get("render", 0) // 3,
               "wall_by_phase_s": clock.report(wall),
               "kernel_launches": launches}
    print("bus mission on camera perception, on the card: "
          + json.dumps(summary), flush=True)
    assert all(rep.delivered) and max(rep.final_err) < 0.35, summary
    return summary, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams
    from alore_legged_manipulator_tpu_torch.ops import wavefront as wf
    from alore_legged_manipulator_tpu_torch.ops import wavefront_cuda as wfc
    from alore_legged_manipulator_tpu_torch.ops.esdf import esdf_from_occupancy
    from alore_legged_manipulator_tpu_torch.ops.wavefront_bench import (
        bench_map_grids, random_grids, serpentine_grid)
    from alore_legged_manipulator_tpu_torch.runtime import mission_fleet as mf
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)

    # ---- 1. card and build ----
    _phase("card and build")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"device: {kind}", flush=True)
    print(smi, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    set_precision_policy()
    t0 = time.perf_counter()
    so, log = wfc.build()
    print(f"built {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    # ---- 2. kernels against their plain versions ----
    _phase("kernels against plain versions")
    rng = np.random.default_rng(0)
    m80 = check_kernels(wf, wfc, "80x80 B=192", *random_grids(rng, 192, 80, 80),
                        path_len=160, iters=20)
    m100 = check_kernels(wf, wfc, "100x100 B=4096", *bench_map_grids(rng, 4096),
                         path_len=256, iters=5)
    m64 = check_kernels(wf, wfc, "80x80 B=64", *random_grids(rng, 64, 80, 80),
                        path_len=160, iters=20)
    # a relaxation that n_iters cuts short (and the same grid run out)
    occ_s, goal_s, _ = serpentine_grid(40, 50)
    for n_iters in (7, None, 2000):
        _, _, sw, _ = check_identical(wf, wfc, f"serpentine n_iters={n_iters}",
                                      occ_s, goal_s, n_iters)
        print(f"serpentine 40x50, n_iters={n_iters}: bit-identical, "
              f"{int(sw[0])} sweeps", flush=True)
    # goals outside the grid (a negative index counts from the end once)
    # and on a blocked cell
    occ_o, _, _ = random_grids(rng, 8, 20, 24)
    occ_o[7, 5, 5] = True
    goals_o = np.array([[-1, 3], [-20, -24], [-21, 3], [20, 3], [2, 24],
                        [2, -25], [1000, 1000], [5, 5]])
    _, _, sw, _ = check_identical(wf, wfc, "goals outside", occ_o, goals_o)
    print(f"goals outside the grid / blocked: bit-identical, sweeps "
          f"{sw.tolist()}", flush=True)
    # a grid that the 10 B/cell layout of the first design could not hold
    check_identical(wf, wfc, "150x150", *random_grids(rng, 2, 150, 150)[:2])
    print("2x150x150: bit-identical", flush=True)
    for (H, W), few in (((80, 80), True), ((80, 80), False),
                        ((100, 100), False), ((150, 150), True)):
        for packed in (True, False):
            print(f"occupancy {H}x{W} {'K1' if packed else 'K2'}: "
                  + json.dumps(wfc.occupancy(H, W, packed, None, few)),
                  flush=True)
    oversize = torch.zeros((1, 162, 162), dtype=torch.bool, device="cuda")
    try:
        wfc.wavefront_packed_cuda(oversize, torch.zeros((1, 2), dtype=torch.int64,
                                                        device="cuda"))
    except ValueError as e:
        print(f"162x162 refused as expected: {e}", flush=True)
    else:
        raise AssertionError("a 162x162 grid was not refused")

    # ---- 3. the production mission on the card ----
    _phase("production mission B=64 K=3 on the card (compact, corrections)")
    from alore_legged_manipulator_tpu_torch.planner.backend import (
        BackendConfig)
    occ = np.zeros((80, 80), bool)
    occ[30:40, 44:50] = True
    icr = ICRParams(-0.3, 0.3, 0.2)
    cfg = mf.MissionFleetConfig(
        approach_ticks=700, push_ticks=550,
        backend=BackendConfig(solver_direction="compact"))
    corr_ticks = 300
    B, K = 64, 3
    items, targets = mf.spaced_scenarios(B, K, np.random.default_rng(0))
    robot0 = np.tile(np.array([1.0, 4.0, 0.0], np.float32), (B, 1))
    esdf = esdf_from_occupancy(torch.as_tensor(occ, device="cuda"),
                               torch.zeros(2), 0.1)
    items32, targets32 = items.astype(np.float32), targets.astype(np.float32)
    wfc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = mf.run_mission(items32, targets32, robot0, esdf, icr, cfg)
    torch.cuda.synchronize()
    wall_fleet = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, miss_counts = mf.correct_until_delivered(base, targets32, esdf, icr,
                                                  cfg, corr_ticks)
    torch.cuda.synchronize()
    wall_rounds = time.perf_counter() - t0
    sim_s = mf.mission_seconds_exact(res, cfg, corr_ticks,
                                     miss_counts=miss_counts) / B
    field_m, blk_m, goal_m = mission_field_through_k2(wf, esdf, targets32,
                                                      cfg, B)
    launches = dict(wfc.LAUNCHES)
    rounds = len(miss_counts)
    print("launches during the production mission:", json.dumps(launches),
          flush=True)
    assert launches["wavefront_packed"] == K + rounds, \
        f"K1 ran {launches['wavefront_packed']} times, not {K} + {rounds}"
    assert launches["octile_distance_field"] == 1, \
        "K2 did not run once through octile_distance_field"
    assert torch.equal(field_m, wf.octile_distance_field_torch(blk_m, goal_m)), \
        "the mission map's field differs from plain"
    assert bool((field_m < 1e9).any())
    assert_finite(base, (B, K), cfg.push_ticks)
    assert_finite(res, (B, K), cfg.push_ticks)
    before, after = fleet_summary(base), fleet_summary(res)
    print(json.dumps({
        "missions": B, "objects": K, "solver_direction": "compact",
        "correction_ticks": corr_ticks,
        "fleet_wall_s": wall_fleet, "rounds_wall_s": wall_rounds,
        "rounds": rounds, "miss_counts": miss_counts,
        "simulated_s_per_mission": sim_s,
        "missions_per_s": B / (wall_fleet + wall_rounds),
        "before_rounds": before, "after_rounds": after}), flush=True)
    # lanes delivered before the rounds are untouched by them
    keep = base.delivered
    for name in ("object_err", "track_err_max", "collision", "delivered"):
        assert torch.equal(getattr(res, name)[keep], getattr(base, name)[keep]), \
            f"{name} of a delivered lane changed in the rounds"
    assert torch.equal(res.push_traj[keep], base.push_traj[keep]), \
        "push_traj of a delivered lane changed in the rounds"
    assert torch.equal(res.plan_err, base.plan_err)
    assert torch.equal(res.robot_final, base.robot_final)
    assert int(sum(miss_counts[:1])) == int((~keep).sum())
    assert after["delivered_frac"] >= before["delivered_frac"]
    assert after["delivered_frac"] >= 0.85, \
        f"delivered_frac {after['delivered_frac']} after the rounds below 0.85"

    # ---- 4. the first slice's ring fleet (depth cut to K=1), leg phases,
    #      a small fleet card vs CPU ----
    launches_ring = ring_fleet(mf, wf, wfc, items32, targets32, robot0, esdf,
                               icr, field_m, base)
    leg_phases(mf, items32, targets32, robot0, esdf, icr, cfg,
               push_ticks=LEG_PUSH_TICKS)
    _phase("small fleet: card vs CPU plain")
    small_fleet_card_vs_cpu(items32, targets32, robot0, occ, cfg, icr)

    # ---- 5. the contact plant ----
    _phase("contact-plant fleet B=64 K=1 on the card (compact, corrections)")
    launches_phys, _ = physics_fleet(mf, wfc, esdf, icr, cfg.backend)
    _phase("contact plant: card vs CPU")
    physics_card_vs_cpu()
    _phase("known-map arrangement push on the card, contact plant (plan, "
           f"first {KNOWN_MAP_PUSH_S} s)")
    known_map_push_on_card(wfc)
    _phase("lidar-mapped arrangement mission on the card, contact plant")
    _, launches_mapped = arrangement_on_card(wfc)

    # ---- 6. the planner simulation ----
    _phase("planner simulation, LTV-MPC, corridor (perspective)")
    _, launches_ps_ltv = planner_sim_on_card(wfc, "corridor", PS_LTV_T, "ltv",
                                             (0.15, 0.45))
    _phase("planner simulation, NMPC, corridor (raycast)")
    _, launches_ps_nmpc = planner_sim_on_card(
        wfc, "nmpc_corridor_raycast", PS_NMPC_T, "nmpc", (0.2, 1.0))

    # ---- 7. variants on the card ----
    _phase("variants on the card")
    variants_on_card()

    # ---- 8. the trained high-level policy, served ----
    _phase("trained policy: card vs CPU, B=1 latency")
    policy_card_vs_cpu()
    _phase("tracking eval on the contact plant, 256 lanes x 100 steps")
    wfc.reset_launches()
    tracking_eval_on_card()
    launches_eval = dict(wfc.LAUNCHES)
    _phase("bus mission with the trained policy in the loop")
    _, launches_bus = bus_mission_on_card(wfc)
    _phase("low-level WBC: card vs CPU")
    low_level_card_vs_cpu()

    # ---- 9. training and camera perception ----
    _phase(f"training: PPO on the contact plant, B=1536 x 24 steps, "
           f"{TRAIN_ITERS} iterations from the CSV's start")
    wfc.reset_launches()
    state, _, _ = training_on_card()
    launches_train = dict(wfc.LAUNCHES)
    print("training, dispatched operations: "
          + json.dumps(train_dispatches(_train_cfg())), flush=True)
    _phase("training: checkpoint round trip, one f64 update card vs CPU")
    checkpoint_round_trip_on_card(state)
    ppo_update_card_vs_cpu()
    _phase("camera: card vs CPU, bus mission on camera perception")
    camera_card_vs_cpu()
    _, launches_cam = camera_bus_mission_on_card(wfc)

    # ---- 10. result lines ----
    kern = []
    for name, replaces in (
            ("wavefront_packed",
             "alore_legged_manipulator_tpu/ops/wavefront_pallas.py:282"),
            ("octile_distance_field",
             "alore_legged_manipulator_tpu/ops/wavefront_pallas.py:316")):
        m = m80[name]
        kern.append(dict(
            name=name, route="cuda",
            source="alore_legged_manipulator_tpu_torch/csrc/wavefront.cu",
            replaces=replaces, launches=launches[name],
            launches_ring_fleet=launches_ring[name],
            launches_physics_fleet=launches_phys[name],
            launches_mapped_arrangement=launches_mapped[name],
            launches_planner_sim_ltv=launches_ps_ltv[name],
            launches_planner_sim_nmpc=launches_ps_nmpc[name],
            launches_policy_eval=launches_eval[name],
            launches_bus_mission=launches_bus[name],
            launches_training=launches_train[name],
            launches_camera_mission=launches_cam[name],
            max_abs_err=max(m["max_abs_err"], m100[name]["max_abs_err"],
                            m64[name]["max_abs_err"]),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=None, shape=m["shape"],
            ms_64x80x80=m64[name]["ms"], plain_ms_64x80x80=m64[name]["plain_ms"],
            bound_ms_64x80x80=m64[name]["bound_ms"],
            ms_100x100=m100[name]["ms"], plain_ms_100x100=m100[name]["plain_ms"],
            bound_ms_100x100=m100[name]["bound_ms"]))
    print(json.dumps({"kernels": kern}), flush=True)
    print(f"script wall time: {time.perf_counter() - T_START:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
