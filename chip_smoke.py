"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing lines of its own under a header with the seconds
since the script started:

1. Card and build: the card's name and power limit, the precision
   policy, and the build of the wavefront kernels, the NMPC feedback
   kernel and the ADMM kernel at the LTV-MPC's shape from
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
   occupancy report is printed for each instantiation used.  Then K3,
   the NMPC feedback kernel (`nmpc_feedback_cuda`), through `feedback`
   against the plain `_feedback_matfree` at N=50 and B=1 and B=16384
   (float32 within 2e-4), each timed with CUDA events after a warm-up
   beside the plain version and the bound (`feedback_work`), with its
   registers and blocks per SM; `nmpc_feedback_probe()` runs this
   alone.  Then K4, the ADMM kernel (`qp_admm_cuda`), through
   `qp_admm_general` on the LTV-MPC's QP (145 variables, 201 rows, its
   layout's pattern) against the eager loop `admm_steps` at B=1 and
   B=4096 (float64 within 1e-10; float32 as close to the float64
   solution as the float32 loop), timed beside the plain loop and the
   bound (portbench/ltv_work.py), with its registers and blocks per SM;
   `qp_admm_probe()` runs this alone.  From here on every path's launch
   counts (`reset_launches`, `kernel_launches`) hold K3 to one launch
   for each matrix-free NMPC feedback call on the card and K4 to one for
   each ADMM pass there.
3. The production mission on the card at full width: B=64 three-object
   missions on the 80x80 map (wavefront front end, MINCO back end with
   the compact solver direction, NMPC + ICR-EKF closed-loop push) through
   `run_mission`, then `correct_until_delivered` with 300-tick correction
   legs for the missed lanes and `mission_seconds_exact`, and the fleet's
   first-leg field once more through the public `octile_distance_field`
   (K2).  The kernels' launch counts are set to 0 just before and read
   just after: K1 must have run once per leg and once per correction
   round, K2 once, K3 in the pushes.  Lanes delivered before the
   rounds must come out of them bit for bit.  The run prints bench.py's
   mission line (its `bench_mission` is this fleet: no warm-up, one
   timed iteration).
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
   the arrangement mission of tests/test_arrangement.py's scene on the
   contact plant on the card (ordering -> task FSM -> JPS front end ->
   PlanManager -> push), its first object, on a map that starts empty
   and is fused from 3 m lidar scans (`mapped=True`, MappedPlanManager),
   so that the wall is discovered on the way, cut in depth to the first
   MAPPED_PUSH_S simulated seconds of the push planned on the fused map
   and held to the mapped test's p95 bound there, with host wall time
   by phase, sensing its own.  Phase 12's two-object contact-plant
   mission runs that same push (item, target, plant) to delivery on the
   known map.
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
   hierarchy steps at f64 within 1e-9).  `served_probe()` runs these
   alone.
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
10. The data-parallel layer on a one-rank NCCL mesh (`make_mesh(1)`;
   NCCL, never gloo): the N=50 tracking tick at B=256 sharded against
   the same tick unsharded with the same injected plant noise (equal;
   no collective in the tick, one all-reduce in the fleet reduction),
   the contact env step at B=64, tests/test_parallel.py's B=16 mission
   fleet sharded (K1 counted) against the same fleet unsharded in a
   process of its own beside it, at that test's tolerances, and
   `train(mesh=...)` for 2 iterations against the training phase's
   first two (test_train_sharded.py's f32 tolerances); one tick traced
   by `device_trace` (kernels, device-busy share); K3 once in each of
   the phase's four tracking ticks.  Then the last
   modules: the septic MINCO card vs CPU at f64 and against the
   oracle's goldens, `max_rates` of the mapped arrangement's push plan
   card vs CPU, `make_scene("dense")` at 500x500 (card ESDF equal to the CPU's,
   a JPS path from the clear center), the camera phase's voxel map
   through .bt and .ot files, and the native bus against the Python one
   (round trip p50 / p99, host clock).  `mesh_probe()` runs it alone.
11. The compiled reference's goldens on the card (`golden_probe()` runs
   it alone), each family at its JAX test's tolerances, float64 and
   float32 where that test has a float32 band, by the code of the port's
   CPU golden tests (tests/test_torch_golden_*.py over
   tests/torch_golden_io.py's numpy readers): the back end's MINCO cases
   through the four spline solves (lu, thomas_scan, cr, dense), its
   stage-1/2 costs and gradients, the controller's trajectory analysis,
   the ICR-EKF op by op, the ESDF field and bilinear samples, the plant
   tick by tick, the three occupancy-fusion goldens, the ACADO NMPC's
   circle closed loop in three modes and the five LTV-MPC goldens (QP,
   ADMM solution, tick).  The launch-bound ACADO and LTV parts run in
   six child processes beside the parent's share.  One line a family:
   checks, the check nearest its tolerance (deviation, tolerance), ms.
12. The port's entry points (`alore_legged_manipulator_tpu_torch/entry.py`
   and the example twins under `.../examples/`): `entry()`'s B=64, N=50
   RTI tick on the card against the CPU (f32, 1e-4) and its median wall
   over 20 repeats (K3 once in each of its 24 ticks on the card);
   `mission_validation` at its defaults, orders and
   costs equal to the JAX example's; then the three child processes
   started right after phase 1 are joined (EXAMPLE_CHILDREN, each its
   own timeout, any failure fails the script): `arrangement_mission
   --objects 3` on the kinematic plant and `--objects 2 --physics`, each
   delivering every object inside tests/test_arrangement.py's bounds for
   its plant, and `planner_sim` at its defaults (inside PLANNER_SIM_BAND
   of the JAX example's CPU run) followed by `train_and_deploy_highlevel
   --physics --load-ckpt examples/artifacts/ckpt_physics_6000` (eval
   inside the JAX value + 0.05 per axis, mission DELIVERED within
   0.5 m).  One `example:` JSON line a run: wall by phase, plans, ticks,
   dispatched operations per tick, kernel launches.
13. The throughput drivers (`alore_legged_manipulator_tpu_torch/bench.py`,
   the twin of the repo's bench.py, and the example benches'
   twins under `.../examples/bench_*.py`), every line once at the cut
   sizes of BENCH_CUTS through its line function, one `bench:` JSON line
   each with its kernel launches (counted from 0): the NMPC RTI line at
   B=16384 (chain 1) and its peak memory, the B=1 latency line, the
   wavefront line at B=16384 (K1), the closed loop, the contact env,
   the mapping loop and the front-end table at B=1024 (K2) in this
   process; the back-end lines (B=2 and one B=1 plan), the mission legs
   (B=2) and the mission fleet (B=2, K=1, redispatched corrections; K1)
   in a child process started after phase 1.  K1 on the first 1024
   lanes of the wavefront line's 16384x100x100 batch and K2 on the
   front-end line's 1024-lane batch must be bit-identical to their
   plain versions (CUDA-event times, bounds; K1 also over the whole
   16384 lanes).  The non-timing fields are held: finite, the back
   end's plans on goal (1.5x the ALM tolerance) and collision-free, the
   mission fleet's `delivered_frac` >= 0.85, K1 / K2 launched on the
   lines whose path holds them, K3 on the closed loop, the legs and the
   mission fleet, and once an RTI tick on the two NMPC lines.
   `bench_probe()` runs it alone.
14. The `kernels` JSON line: K1, K2, K3 and K4 with their launches on
   each path (K1 and K2 0 on the planner simulation, the mapped mission,
   the served policy, training, the camera mission and the entry points,
   whose paths hold no wavefront; K1 once on the mesh mission; K3 on
   every path that ticks the NMPC on the card; K4 three times a tick of
   the LTV-MPC, on the planner simulation under it), the bench lines'
   launches, the bench shapes' comparisons and K3's times at B=1 and
   B=16384 and K4's at B=1 and B=4096, the script's wall time, and as
   the last line {"ok": true, "device": {...}}.

Fails (non-zero exit, no result line) without a CUDA card or without the
package beside it.  Imports nothing of JAX.
"""
from __future__ import annotations

import atexit
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

# shared memory: 132 SMs x 128 B/clock x 1.98 GHz
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9
T_START = time.perf_counter()
# simulated seconds of the two planner-simulation phases (depth cut)
PS_LTV_T = 0.3
PS_NMPC_T = 0.3
# simulated seconds of the lidar-mapped arrangement's push (depth cut:
# phase 12's two-object contact-plant mission runs that push to delivery)
MAPPED_PUSH_S = 2.0
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


# matrix-free NMPC feedback calls on a CUDA carry since `reset_launches`:
# the calls K3 serves, one launch each
FEEDBACK_CALLS = {"card": 0}


def _count_feedback_calls():
    """Wrap control/nmpc.py's `feedback` (every RTI and cold-start tick
    calls it through the module's globals) to count in FEEDBACK_CALLS the
    calls that K3 serves.  Idempotent."""
    from alore_legged_manipulator_tpu_torch.control import nmpc
    fb = nmpc.feedback
    if getattr(fb, "counted", False):
        return

    def counted(carry, prep, x_est, ref_x, ref_u, icr, cfg):
        if (carry.x_traj.is_cuda and cfg.qp_mode == "matfree"
                and cfg.condense_mode == "triangular"):
            FEEDBACK_CALLS["card"] += 1
        return fb(carry, prep, x_est, ref_x, ref_u, icr, cfg)
    counted.counted = True
    nmpc.feedback = counted


# qp_admm_general calls on CUDA tensors since `reset_launches`: the
# ADMM passes K4 serves, one launch each
ADMM_CALLS = {"card": 0}


def _count_admm_calls():
    """Wrap ops/qp.py's `qp_admm_general`, in that module and where
    control/ltv_mpc.py holds it, to count in ADMM_CALLS the calls on CUDA
    tensors, which K4 serves.  Idempotent."""
    from alore_legged_manipulator_tpu_torch.control import ltv_mpc
    from alore_legged_manipulator_tpu_torch.ops import qp
    fn = qp.qp_admm_general
    if getattr(fn, "counted", False):
        return

    def counted(H, g, *args, **kwargs):
        if g.is_cuda:
            ADMM_CALLS["card"] += 1
        return fn(H, g, *args, **kwargs)
    counted.counted = True
    qp.qp_admm_general = ltv_mpc.qp_admm_general = counted


def reset_launches():
    """Set to 0 the launch counts of the hand-written kernels (K1 and K2
    in ops/wavefront_cuda.py, K3 in ops/nmpc_feedback_cuda.py, K4 in
    ops/qp_admm_cuda.py) and the counts of the calls K3 and K4 serve."""
    from alore_legged_manipulator_tpu_torch.ops import nmpc_feedback_cuda
    from alore_legged_manipulator_tpu_torch.ops import qp_admm_cuda
    from alore_legged_manipulator_tpu_torch.ops import wavefront_cuda
    _count_feedback_calls()
    _count_admm_calls()
    wavefront_cuda.reset_launches()
    nmpc_feedback_cuda.reset_launches()
    qp_admm_cuda.reset_launches()
    FEEDBACK_CALLS["card"] = 0
    ADMM_CALLS["card"] = 0


def kernel_launches():
    """{kernel: launches since `reset_launches`}; fails unless K3 ran
    exactly once for each matrix-free NMPC feedback call on the card and
    K4 once for each ADMM pass there."""
    from alore_legged_manipulator_tpu_torch.ops import nmpc_feedback_cuda
    from alore_legged_manipulator_tpu_torch.ops import qp_admm_cuda
    from alore_legged_manipulator_tpu_torch.ops import wavefront_cuda
    out = {**wavefront_cuda.LAUNCHES, **nmpc_feedback_cuda.LAUNCHES,
           **qp_admm_cuda.LAUNCHES}
    calls = FEEDBACK_CALLS["card"]
    assert out["nmpc_feedback"] == calls, \
        f"K3 ran {out['nmpc_feedback']} times for {calls} feedback calls"
    passes = ADMM_CALLS["card"]
    assert out["qp_admm"] == passes, \
        f"K4 ran {out['qp_admm']} times for {passes} ADMM passes"
    return out


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


def feedback_work(B, n, qp_iters=4, cg_iters=15, itemsize=4):
    """(operations, bytes) of B lanes of the NMPC feedback at horizon n.
    Operations: 52 a stage for one Hessian application (C p: 13 to form
    the five columns, 5 to sum them, 6 to unpack; Q: 3; C'y: 2 + 5 + 6 +
    10; R p: 4), applied 1 + cg_iters + 4 times an outer iteration, and
    per variable 15 a CG trip (the mask and reg term 2, two dot products
    4, three updates 6, preconditioner 1, direction 2), 7 a line-search
    candidate, 6 for the gradient and step; 60 a stage of set-up.
    Bytes: every input read once and every output written once (x_traj,
    ref_x, the state outputs: 3 (n+1) values each, ref_u 2 (n+1), u_traj
    2n, x_int 3n, a02 and a12 n each, B0-B2 6n, x_est 3; u_new 2n)."""
    hess = 52 * n
    per_var = 15 * cg_iters + 7 * 4 + 6
    ops = qp_iters * ((1 + cg_iters + 4) * hess + per_var * 2 * n) + 60 * n
    values = 8 * (n + 1) + 13 * n + 3 + 3 * (n + 1) + 2 * n
    return B * ops, B * values * itemsize


def _feedback_inputs(B, n, dtype, seed=0):
    """`feedback`'s arguments (carry, prep, x_est, ref_x, ref_u, icr, cfg)
    for a lane batch whose references ask for 1-6 m/s and wheels of
    +-4 m/s, so that the QP's box is active."""
    from alore_legged_manipulator_tpu_torch.control import nmpc
    from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams
    rng = np.random.default_rng(seed)
    ts = 0.01 * np.arange(1, n + 2)
    speed = rng.uniform(1.0, 6.0, (B, 1))
    arrays = (rng.standard_normal((B, n + 1, 3)) * 0.1,
              rng.standard_normal((B, n, 2)) * 0.5,
              rng.standard_normal((B, 3)) * 0.1,
              np.stack([speed * ts, 0 * speed + 0.2 * np.sin(3 * ts),
                        0 * speed + 0.5 * ts], axis=1),
              np.stack([np.full((B, n + 1), 4.0),
                        np.full((B, n + 1), -4.0)], axis=1)
              * np.sign(rng.standard_normal((B, 1, 1))))
    t = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in arrays]
    carry = nmpc.NmpcCarry(t[0], t[1])
    cfg, icr = nmpc.NmpcConfig(horizon=n), ICRParams(-0.3, 0.3, 0.2)
    prep = nmpc.prepare_tri(carry, icr, cfg)
    return carry, prep, t[2], t[3], t[4], icr, cfg


def nmpc_feedback_on_card(log=""):
    """K3, the NMPC feedback kernel, through `feedback` on a CUDA carry
    against the plain `_feedback_matfree` at N=50, B=1 and B=16384
    (float32): max gaps (within 2e-4), kernel ms (CUDA events over
    back-to-back calls after a warm-up; device ms from a graph's
    replays), plain ms, the bound (operations at 67 TFLOP/s f32 or bytes
    at 3.35 TB/s, the larger), registers and blocks per SM, and K3's
    launches (one a call).  Returns {B: measurements}."""
    from alore_legged_manipulator_tpu_torch.control import nmpc
    from alore_legged_manipulator_tpu_torch.ops import (
        nmpc_feedback_cuda as nfc)
    from alore_legged_manipulator_tpu_torch.ops.wavefront_bench import (
        graph_ms, time_ms)
    for line in log.splitlines():
        if "entry function" in line or "registers" in line:
            print("  ptxas (K3):", line.strip(), flush=True)
    out = {}
    for B in (1, 16384):
        args = _feedback_inputs(B, 50, torch.float32, seed=B)
        carry, prep, x_est, ref_x, ref_u, _, cfg = args
        reset_launches()
        _, x_k, u_k = nmpc.feedback(*args)
        assert kernel_launches()["nmpc_feedback"] == 1
        _, x_p, u_p = nmpc._feedback_matfree(carry, prep, x_est, ref_x,
                                             ref_u, cfg)
        gaps = (float((x_k - x_p).abs().max()),
                float((u_k - u_p).abs().max()))
        assert max(gaps) < 2e-4, f"K3 B={B}: kernel vs plain {gaps}"
        ops, nbytes = feedback_work(B, 50, cfg.qp_iters, cfg.cg_iters)
        by_ops, by_bytes = ops / 67e12 * 1e3, nbytes / 3.35e12 * 1e3
        ms = time_ms(lambda: nmpc.feedback(*args), 200 if B == 1 else 50,
                     warmup=3)
        out[B] = dict(
            shape=f"B={B} N=50 f32", max_gap_x=gaps[0], max_gap_u=gaps[1],
            ms=ms, device_ms=graph_ms(lambda: nmpc.feedback(*args)),
            plain_ms=time_ms(lambda: nmpc._feedback_matfree(
                carry, prep, x_est, ref_x, ref_u, cfg), 2, warmup=1),
            bound_ms=max(by_ops, by_bytes),
            bound_by="operations" if by_ops >= by_bytes else "bytes",
            ops=ops, bytes=nbytes,
            launches=kernel_launches()["nmpc_feedback"],
            **nfc.occupancy(50))
        print(f"K3 nmpc_feedback {out[B]['shape']}: " + json.dumps(out[B]),
              flush=True)
    return out


def nmpc_feedback_probe():
    """Build K3 and run `nmpc_feedback_on_card` alone (about a minute)."""
    from alore_legged_manipulator_tpu_torch.ops import (
        nmpc_feedback_cuda as nfc)
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    set_precision_policy()
    t0 = time.perf_counter()
    so, log = nfc.build()
    print(f"built {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    nmpc_feedback_on_card(log)


def _admm_inputs(B, dtype, seed=0):
    """(H, g, A, lb, ub) of the LTV-MPC's first pass (`ltv-mpc-3ms`: 145
    variables, 201 rows) at B random states, references and carried
    plans on the card, and its layout's pattern of A."""
    from alore_legged_manipulator_tpu_torch.control import ltv_mpc as tl
    cfg = tl.LtvMpcConfig()
    rng = np.random.default_rng(seed)
    T = cfg.horizon
    x0 = np.stack([rng.uniform(-1, 1, B), rng.uniform(-1, 1, B),
                   rng.uniform(-3, 3, B)], -1)
    output = np.stack([rng.uniform(-0.5, 2.0, (B, T)),
                       rng.uniform(-4.0, 4.0, (B, T))], 1)
    ts = 0.01 * np.arange(1, T + 1)
    xref = np.stack([x0[:, :1] + ts, x0[:, 1:2] + 0.3 * ts,
                     np.zeros((B, T)), x0[:, 2:3] + 0.5 * ts], 1)
    dref = np.stack([np.full((B, T), 1.0), np.full((B, T), 0.5)], 1)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")
    carry = tl.LtvMpcCarry(output=t(output),
                           delay_buff=t(rng.uniform(-1, 1, (B, 1, 2))))
    xbar = tl._rollout(t(x0), carry.output, cfg)
    qp = tl._build_qp(xbar, t(xref), t(dref), carry, cfg)
    return qp, tl._qp_layout(cfg, dtype, torch.device("cuda")).pattern


def _admm_factor(H, A, lb, ub, rho=0.4):
    """qp_admm_general's rows' rho and lower factor of its KKT matrix."""
    rho_vec = torch.where(torch.abs(ub - lb) < 1e-12,
                          torch.full_like(lb, rho * 1e3),
                          torch.full_like(lb, rho))
    K = (H + 1e-6 * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
         + torch.matmul(A.transpose(1, 2) * rho_vec[:, None, :], A))
    return rho_vec, torch.linalg.cholesky_ex(K).L


def _admm_plain(H, g, A, lb, ub, iters=150, rho=0.4):
    """qp_admm_general's steps through the eager loop on the card."""
    from alore_legged_manipulator_tpu_torch.ops.qp import admm_steps
    rho_vec, L = _admm_factor(H, A, lb, ub, rho)
    return admm_steps(L, A, g, lb, ub, rho_vec, None, 1e-6, 1.6, iters)


def qp_admm_on_card():
    """K4, the ADMM kernel, through `qp_admm_general` on the LTV-MPC's QP
    with its layout's pattern against the eager loop (`admm_steps`) at
    B=1 and B=4096, 150 steps: in float64 within 1e-10; in float32 each
    lane's gap to the float64 solution at most twice the float32 loop's
    plus 1e-5 (the two sum in other orders; tests/test_torch_qp_admm_cuda
    .py).  Times (float32, one pass, from the factor): kernel ms (CUDA
    events over back-to-back passes after a warm-up; device ms from a
    graph's replays), plain ms, the bound (portbench/ltv_work.py's
    admm_bound_ms, a pass a third of a tick's), registers, blocks per SM
    and launches (one a pass).  Returns {B: measurements}."""
    from alore_legged_manipulator_tpu_torch.ops import qp_admm_cuda as qac
    from alore_legged_manipulator_tpu_torch.ops.qp import qp_admm_general
    from alore_legged_manipulator_tpu_torch.ops.wavefront_bench import (
        graph_ms, time_ms)
    from portbench import ltv_work
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "portbench", "configs", "ltv-mpc-3ms.json")) as f:
        config = json.load(f)
    f32, f64 = torch.float32, torch.float64
    out = {}
    for B in (1, 4096):
        qp64, pat64 = _admm_inputs(B, f64, seed=B)
        x64, y64 = _admm_plain(*qp64)
        got = qp_admm_general(*qp64, iters=150, rho=0.4, pattern=pat64)
        gap64 = max(float((a - b).abs().max())
                    for a, b in zip(got, (x64, y64)))
        assert gap64 < 1e-10, f"K4 B={B} float64: kernel vs eager {gap64}"
        qp, pat = _admm_inputs(B, f32, seed=B)
        plain = _admm_plain(*qp)
        H, g, A, lb, ub = qp
        qac.reset_launches()
        x_k, y_k = qp_admm_general(*qp, iters=150, rho=0.4, pattern=pat)
        torch.cuda.synchronize()
        launches = qac.LAUNCHES["qp_admm"]
        assert launches == 1, f"K4 ran {launches} times for one pass"
        gaps = {}
        for name, k, p, r in (("x", x_k, plain[0], x64),
                              ("y", y_k, plain[1], y64)):
            scale = float(r.abs().max()) or 1.0
            gk = (k.double() - r).abs().flatten(1).amax(1) / scale
            gp = (p.double() - r).abs().flatten(1).amax(1) / scale
            gaps[name] = dict(kernel_vs_plain=float((k - p).abs().max()),
                              kernel_vs_f64=float(gk.max()),
                              plain_vs_f64=float(gp.max()))
            assert bool((gk <= 2.0 * gp + 1e-5).all()), \
                f"K4 B={B} float32 {name}: {gaps[name]}"
        L = _admm_factor(H, A, lb, ub)[1]

        def run():
            return qac.qp_admm_cuda(L, A, g, lb, ub, rho=0.4, sigma=1e-6,
                                    alpha=1.6, iters=150, pattern=pat)
        by_ops = 1e3 * B * 150 * ltv_work.step_flops(config) \
            / ltv_work.PEAK_FLOPS
        by_bytes = 1e3 * B * ltv_work.pass_bytes(config) / ltv_work.PEAK_BYTES
        bound = max(by_ops, by_bytes)
        assert abs(bound - ltv_work.admm_bound_ms(config, B, 450) / 3) \
            <= 1e-9 * bound
        ms = time_ms(run, 20 if B == 1 else 5, warmup=2)
        out[B] = dict(
            shape=f"B={B} n=145 m=201 nnz={pat.nnz} "
                  f"L={pat.l_entries} f32",
            gaps=gaps, max_gap_f64=gap64, ms=ms,
            device_ms=graph_ms(run, replays=5),
            plain_ms=time_ms(lambda: _admm_plain(*qp), 1, warmup=1),
            bound_ms=bound,
            bound_by="operations" if by_ops >= by_bytes else "bytes",
            roofline_pct=100.0 * bound / ms, launches=launches,
            **qac.occupancy(145, 201, pat.nnz, pat.l_entries, f32))
        print(f"K4 qp_admm {out[B]['shape']}: " + json.dumps(out[B]),
              flush=True)
    return out


def qp_admm_probe():
    """Build K4 and run `qp_admm_on_card` alone (about a minute)."""
    from alore_legged_manipulator_tpu_torch.ops import qp_admm_cuda as qac
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    set_precision_policy()
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        so, log = qac.build(dtype)
        print(f"built {so.name} ({dtype}) in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas (K4):", line.strip(), flush=True)
    return qp_admm_on_card()


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


def ring_fleet(mf, wf, items32, targets32, robot0, esdf, icr, field_m,
               prod):
    """The first slice's ring-direction fleet, cut in depth to K=1, 300
    approach and RING_PUSH_TICKS push ticks, with its own launch counts; `prod` is the production
    fleet's result before its rounds.  Returns the launches."""
    _phase("ring fleet B=64 K=1 on the card (no corrections, cut in depth)")
    B = items32.shape[0]
    cfg_ring = mf.MissionFleetConfig(approach_ticks=300,
                                     push_ticks=RING_PUSH_TICKS)
    assert cfg_ring.backend.solver_direction == "ring"
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_ring = mf.run_mission(items32[:, :1], targets32[:, :1], robot0, esdf,
                              icr, cfg_ring)
    torch.cuda.synchronize()
    wall_ring = time.perf_counter() - t0
    field_r, _, _ = mission_field_through_k2(wf, esdf, targets32, cfg_ring, B)
    launches_ring = kernel_launches()
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


def physics_fleet(mf, esdf, icr, backend_cfg):
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
        reset_launches()
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
        launches = kernel_launches()
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


def arrangement_on_card(push_s=MAPPED_PUSH_S):
    """The arrangement mission of tests/test_arrangement.py's scene on
    the contact plant, on the card, cut to its first object and the first
    `push_s` simulated seconds of that object's push: item (2.5, 2.5) to
    target (8, 7.5) past the wall occ[48:52, 20:45].  The planning map
    starts empty and is fused from 3 m lidar scans (MappedPlanManager,
    raycast), so the wall is found on the way; the push is planned on
    the fused map.  The same push on the contact plant runs to delivery
    in phase 12's two-object mission.  Held to the mapped test's p95
    tracking bound (0.25 m) over the simulated part, and the object must
    advance.  Host wall time by phase, sensing its own.  Returns
    (summary, K1/K2 launches, the push's planned trajectory)."""
    from alore_legged_manipulator_tpu_torch.mission import plan_manager as pm
    from alore_legged_manipulator_tpu_torch.runtime import arrangement as arr
    from alore_legged_manipulator_tpu_torch.world.lidar import LidarConfig
    occ = np.zeros((100, 100), bool)
    occ[48:52, 20:45] = True
    item = (2.5, 2.5, 0.0)
    mission = arr.ArrangementMission(
        occ=occ, lower=(0.0, 0.0), res=0.1, items=[item],
        targets=[(8.0, 7.5, 0.0)], use_physics_plant=True, mapped=True,
        lidar_cfg=LidarConfig(max_range=3.0))
    ticks = int(round(push_s / 0.01))
    full_push, pushed = arr.simulate_tracking_physics, []

    def cut_push(tracked, _ticks, cfg, seed=0):
        pushed.append(tracked)
        return full_push(tracked, ticks, cfg, seed=seed)
    arr.simulate_tracking_physics = cut_push
    clock = PhaseClock()
    clock.wrap(arr, "jps_search", "ordering_and_approach_jps")
    clock.wrap(pm, "plan_frontend", "front_end")
    clock.wrap(pm, "esdf_from_occupancy", "esdf_updates")
    clock.wrap(pm, "plan_backend", "back_end")
    clock.wrap(pm, "build_tracked_traj", "tracked_traj")
    clock.wrap(arr, "simulate_tracking_physics", "tracking")
    clock.wrap(pm.MappedPlanManager, "sense", "sensing")
    reset_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = mission.run(robot_start=(5.0, 1.0, 1.57), record_tracks=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        clock.restore()
        arr.simulate_tracking_physics = full_push
    launches = kernel_launches()
    (track,) = rep.object_tracks
    summary = {"mapped": True, "order": rep.order,
               "simulated_push_s": push_s,
               "push_tracking_err_p95": rep.push_tracking_err_p95,
               "object_moved_m": float(np.linalg.norm(
                   track[-1, :2] - np.asarray(item[:2]))),
               "wall_s": wall,
               "wall_by_phase_s": clock.report(wall),
               "scans": clock.calls.get("sensing", 0),
               "plans": clock.calls.get("back_end", 0),
               "kernel_launches": launches}
    print("arrangement mission, first object, contact plant, lidar-mapped "
          f"map, plan and first {push_s} s of the push, on the card: "
          + json.dumps(summary), flush=True)
    assert rep.order == [0] and summary["plans"] == 1, summary
    assert len(track) == ticks and np.isfinite(track).all()
    assert summary["push_tracking_err_p95"] < 0.25, summary
    assert summary["object_moved_m"] > 0.1 * push_s, summary
    assert summary["scans"] > 8, summary["scans"]
    return summary, launches, pushed[0].traj


GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "golden", "e2e_oracle", "goldens")
# oracle StateMachine (plan_manager.hpp:26) -> PlanState name
STATE_NAMES = {1: "IDLE", 2: "PLANNING", 3: "REPLAN", 4: "GOING_TO_GOAL",
               5: "EMERGENCY_STOP"}


def _matched_ticks(golden_t, ticks, atol=1e-9):
    """How many golden plan ticks have a plan tick within atol."""
    return sum(1 for g in golden_t
               if any(abs(t - g) <= atol for t in ticks))


def planner_sim_on_card(golden_name, sim_T, tracker, pose_band):
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
    reset_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trace = ps.run_planner_sim(scn, cfg, ps.LtvMpcConfig(),
                                   tracker=tracker)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        clock.restore()
    launches = kernel_launches()

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
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    set_precision_policy()
    planner_sim_on_card("corridor", 0.1, "ltv", (0.15, 0.45))
    planner_sim_on_card("nmpc_corridor_raycast", 0.1, "nmpc",
                        (0.2, 1.0))


def served_probe():
    """The served policy's phases alone (the policy card vs CPU, the
    eval, the bus mission, the low-level WBC), about two minutes of
    command time."""
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    set_precision_policy()
    for name, fn in (("policy", policy_card_vs_cpu),
                     ("eval", tracking_eval_on_card),
                     ("bus mission", bus_mission_on_card),
                     ("low level", low_level_card_vs_cpu)):
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


def bus_mission_on_card():
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
    reset_launches()
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
    launches = kernel_launches()
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
    Returns (ppo_state, history, summary, the state_dicts of the actor
    and the critic after iteration 1)."""
    from alore_legged_manipulator_tpu_torch.rl.runner import train
    cfg = _train_cfg(seed=seed)
    csv_rows = _csv_rows(TRAIN_ITERS)
    keys = ("mean_reward", "estimator_loss", "kl", "lr", "policy_loss",
            "value_loss")
    timings = []
    after_two = {}

    def progress(it, m):
        if it == 1:
            after_two.update({k: {n: v.clone() for n, v in
                                  mod.state_dict().items()}
                              for k, mod in zip(("actor", "critic"),
                                                models)})
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
    return state, hist, summary, after_two


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
        _, hist, _, _ = training_on_card(seed=seed, check=False)
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
    bands = training_bands()
    REWARD_BANDS.update({it: tuple(b["band"]) for it, b in bands.items()})
    state, _, _, _ = training_on_card()
    print("training, dispatched operations: "
          + json.dumps(train_dispatches(_train_cfg())), flush=True)
    checkpoint_round_trip_on_card(state)
    ppo_update_card_vs_cpu()
    camera_card_vs_cpu()
    camera_bus_mission_on_card()
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
    (render, color, masks) on the card.  Returns the summary and the
    card's map (the offset one: state, lower, resolution)."""
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

    maps, card_map = {}, None
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
            if name == "offset" and d == "cuda":
                card_map = (st, np.asarray(lower), 0.2)
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
    return out, card_map


def camera_bus_mission_on_card():
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
    reset_launches()
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
    launches = kernel_launches()
    summary = {"delivered": rep.delivered, "ticks": rep.ticks,
               "final_err_m": rep.final_err, "wall_s": wall,
               "renders": clock.calls.get("render", 0) // 3,
               "wall_by_phase_s": clock.report(wall),
               "kernel_launches": launches}
    print("bus mission on camera perception, on the card: "
          + json.dumps(summary), flush=True)
    assert all(rep.delivered) and max(rep.final_err) < 0.35, summary
    return summary, launches

# ---------------------------------------------------------------------------
# 10. the data-parallel layer on a one-rank NCCL mesh, and the last modules
# ---------------------------------------------------------------------------

MINCO_S4_GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests", "golden", "minco_s4_oracle",
                                "goldens.txt")
MINCO_S4_WEIGHTS = (0.7, 1.3)


def _count_collectives(fn):
    """fn() with every torch.distributed collective counted: (result,
    {name: calls})."""
    import torch.distributed as dist
    counts, saved = {}, {}
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor",
                 "broadcast", "reduce", "reduce_scatter",
                 "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
                 "gather", "scatter", "barrier", "send", "recv"):
        f = getattr(dist, name, None)
        if f is None:
            continue
        saved[name] = f

        def wrapped(*a, _f=f, _n=name, **kw):
            counts[_n] = counts.get(_n, 0) + 1
            return _f(*a, **kw)
        setattr(dist, name, wrapped)
    try:
        return fn(), counts
    finally:
        for name, f in saved.items():
            setattr(dist, name, f)


def _max_gap(a, b):
    from alore_legged_manipulator_tpu_torch.parallel.mesh import tree_map
    xs, ys = [], []
    tree_map(xs.append, a)
    tree_map(ys.append, b)
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(xs, ys))


def mesh_tick_and_env(mesh):
    """The dry run's tracking tick (N=50) at B=256 on the mesh against the
    same tick unsharded with the same injected plant noise (both
    gathered), counting its collectives (none allowed); the contact env
    step at B=64 on the mesh; then one device_trace around one tick: its
    kernel count and the device-busy share of the traced window.  The
    kernels' launches are counted over the phase: K3 once a tick (four
    ticks).  Returns the summary."""
    from alore_legged_manipulator_tpu_torch.control.nmpc import NmpcConfig
    from alore_legged_manipulator_tpu_torch.parallel import dryrun
    from alore_legged_manipulator_tpu_torch.parallel import mesh as pm
    from alore_legged_manipulator_tpu_torch.parallel.scaling import (
        make_fleet)
    from alore_legged_manipulator_tpu_torch.utils.profiling import (
        device_trace, trace_summary)
    B = 256
    noise = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (B, 5, 2)), dtype=torch.float32)
    reset_launches()
    (out_sh, mean_cmd), counts = _count_collectives(
        lambda: dryrun.tick_program(mesh, B, noise=noise))
    cfg = NmpcConfig()
    step = pm.batched_tracking_step(dryrun.dryrun_traj(), dryrun.ICR,
                                    nmpc_cfg=cfg)
    state = make_fleet(B, cfg, device="cuda")[:4]
    out_one, tick_coll = _count_collectives(
        lambda: step(*state, noise.cuda(), 0.0))
    gap = _max_gap(pm.gather_scenarios(mesh, out_sh), out_one[:4])
    r, mean_r = dryrun.env_program(mesh, 64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(*state, noise.cuda(), 0.0)
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_trace")
    t0 = time.perf_counter()
    with device_trace(log_dir):
        step(*state, noise.cuda(), 0.0)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    tr = trace_summary(os.path.join(log_dir, "trace.json"))
    launches = kernel_launches()
    summary = {"tick_batch": B, "horizon": cfg.horizon,
               "kernel_launches": launches,
               "tick_sharded_vs_unsharded_max_abs_err": gap,
               "tick_collectives_sharded": counts, "mean_abs_cmd": mean_cmd,
               "tick_collectives_unsharded": tick_coll,
               "env_batch": 64, "env_mean_reward": mean_r,
               "traced_tick": tr, "traced_tick_host_s": traced_s,
               "untraced_tick_host_s": untraced_s,
               "device_busy_share_of_untraced_tick":
                   tr["device_busy_us"] * 1e-6 / untraced_s}
    print("mesh: tracking tick and env step: " + json.dumps(summary),
          flush=True)
    # the tick's only collective is the fleet reduction of its commands
    assert counts == {"all_reduce": 1} and tick_coll == {}, summary
    assert gap <= 1e-6, summary
    assert np.isfinite(mean_r) and r.shape == (64,), summary
    assert 0.0 <= tr["busy_share"] <= 1.0, tr
    assert launches["nmpc_feedback"] == 4, launches
    return summary


def _mesh_mission_fleet():
    """tests/test_parallel.py::test_sharded_mission_fleet_matches_single_
    device's fleet (B=16 one-object missions on its 40x40 map, approach
    30 / push 40 ticks), with the production profile's compact solver
    direction: (items, targets, robots, esdf, icr, cfg)."""
    from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams
    from alore_legged_manipulator_tpu_torch.parallel.dryrun import plan_esdf
    from alore_legged_manipulator_tpu_torch.planner.backend import (
        BackendConfig)
    from alore_legged_manipulator_tpu_torch.runtime import mission_fleet as mf
    B = 16
    cfg = mf.MissionFleetConfig(
        backend=BackendConfig(solver_direction="compact"), n_pieces=3,
        approach_ticks=30, grasp_ticks=2, release_ticks=2, push_ticks=40,
        correction_ticks=0)
    rng = np.random.default_rng(3)
    items = torch.as_tensor(rng.uniform(0.9, 1.1, (B, 1, 2)),
                            dtype=torch.float32)
    targets = torch.as_tensor(rng.uniform([2.5, 1.1], [2.7, 1.3], (B, 1, 2)),
                              dtype=torch.float32)
    robots = torch.tensor([0.5, 0.5, 0.0]).expand(B, 3).clone()
    return (items, targets, robots, plan_esdf("cuda"),
            ICRParams(yr=-0.3, yl=0.3, xv=0.2), cfg)


def unsharded_mission_child(out_path):
    """Phase 10's reference, run in a process of its own beside the
    sharded fleet: the mesh mission's fleet unsharded on the card, its
    outcomes and wall time written to `out_path` (.npz)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from alore_legged_manipulator_tpu_torch.runtime import mission_fleet as mf
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)
    set_precision_policy()
    fleet = _mesh_mission_fleet()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mf.run_mission(*fleet)
    torch.cuda.synchronize()
    np.savez(out_path, wall_s=time.perf_counter() - t0,
             **{k: getattr(res, k).cpu().numpy()
                for k in ("object_err", "delivered", "track_err_max")})


def start_unsharded_mission():
    """Starts `unsharded_mission_child` in a new process; returns (the
    process, its output path, its log path)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", "chip_smoke_unsharded_mission.npz")
    log = out[:-4] + ".log"
    os.makedirs(os.path.dirname(out), exist_ok=True)
    for p in (out, log):
        if os.path.exists(p):
            os.remove(p)
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke.unsharded_mission_child({out!r})"],
            cwd=root, stdout=f, stderr=subprocess.STDOUT)
    return proc, out, log


def mesh_mission(mesh, child):
    """The mesh mission's fleet (`_mesh_mission_fleet`) on the mesh, its
    K1 launches counted, against the same fleet unsharded on the card in
    the process `child` (`start_unsharded_mission`, started at the
    phase's start so that the two run side by side: two B=16 runs one
    after the other take about a minute on an H100, PERF.md §6), at that
    test's tolerances."""
    from alore_legged_manipulator_tpu_torch.parallel import mesh as pm
    from alore_legged_manipulator_tpu_torch.runtime import mission_fleet as mf
    items, targets, robots, esdf, icr, cfg = _mesh_mission_fleet()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh = mf.run_mission(*pm.shard_scenarios(mesh, (items, targets, robots)),
                        esdf, icr, cfg, device=mesh.device)
    sh = pm.gather_scenarios(mesh, sh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    proc, out, log = child
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        with open(log) as f:
            raise RuntimeError(f"the unsharded mission failed "
                               f"({proc.returncode}):\n{f.read()}")
    one = np.load(out)
    e_sh, e_one = sh.object_err.cpu().numpy(), one["object_err"]
    t_sh, t_one = sh.track_err_max.cpu().numpy(), one["track_err_max"]
    summary = {"lanes": items.shape[0], "solver_direction": "compact",
               "wall_s": wall, "wall_unsharded_s": float(one["wall_s"]),
               "kernel_launches": launches,
               "object_err_max_gap": float(np.abs(e_sh - e_one).max()),
               "track_err_max_gap": float(np.abs(t_sh - t_one).max()),
               "delivered": int(sh.delivered.sum())}
    print("mesh: mission fleet, sharded vs unsharded (beside it, in a "
          "process of its own): " + json.dumps(summary), flush=True)
    assert launches["wavefront_packed"] == 1, launches
    np.testing.assert_allclose(e_sh, e_one, atol=0.05)
    assert np.array_equal(sh.delivered.cpu().numpy(), one["delivered"])
    np.testing.assert_allclose(t_sh, t_one, rtol=0.5, atol=0.05)
    return summary, launches


def mesh_training(mesh, hist_ref, params_ref):
    """`train(cfg, mesh=mesh)` for 2 iterations from the seed-0 initial
    parameters at B=1536 against the first two iterations of the
    single-device seed-0 run: history rtol 5e-4 / atol 1e-6, parameters
    rtol 1e-3 / atol 1e-5 (tests/test_train_sharded.py's f32
    tolerances)."""
    from alore_legged_manipulator_tpu_torch.rl.runner import train
    models = _init_models()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = train(_train_cfg(iterations=2), mesh=mesh, models=models)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    worst = {"hist": 0.0, "params": 0.0}
    for h, r in zip(hist, hist_ref[:2]):
        for k in r:
            np.testing.assert_allclose(h[k], r[k], rtol=5e-4, atol=1e-6,
                                       err_msg=k)
            worst["hist"] = max(worst["hist"],
                                abs(h[k] - r[k]) / max(abs(r[k]), 1e-12))
    for name, mod in zip(("actor", "critic"), models):
        for n, v in mod.state_dict().items():
            ref = params_ref[name][n]
            torch.testing.assert_close(v, ref, rtol=1e-3, atol=1e-5,
                                       msg=f"{name}.{n}")
            worst["params"] = max(worst["params"],
                                  float((v - ref).abs().max()))
    summary = {"iterations": 2, "num_envs": 1536, "wall_s": wall,
               "max_rel_err_history": worst["hist"],
               "max_abs_err_params": worst["params"],
               "rewards": [h["mean_reward"] for h in hist]}
    print("mesh: training vs the single-device seed-0 run: "
          + json.dumps(summary), flush=True)
    return summary


def _minco_s4_goldens():
    """The oracle's cases and their inputs (tests/test_minco_s4.py's LCG)."""
    cases, cur = [], None
    with open(MINCO_S4_GOLDENS) as f:
        for ln in f.read().splitlines():
            p = ln.split()
            if p[0] == "CASE":
                cur = {"n": int(p[1])}
                cases.append(cur)
            elif p[0] == "C":
                cur["coeffs"] = np.array(p[1:], float).reshape(cur["n"], 8, 2)
            elif p[0] == "E":
                cur["energy"] = float(p[1])
            elif p[0] == "GP":
                cur["gp"] = np.array(p[1:], float).reshape(-1, 2).T
            elif p[0] == "GT":
                cur["gt"] = np.array(p[1:], float)
    state = [12345.0]

    def rnd():
        state[0] = np.fmod(state[0] * 1103515245.0 + 12345.0, 2147483648.0)
        return state[0] / 1073741824.0 - 1.0
    inputs = []
    for c in cases:
        n = c["n"]
        head, tail = np.zeros((2, 4)), np.zeros((2, 4))
        for d in range(2):
            for o in range(4):
                head[d, o] = rnd()
                tail[d, o] = rnd()
        inner = np.zeros((2, n - 1))
        for i in range(n - 1):
            inner[0, i] = rnd()
            inner[1, i] = rnd()
        ts = np.array([0.5 + 0.5 * (rnd() + 1.0) for _ in range(n)])
        inputs.append((head, tail, inner, ts))
    return cases, inputs


def last_modules_on_card(push_plan, card_map):
    """The last modules of the port on the card: the septic MINCO at f64
    card vs CPU (1e-9 of each quantity's largest magnitude) and against
    the compiled reference's goldens; `max_rates` of the mapped
    arrangement's push plan card vs CPU (f64, 1e-9); the "dense" scene at
    its full 500x500: card ESDF equal to the CPU's bit for bit,
    a JPS path from the clear center to a free cell 10-25 m out; the
    camera phase's voxel map through .bt and .ot files and back; the
    native UDP bus
    against the Python one in this process, the obs contract's round
    trip p50 / p99 (host clock)."""
    from alore_legged_manipulator_tpu_torch.ops import roots
    from alore_legged_manipulator_tpu_torch.ops.esdf import (
        esdf_from_occupancy)
    from alore_legged_manipulator_tpu_torch.planner import frontend
    from alore_legged_manipulator_tpu_torch.runtime.contracts import EnvObs
    from alore_legged_manipulator_tpu_torch.runtime.native_transport import (
        NativeUdpBus)
    from alore_legged_manipulator_tpu_torch.runtime.transport import UdpBus
    from alore_legged_manipulator_tpu_torch.solvers import minco_s4
    from alore_legged_manipulator_tpu_torch.world import octomap_io, scene
    from alore_legged_manipulator_tpu_torch.world import voxel_map as vm
    out = {}
    # septic MINCO, f64
    cases, inputs = _minco_s4_goldens()
    gaps = {"card_vs_cpu_rel": 0.0, "vs_goldens_rel": 0.0}
    for case, inp in zip(cases, inputs):
        res = {}
        for d in ("cpu", "cuda"):
            h, t, inn, ts = [torch.tensor(x, dtype=torch.float64,
                                          device=d)[None] for x in inp]
            c = minco_s4.minco_s4_coeffs(h, t, inn, ts)
            e = minco_s4.minco_s4_energy(c, ts, MINCO_S4_WEIGHTS)
            gp, gt = minco_s4.minco_s4_energy_grads(h, t, inn, ts,
                                                    MINCO_S4_WEIGHTS)
            res[d] = [x[0].cpu().numpy() for x in (c, e, gp, gt)]
        for a, b in zip(res["cuda"], res["cpu"]):
            gaps["card_vs_cpu_rel"] = max(
                gaps["card_vs_cpu_rel"],
                float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0)))
        c, e, gp, gt = res["cuda"]
        np.testing.assert_allclose(c, case["coeffs"], rtol=1e-9, atol=1e-9)
        assert abs(float(e) - case["energy"]) < \
            1e-7 * max(1.0, case["energy"])
        np.testing.assert_allclose(gp, case["gp"], rtol=1e-7)
        np.testing.assert_allclose(gt, case["gt"], rtol=1e-7)
        gaps["vs_goldens_rel"] = max(gaps["vs_goldens_rel"], float(
            np.max(np.abs(gt - case["gt"]) / np.abs(case["gt"]))))
    out["minco_s4_f64"] = gaps
    assert gaps["card_vs_cpu_rel"] <= 1e-9, gaps
    # max_rates of a back-end plan
    rates = {}
    for d in ("cpu", "cuda"):
        rates[d] = torch.stack(roots.max_rates(
            push_plan.coeffs.to(d, torch.float64),
            push_plan.times.to(d, torch.float64)), -1).cpu().numpy()
    out["max_rates"] = rates["cuda"].tolist()
    out["max_rates_card_vs_cpu"] = float(np.abs(rates["cuda"]
                                                - rates["cpu"]).max())
    assert out["max_rates_card_vs_cpu"] <= 1e-9 * max(
        1.0, float(np.abs(rates["cpu"]).max())), out
    assert np.all(np.isfinite(rates["cuda"])) and np.all(
        rates["cuda"][:, 1] > 0), out["max_rates"]
    # the dense scene at its full size
    t0 = time.perf_counter()
    sc = scene.make_scene("dense", seed=0)
    dist = {d: esdf_from_occupancy(torch.as_tensor(sc.occupancy, device=d),
                                   torch.zeros(2), sc.res).dist.cpu()
            for d in ("cpu", "cuda")}
    blocked = dist["cuda"].numpy() < 0.3
    start = frontend.world_to_grid(np.asarray(sc.clear_center), sc.lower,
                                   sc.res)
    free = np.argwhere(~blocked)
    far = np.abs(free - start).max(1)
    goal = tuple(free[(far > 100) & (far < 250)][0])
    cells = frontend.jps_search(blocked.astype(np.uint8), start, goal)
    gap = (dist["cuda"] - dist["cpu"]).abs()
    out["scene"] = {"shape": list(sc.occupancy.shape),
                    "occupied_frac": float(sc.occupancy.mean()),
                    "esdf_equal": bool(torch.equal(dist["cuda"],
                                                   dist["cpu"])),
                    "esdf_cells_differing": int((gap > 0).sum()),
                    "esdf_max_abs_err": float(gap.max()),
                    "jps_cells": None if cells is None else len(cells),
                    "wall_s": time.perf_counter() - t0}
    print("dense scene: " + json.dumps(out["scene"]), flush=True)
    assert sc.occupancy.shape == (500, 500) and out["scene"]["esdf_equal"]
    assert cells is not None and len(cells) >= 2, out["scene"]
    # the camera's voxel map through octomap files
    st, lower, res = card_map
    occ = vm.occupied_mask(st).cpu().numpy()
    known = st.known.cpu().numpy()
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke_octomap")
    os.makedirs(d, exist_ok=True)
    sizes = {}
    for ext, reader in (("bt", octomap_io.read_bt),
                        ("ot", octomap_io.read_ot)):
        path = os.path.join(d, f"camera_map.{ext}")
        octomap_io.write_voxel_map(path, st, lower, res)
        o2, k2 = reader(path).to_dense(lower, occ.shape)
        assert np.array_equal(k2, known) and np.array_equal(o2, occ), ext
        sizes[ext] = os.path.getsize(path)
    out["octomap"] = {"voxels_known": int(known.sum()),
                      "voxels_occupied": int(occ.sum()), "bytes": sizes}
    # the native bus against the Python one, in this process
    msg = EnvObs().pack()
    with NativeUdpBus() as nat, UdpBus() as py:
        nat.add_peer("127.0.0.1", py.address[1])
        py.add_peer("127.0.0.1", nat.address[1])
        py.subscribe("/env_obs", lambda m: py.publish("/env_obs_echo", m))
        import threading
        got = threading.Event()
        nat.subscribe("/env_obs_echo", lambda m: got.set())
        rtt = []
        for i in range(220):
            got.clear()
            t0 = time.perf_counter()
            nat.publish("/env_obs", msg)
            assert got.wait(5.0), f"round trip {i} lost"
            rtt.append(time.perf_counter() - t0)
        back = np.asarray(nat.latest("/env_obs_echo"))
        assert back.dtype == msg.dtype and np.array_equal(back, msg)
    us = 1e6 * np.asarray(rtt[20:])
    out["bus_round_trip_host_us"] = {"p50": float(np.percentile(us, 50)),
                                     "p99": float(np.percentile(us, 99)),
                                     "n": len(us), "bytes": msg.nbytes}
    print("last modules on the card: " + json.dumps(out), flush=True)
    return out


def mesh_and_last_modules(hist_ref, params_ref, push_plan, card_map):
    """Phase 10: a one-rank NCCL mesh on the card (`make_mesh(1)`) under
    the tracking tick, the env step, the mission fleet and training, then
    the last modules.  The profiler's kernel count and busy share are
    printed, not held (a trace that sees no kernel is a finding about
    the profiler here).  Returns the kernels' launches in the mesh
    mission and in the phase's tracking ticks."""
    import torch.distributed as dist
    from alore_legged_manipulator_tpu_torch.parallel.mesh import make_mesh
    child = start_unsharded_mission()
    t0 = time.perf_counter()
    mesh = make_mesh(1)
    backend = dist.get_backend(mesh.group)
    print(f"mesh: {mesh.size} rank(s) on {mesh.device}, backend {backend}, "
          f"opened in {time.perf_counter() - t0:.2f} s", flush=True)
    assert backend == "nccl", backend
    try:
        tick = mesh_tick_and_env(mesh)
        _, launches = mesh_mission(mesh, child)
        mesh_training(mesh, hist_ref, params_ref)
    finally:
        dist.destroy_process_group()
        if child[0].poll() is None:
            child[0].kill()
            child[0].wait()
    last_modules_on_card(push_plan, card_map)
    return launches, tick["kernel_launches"]


def mesh_probe():
    """Phase 10 alone, with what it reuses made first: the seed-0
    training run cut to 2 iterations, the mapped arrangement's push (its
    plan) and the camera's card vs CPU check (its voxel map):
    `python3 -c "import chip_smoke; chip_smoke.mesh_probe()"`."""
    from alore_legged_manipulator_tpu_torch.ops import wavefront_cuda as wfc
    from alore_legged_manipulator_tpu_torch.rl.runner import train
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    set_precision_policy()
    wfc.build()
    models = _init_models()
    _, hist = train(_train_cfg(iterations=2), models=models)
    params = {k: {n: v.clone() for n, v in m.state_dict().items()}
              for k, m in zip(("actor", "critic"), models)}
    _, _, plan = arrangement_on_card()
    _, card_map = camera_card_vs_cpu()
    _phase("mesh and the last modules")
    t0 = time.perf_counter()
    mesh_and_last_modules(hist, params, plan, card_map)
    print(f"phase 10 wall time: {time.perf_counter() - t0:.1f} s; probe "
          f"wall time: {time.perf_counter() - T_START:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 11: the compiled reference's goldens on the card
# ---------------------------------------------------------------------------

# ADMM iterations of the LTV goldens' solution and ticks
# (tests/test_torch_ltv_mpc.py's)
LTV_QP_ITERS = 4000
LTV_TICK_ITERS = {torch.float64: 4000, torch.float32: 2000}
LTV_F32_CASES = ("curve_d1", "tightturn_d2", "yawwrap_d1")
# tests/test_torch_nmpc.py's three closed loops against the ACADO trace:
# (label, dtype, tolerance, NmpcConfig fields)
ACADO_LOOPS = (("f64", torch.float64, 1e-3, {}),
               ("f32", torch.float32, 2e-3, {}),
               ("f64 dense assoc rk4", torch.float64, 1e-3,
                dict(qp_mode="dense", condense_mode="assoc",
                     integrator="rk4")))


def ltv_golden_checks(name, device="cuda"):
    """One of the five LTV goldens (tests/golden/ltv) through the port at
    tests/test_torch_ltv_mpc.py's tolerances: `_build_qp` against the
    reference's QP (1e-12, numpy's default rtol 1e-7), the ADMM solution
    after 4000 iterations (2e-5), the float64 tick (command 5e-5,
    sequence 2e-4, delay buffer 5e-5) and, for LTV_F32_CASES, the
    float32 tick (command 5e-3)."""
    from alore_legged_manipulator_tpu_torch.control import ltv_mpc as tl
    from alore_legged_manipulator_tpu_torch.ops.qp import qp_admm_general
    from alore_legged_manipulator_tpu_torch.ops.qp_admm_cuda import (
        admm_pattern)
    from alore_legged_manipulator_tpu_torch.utils.angles import (
        smooth_yaw_sequence)
    from tests import torch_golden_io as gio

    def t(a, dtype=torch.float64):
        return torch.tensor(np.asarray(a)[None], dtype=dtype, device=device)

    def host(x):
        return x[0].to(torch.float64).cpu().numpy()
    fields, state, xref, dref, output, buff, g = gio.ltv_case(name)
    cfg = tl.LtvMpcConfig(**fields)
    db = np.zeros((max(cfg.delay_num, 1), 2))
    db[:buff.shape[0]] = buff
    # the reference smooths the yaw reference before the tick
    xref = xref.copy()
    xref[3] = host(smooth_yaw_sequence(t(state[2]), t(xref[3])))
    carry = tl.LtvMpcCarry(output=t(output), delay_buff=t(db))
    xbar = tl._rollout(t(state[:3]), carry.output, cfg)
    qp = tl._build_qp(xbar, t(xref), t(dref), carry, cfg)
    checks = [gio.deviation(f"{name} QP {key}", host(a), g[key], 1e-12, 1e-7)
              for a, key in zip(qp, ("P", "q", "A", "lb", "ub"))]
    # the float64 dense pattern of this A does not fit a block: the
    # kernel reads the golden's own nonzeros
    sol, _ = qp_admm_general(*(t(g[k]) for k in ("P", "q", "A", "lb", "ub")),
                             iters=LTV_QP_ITERS, rho=0.4,
                             pattern=admm_pattern(t(g["A"])[0] != 0))
    checks.append(gio.deviation(f"{name} ADMM solution", host(sol),
                                g["sol0"], 2e-5, 1e-7))
    for dtype in (torch.float64, torch.float32):
        if dtype == torch.float32 and name not in LTV_F32_CASES:
            continue
        c = tl.LtvMpcCarry(output=t(output, dtype), delay_buff=t(db, dtype))
        new, cmd = tl.ltv_mpc_tick(
            c, t(state[:3], dtype), t(xref, dtype), t(dref, dtype),
            cfg._replace(admm_iters=LTV_TICK_ITERS[dtype]))
        lbl = f"{name} tick {str(dtype)[6:]}"
        if dtype == torch.float32:
            checks.append(gio.deviation(lbl + " command", host(cmd),
                                        g["cmd"], 5e-3, 1e-7))
            continue
        checks += [
            gio.deviation(lbl + " command", host(cmd), g["cmd"], 5e-5, 1e-7),
            gio.deviation(lbl + " sequence", host(new.output), g["out"], 2e-4,
                          1e-7)]
        if cfg.delay_num > 0:
            checks.append(gio.deviation(
                lbl + " delay buffer",
                host(new.delay_buff[:, -cfg.delay_num:]), g["buff_after"],
                5e-5, 1e-7))
    return checks


def acado_circle_checks(loop, device="cuda"):
    """tests/golden/acado_nmpc_circle.txt: the reference NMPC's 120-tick
    closed loop on a 2 m circle at 1 m/s, replayed through the port's
    `nmpc_rti_step` and RK4 plant as tests/test_torch_nmpc.py does, in
    one of ACADO_LOOPS: trajectory and the steady-state (tick >= 40)
    commands within 1e-3 (f64) / 2e-3 (f32), every command within 0.6,
    wheel bounds held."""
    from alore_legged_manipulator_tpu_torch.control import nmpc as tn
    from alore_legged_manipulator_tpu_torch.core.dynamics import (
        ICRParams, wheel_speeds_from_flat)
    from tests import torch_golden_io as gio
    golden = gio.acado_circle()
    xs_ref, us_ref = golden[:, 1:4], golden[:, 4:6]
    icr = ICRParams(yr=-0.3, yl=0.3, xv=0.2)
    w, v = 0.5, 1.0
    vl, vr = wheel_speeds_from_flat(w, v, icr)
    label, dtype, tol, mode = loop
    cfg = tn.NmpcConfig(delay_num=0, **mode)
    x = torch.tensor([[0.05, -0.10, 0.30]], dtype=dtype, device=device)
    carry = tn.nmpc_init(cfg, x, dtype)
    steps = torch.arange(1, cfg.horizon + 2, dtype=dtype, device=device)
    xs, us = [], []
    for k in range(golden.shape[0]):
        ts = (k + steps) * cfg.dt
        yaw = w * ts
        rx = v / w * torch.sin(yaw) - icr.xv * (torch.cos(yaw) - 1.0)
        ry = -v / w * (torch.cos(yaw) - 1.0) - icr.xv * torch.sin(yaw)
        ref_x = torch.stack([rx, ry, yaw])[None]
        ref_u = torch.stack([torch.full_like(ts, vr),
                             torch.full_like(ts, vl)])[None]
        carry, u_cmd, _, _ = tn.nmpc_rti_step(carry, x, ref_x, ref_u, icr,
                                              cfg)
        xs.append(x[0])
        us.append(u_cmd[0])
        x = tn.rk4_step(x, u_cmd, icr, cfg.dt)
    xs = torch.stack(xs).to(torch.float64).cpu().numpy()
    us = torch.stack(us).to(torch.float64).cpu().numpy()
    lbl = f"ACADO circle {label}"
    return [
        gio.bound(lbl + " position",
                  np.linalg.norm(xs[:, :2] - xs_ref[:, :2], axis=1).max(),
                  tol),
        gio.bound(lbl + " yaw", np.abs(xs[:, 2] - xs_ref[:, 2]).max(), tol),
        gio.bound(lbl + " steady commands",
                  np.abs(us[40:] - us_ref[40:]).max(), tol),
        gio.bound(lbl + " commands", np.abs(us - us_ref).max(), 0.6),
        gio.bound(lbl + " wheel bound", np.abs(us).max(), 3.0 + 1e-6)]


def fusion_checks(name, device="cuda"):
    """One of the three fusion goldens of the compiled reference SDFmap
    (tests/golden/fusion, fusion_cirsup, fusion_persp) through the
    port's `world/lidar.py` as tests/test_torch_lidar.py replays them:
    every grid cell's label equal, log-odds within 1e-5 (the perspective
    branch leaves them at their initial values)."""
    from alore_legged_manipulator_tpu_torch.world import lidar as tl
    from tests import torch_golden_io as gio
    (nx, ny, res, rng, n_beams, cir_sup, persp), scans, grid, lo = \
        gio.fusion_case(name)
    lcfg = tl.LidarConfig(n_beams=n_beams, fov_rad=2.0 * np.pi,
                          max_range=rng)
    ocfg = tl.OccupancyConfig()
    st = tl.occupancy_init((nx, ny), ocfg, device=device)
    init_lo = st.log_odds.clone()
    lower = torch.zeros(2, device=device)
    res32 = torch.tensor(res, dtype=torch.float32, device=device)

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)
    for i, scan in enumerate(scans):
        pose = t(scan[0], torch.float32)
        if persp:
            st = tl.occupancy_update_perspective(
                st, lower, res32, pose, t(scan[1]),
                torch.ones(scan[1].shape[0], dtype=torch.bool,
                           device=device), rng)
        else:
            # the reference's static counter fires cirSup on scans 2, 4, ...
            st = tl.occupancy_update(st, lower, res32, pose, t(scan[1]),
                                     t(scan[2]), lcfg, ocfg,
                                     cir_sup=cir_sup and i % 2 == 1)
    log_odds = st.log_odds.double().cpu().numpy()
    checks = [gio.deviation(f"{name} grid labels",
                            st.grid.cpu().numpy().astype(int), grid, 0.0),
              gio.deviation(f"{name} log-odds", log_odds, lo, 1e-5)]
    if persp:
        checks.append(gio.deviation(f"{name} log-odds unchanged", log_odds,
                                    init_lo.double().cpu().numpy(), 0.0))
    return checks


def _bind_repo_tests():
    """Make `tests` this checkout's tests/ directory, a namespace
    package, for the golden readers and checks imported from it: a
    regular package of that name installed on the card's machine would
    otherwise shadow it."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    mod = sys.modules.get("tests")
    if mod is None or list(getattr(mod, "__path__", [])) != [path]:
        mod = types.ModuleType("tests")
        mod.__path__ = [path]
        sys.modules["tests"] = mod


def golden_parts(device="cuda"):
    """Phase 11's work as (family, part, function returning its checks),
    each at its JAX test's tolerances (float64, and float32 where that
    test has a float32 band)."""
    from alore_legged_manipulator_tpu_torch.solvers import minco as tm
    _bind_repo_tests()
    from tests import test_torch_golden_backend as gb
    from tests import test_torch_golden_ekf as ge
    from tests import test_torch_golden_esdf as gs
    from tests import test_torch_golden_plant as gp
    from tests import test_torch_golden_trajanal as gt
    from tests import torch_golden_io as gio

    def minco():
        prev = tm.SMALL_N_SOLVER
        try:
            return [c for case in gio.MINCO_CASES for solver in gb.SOLVERS
                    for dtype in (torch.float64, torch.float32)
                    for c in gb.minco_checks(case, solver, dtype, device)]
        finally:
            tm.set_small_n_solver(prev)
    parts = [("backend MINCO (lu, thomas_scan, cr, dense)", "all", minco)]
    parts += [("backend stage-1/2 costs and gradients", n,
               lambda n=n: gb.stage_cost_checks(n, device)
               + gb.stage2_f32_checks(n, device))
              for n in gio.BACKEND_SCENARIOS]
    parts += [
        ("trajanal", "all", lambda: [c for n in gio.TRAJANAL_CASES
                                     for c in gt.trajanal_checks(n, device)]),
        ("ekf", "all", lambda: [c for n in gio.EKF_CASES
                                for c in ge.ekf_checks(n, device)]
         + ge.ekf_f32_checks(device)),
        ("esdf field and bilinear", "all",
         lambda: [c for k in gio.ESDF_CASES
                  for c in gs.field_checks(k, device)
                  + gs.bilinear_checks(k, device)]),
        ("plant", "all", lambda: [c for n in gio.PLANT_CASES
                                  for dtype in (torch.float64, torch.float32)
                                  for c in gp.plant_checks(n, dtype, device)])]
    parts += [("fusion", n, lambda n=n: fusion_checks(n, device))
              for n in gio.FUSION_CASES]
    parts += [("ACADO NMPC circle", loop[0],
               lambda loop=loop: acado_circle_checks(loop, device))
              for loop in ACADO_LOOPS]
    parts += [("LTV-MPC QP, solution, tick", n,
               lambda n=n: ltv_golden_checks(n, device))
              for n in gio.LTV_CASES]
    return parts


# the parts that run in child processes beside the parent, a group a
# child: each group dispatches 0.80-0.83M operations, the parent's share
# 1.0M (counted on the CPU); in one process the phase would take 60-90 s
# at the card host's 10-16 us a dispatch
GOLDEN_CHILDREN = ((("ACADO NMPC circle", "f64"),),
                   (("ACADO NMPC circle", "f32"),),
                   (("ACADO NMPC circle", "f64 dense assoc rk4"),
                    ("LTV-MPC QP, solution, tick", "coldstart_d1")),
                   (("LTV-MPC QP, solution, tick", "curve_d1"),),
                   (("LTV-MPC QP, solution, tick", "tightturn_d2"),),
                   (("LTV-MPC QP, solution, tick", "yawwrap_d1"),))


def run_golden_parts(keys, device="cuda"):
    """Run the parts named by `keys` ((family, part) pairs): a list of
    {family, part, checks, ms}, each part's wall ended by a synchronize."""
    out = []
    for family, part, fn in golden_parts(device):
        if (family, part) not in keys:
            continue
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        checks = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        out.append({"family": family, "part": part, "checks": checks,
                    "ms": 1e3 * (time.perf_counter() - t0)})
    return out


def golden_child(index, out_path, device="cuda"):
    """One child of phase 11: the parts of GOLDEN_CHILDREN[index], its
    result written to `out_path` as JSON."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)
    set_precision_policy()
    torch.set_num_threads(1)
    res = run_golden_parts(GOLDEN_CHILDREN[index], device)
    with open(out_path, "w") as f:
        json.dump(res, f)


def reference_goldens_on_card(device="cuda"):
    """Phase 11: every family of the compiled reference's goldens that
    the port's CPU tests read, replayed on the card by the same code
    (tests/test_torch_golden_*.py's checks over tests/torch_golden_io.py's
    readers; the LTV and ACADO goldens as tests/test_torch_ltv_mpc.py and
    tests/test_torch_nmpc.py replay them) with the JAX tests' tolerances.
    The launch-bound LTV and ACADO parts run in child processes
    (GOLDEN_CHILDREN) beside the parent's share.  One line a family: its
    check count, the check nearest its tolerance (deviation
    and tolerance) and the summed wall ms of its parts; any check past
    its tolerance fails the phase after the lines are printed."""
    import shutil
    import tempfile
    _bind_repo_tests()
    from tests import torch_golden_io as gio
    tmp = tempfile.mkdtemp(prefix="goldens-")
    here = os.path.dirname(os.path.abspath(__file__))
    children = []
    try:
        for i in range(len(GOLDEN_CHILDREN)):
            out_path = os.path.join(tmp, f"child{i}.json")
            log = open(os.path.join(tmp, f"child{i}.log"), "w")
            code = (f"import chip_smoke; chip_smoke.golden_child({i}, "
                    f"{out_path!r}, {device!r})")
            children.append((subprocess.Popen(
                [sys.executable, "-c", code], cwd=here, stdout=log,
                stderr=subprocess.STDOUT), out_path, log))
        in_children = {k for group in GOLDEN_CHILDREN for k in group}
        own = [(f, p) for f, p, _ in golden_parts(device)
               if (f, p) not in in_children]
        results = run_golden_parts(own, device)
        for i, (proc, out_path, log) in enumerate(children):
            rc = proc.wait(timeout=600)
            log.close()
            if rc != 0:
                with open(log.name) as f:
                    print(f.read()[-4000:], flush=True)
                raise AssertionError(f"golden child {GOLDEN_CHILDREN[i]} "
                                     f"exited {rc}")
            with open(out_path) as f:
                results += json.load(f)
    finally:
        for proc, _, log in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    failed = []
    for family in dict.fromkeys(r["family"] for r in results):
        parts = [r for r in results if r["family"] == family]
        checks = [c for r in parts for c in r["checks"]]
        lbl, dev, tol = gio.worst(checks)
        row = {"family": family, "checks": len(checks), "worst": lbl,
               "deviation": dev, "tolerance": tol,
               "ms": sum(r["ms"] for r in parts)}
        print("golden: " + json.dumps(row), flush=True)
        failed += [c for c in checks if not c[1] <= c[2]]
    gio.assert_checks(failed)


def golden_probe():
    """Phase 11 alone:
    `python3 -c "import chip_smoke; chip_smoke.golden_probe()"`."""
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    set_precision_policy()
    _phase("reference goldens on the card")
    t0 = time.perf_counter()
    reference_goldens_on_card()
    print(f"phase 11 wall time: {time.perf_counter() - t0:.1f} s",
          flush=True)

# ---------------------------------------------------------------------------
# phase 12: the port's entry points
# ---------------------------------------------------------------------------

# the JAX example's visit orders and costs (examples/mission_validation.py
# at its defaults: 4 tasks, 5 trials, seed 0), equal to the port's on the
# CPU (tests/test_torch_example_validation.py): (greedy order, greedy
# cost, branch-and-bound order, branch-and-bound cost) a trial
MISSION_VALIDATION_JAX = (
    ([2, 8, 1, 7, 4, 5, 3, 6], 32.92081528017131,
     [2, 6, 4, 8, 1, 5, 3, 7], 39.93380951166243),
    ([3, 5, 4, 7, 1, 8, 2, 6], 26.57350647362943,
     [3, 7, 4, 8, 1, 5, 2, 6], 28.284776310850237),
    ([2, 5, 4, 6, 1, 8, 3, 7], 21.579393923934006,
     [1, 5, 2, 6, 4, 8, 3, 7], 26.310764773832478),
    ([4, 7, 2, 6, 3, 5, 1, 8], 31.299494936611666,
     [3, 7, 2, 6, 4, 8, 1, 5], 32.53086578651015),
    ([3, 6, 1, 5, 4, 7, 2, 8], 26.6350288425444,
     [3, 7, 2, 6, 1, 5, 4, 8], 34.38061325481598))
# the JAX example examples/planner_sim.py at its defaults on the CPU
# (float32, noise 0.01), as it prints them (m); the port's run must land
# within PLANNER_SIM_BAND of each: 2x the largest value the JAX example
# itself printed under 1e-4 m moves of its start (goal distance
# 0.003-0.011, mean 0.013-0.015, p95 0.026-0.027)
PLANNER_SIM_JAX = {"goal_dist": 0.006, "err_mean": 0.013, "err_p95": 0.027}
PLANNER_SIM_BAND = 0.02
# the bounds of tests/test_arrangement.py (max final error, p95) on each
# plant, which the example's runs are held to
ARRANGEMENT_BOUNDS = {False: (0.1, 0.2), True: (0.15, 0.25)}
# phase 12's child processes: a name and the runs of the example twins
# (module of alore_legged_manipulator_tpu_torch.examples, flags), each
# child started after phase 1 and joined before the result lines
EXAMPLE_CHILDREN = (
    ("arrangement_3_objects",
     (("arrangement_mission", ["--objects", "3"]),)),
    ("arrangement_2_objects_physics",
     (("arrangement_mission", ["--objects", "2", "--physics"]),)),
    ("planner_sim_then_deploy",
     (("planner_sim", []),
      ("train_and_deploy_highlevel",
       ["--physics", "--load-ckpt",
        os.path.join("examples", "artifacts", "ckpt_physics_6000")]))))
EXAMPLE_CHILD_TIMEOUT_S = 900


def _kill_children(children):
    for _, proc, _, _ in children:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _jsonable(x):
    """`x` with what JSON cannot hold (modules, tensors) left out."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()
                if isinstance(v, (dict, list, tuple, str, int, float, bool,
                                  type(None), np.generic))}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x.item() if isinstance(x, np.generic) else x


def _example_run(module, flags):
    """One example twin's `main` on the card, with host wall time by
    phase (each wrapped call ended by a synchronize), its plans, ticks,
    the dispatched operations of one tick of each plant on its first
    tracked trajectory, and the wavefront kernels' launches (counted
    from 0)."""
    import importlib

    from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams
    from alore_legged_manipulator_tpu_torch.mission import plan_manager as pm
    from alore_legged_manipulator_tpu_torch.runtime import arrangement as arr
    from alore_legged_manipulator_tpu_torch.runtime.closed_loop import (
        LoopConfig)
    ex = importlib.import_module(
        f"alore_legged_manipulator_tpu_torch.examples.{module}")
    clock, tracked = PhaseClock(), []

    def track(owner, name, ticks_at):
        fn = getattr(owner, name)

        def recorded(*a, **kw):
            tracked.append((a[0], a[ticks_at]))
            return fn(*a, **kw)
        setattr(owner, name, recorded)
        clock.wrap(owner, name, "tracking")
    if module in ("arrangement_mission", "planner_sim"):
        clock.wrap(pm, "plan_frontend", "front_end")
        clock.wrap(pm, "esdf_from_occupancy", "esdf_updates")
        clock.wrap(pm, "plan_backend", "back_end")
        clock.wrap(pm, "build_tracked_traj", "tracked_traj")
    if module == "arrangement_mission":
        clock.wrap(arr, "jps_search", "ordering_and_approach_jps")
        track(arr, "simulate_tracking", 2)
        track(arr, "simulate_tracking_physics", 1)
    elif module == "planner_sim":
        track(ex, "simulate_tracking", 2)
    else:
        clock.wrap(ex, "restore", "restore")
        clock.wrap(ex, "tracking_eval", "tracking_eval")
        clock.wrap(ex, "bus_mission", "bus_mission")
    reset_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = ex.main(flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        clock.restore()
    run = {"example": module, "flags": flags, "result": _jsonable(result),
           "wall_s": wall, "wall_by_phase_s": clock.report(wall),
           "kernel_launches": kernel_launches()}
    if tracked:
        run["plans"] = clock.calls.get("back_end", 0)
        run["ticks"] = int(sum(t for _, t in tracked))
        run["dispatches_per_tick"] = ops_per_tick(
            tracked[0][0], ICRParams(-0.3, 0.3, 0.2), LoopConfig())
    return run


def example_child(index, out_path):
    """One child of phase 12: the runs of EXAMPLE_CHILDREN[index] on the
    card, one `example:` JSON line each; written to `out_path` as JSON."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(1)
    name, runs = EXAMPLE_CHILDREN[index]
    out = []
    for module, flags in runs:
        out.append(_example_run(module, flags))
        print("example: " + json.dumps({"child": name, **out[-1]}),
              flush=True)
    with open(out_path, "w") as f:
        json.dump(out, f)


def start_example_children():
    """Starts every child of EXAMPLE_CHILDREN; returns [(name, process,
    output path, log path)]."""
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "chip_smoke_examples")
    os.makedirs(out_dir, exist_ok=True)
    children = []
    for i, (name, _) in enumerate(EXAMPLE_CHILDREN):
        out, log = (os.path.join(out_dir, f"{name}.{ext}")
                    for ext in ("json", "log"))
        for p in (out, log):
            if os.path.exists(p):
                os.remove(p)
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke; "
                 f"chip_smoke.example_child({i}, {out!r})"],
                cwd=root, stdout=f, stderr=subprocess.STDOUT)
        children.append((name, proc, out, log))
    return children


def join_example_children(children):
    """Waits for each child (EXAMPLE_CHILD_TIMEOUT_S from the start of the
    wait, each), prints its runs, and fails if one exited non-zero or
    timed out; a child still running on the way out is killed.  Returns
    {child name: its runs}."""
    t_end = time.perf_counter() + EXAMPLE_CHILD_TIMEOUT_S
    runs = {}
    try:
        for name, proc, out, log in children:
            rc = proc.wait(timeout=max(t_end - time.perf_counter(), 1.0))
            with open(log) as f:
                text = f.read()
            if rc != 0:
                print(text[-6000:], flush=True)
                raise AssertionError(f"example child {name} exited {rc}")
            with open(out) as f:
                runs[name] = json.load(f)
            for r in runs[name]:
                print("example: " + json.dumps({"child": name, **r}),
                      flush=True)
    finally:
        _kill_children(children)
    return runs


def check_example_runs(runs):
    """Holds the children's outcomes: each arrangement delivers every
    object inside tests/test_arrangement.py's bounds for its plant, the
    planner simulation lands inside PLANNER_SIM_BAND of the JAX
    example's CPU run, the deploy run's eval inside the JAX package's
    value + 0.05 per axis and its mission DELIVERED within 0.5 m."""
    for name, physics, n in (("arrangement_3_objects", False, 3),
                             ("arrangement_2_objects_physics", True, 2)):
        (r,) = runs[name]
        res = r["result"]
        err_max, p95_max = ARRANGEMENT_BOUNDS[physics]
        assert len(res["order"]) == n and all(res["delivered"]), res
        assert max(res["final_object_err"]) < err_max, res
        assert res["push_tracking_err_p95"] < p95_max, res
    ps, deploy = (r["result"] for r in runs["planner_sim_then_deploy"])
    for k, ref in PLANNER_SIM_JAX.items():
        assert np.isfinite(ps[k]) and abs(ps[k] - ref) <= PLANNER_SIM_BAND, \
            (k, ps[k], ref)
    for a, ref in zip(deploy["eval_err"], JAX_EVAL_ERR):
        assert np.isfinite(a) and a <= ref + 0.05, (deploy["eval_err"],
                                                     JAX_EVAL_ERR)
    assert deploy["ok"] and deploy["mission_err"] < 0.5, deploy


def entry_on_card(smi):
    """`entry()`'s tick on the card against the same tick on the CPU
    (f32, u_cmd within 1e-4, tests/test_torch_nmpc.py's tolerance), and
    its median wall over repeats, each ended by a synchronize (a note,
    not a bench).  Returns the summary."""
    from alore_legged_manipulator_tpu_torch import entry as ent
    fn, args = ent.entry()
    fn_cpu, args_cpu = ent.entry(device="cpu")
    with torch.no_grad():
        err = float((fn(*args).cpu() - fn_cpu(*args_cpu)).abs().max())
        times = []
        for k in range(23):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            if k >= 3:
                times.append(time.perf_counter() - t0)
    summary = {"batch": int(args[0].shape[0]),
               "horizon": int(args[1].shape[1]), "max_abs_err": err,
               "tick_ms_median": 1e3 * float(np.median(times)),
               "tick_ms_min": 1e3 * min(times),
               "tick_ms_max": 1e3 * max(times), "repeats": len(times),
               "card": smi}
    print("entry(): RTI tick, card vs CPU: " + json.dumps(summary),
          flush=True)
    assert np.isfinite(err) and err <= 1e-4, err
    return summary


def mission_validation_on_card():
    """examples/mission_validation.py's twin at its defaults: orders and
    costs equal to the JAX example's (MISSION_VALIDATION_JAX)."""
    from alore_legged_manipulator_tpu_torch.examples import (
        mission_validation)
    got = mission_validation.main([])["trials"]
    assert len(got) == len(MISSION_VALIDATION_JAX)
    for t, (g_order, g_cost, b_order, b_cost) in zip(got,
                                                     MISSION_VALIDATION_JAX):
        assert (t["greedy_order"], t["greedy_cost"], t["bnb_order"],
                t["bnb_cost"]) == (g_order, g_cost, b_order, b_cost), t
    print(f"mission_validation: {len(got)} trials, orders and costs equal "
          "to the JAX example's", flush=True)


def entry_points_on_card(smi, children):
    """Phase 12: `entry()` and `mission_validation` in this process, each
    with its kernel launches counted from 0, then the example children
    (`start_example_children`) joined and held.  Returns (launches of
    entry, launches of mission_validation, the children's runs)."""
    reset_launches()
    entry_on_card(smi)
    launches_entry = kernel_launches()
    # one K3 launch for each of entry_on_card's 24 RTI ticks on the card
    assert launches_entry["nmpc_feedback"] == 24, launches_entry
    reset_launches()
    mission_validation_on_card()
    launches_validation = kernel_launches()
    runs = join_example_children(children)
    check_example_runs(runs)
    return launches_entry, launches_validation, runs


def entry_points_probe():
    """Phase 12 alone:
    `python3 -c "import chip_smoke; chip_smoke.entry_points_probe()"`."""
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    set_precision_policy()
    children = start_example_children()
    atexit.register(_kill_children, children)
    _phase("the port's entry points")
    t0 = time.perf_counter()
    entry_points_on_card(smi, children)
    print(f"phase 12 wall time: {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# 13. the throughput drivers (bench.py's twin and the example benches'),
#     every line once at cut sizes
# ---------------------------------------------------------------------------

# the cut sizes of phase 13, as arguments of each line's function, and
# printed as `cut` beside each of its `bench:` lines (the full sizes are
# the JAX benches' defaults, run by `python -m
# alore_legged_manipulator_tpu_torch.bench` and the example twins)
BENCH_CUTS = {
    "nmpc_rti": dict(B=16384, chain=1, iters=1),
    "nmpc_latency": dict(chain=2, calls=2),
    "wavefront": dict(B=16384, reps=1),
    "closed_loop": dict(fleet=1024, chain=2, iters=1),
    "physics_env": dict(B=4096, chain=2, reps=1),
    "mapping": dict(B=4, K=2, reps=1),
    "frontend": dict(sizes=[1024], calls=1),
    # the child's: each a launch-bound B=1-2 plan or a whole mission
    "backend": dict(B=2, chain=1, lat_goals=1, reps=1, lat_reps=1,
                    warmup=False),
    "backend_fleet": dict(B=2, reps=1, first_call=False),
    "mission_legs": dict(B=2, n_ticks=20, reps=1, first_call=False),
    "mission_fleet": dict(B=2, K=1, corr=300, mode="redispatch", iters=1,
                          approach_ticks=300, push_ticks=400,
                          first_call=False),
}
BENCH_CHILD_TIMEOUT_S = 600


def _bench_run(name, fn):
    """One line at its cut size with the wavefront kernels' launches
    counted from 0: (line, out, launches)."""
    reset_launches()
    t0 = time.perf_counter()
    line, out = fn(**BENCH_CUTS[name], device="cuda")
    torch.cuda.synchronize()
    return line, out, kernel_launches(), time.perf_counter() - t0


def bench_child(out_path):
    """The child of phase 13: the launch-bound lines (back end, mission
    legs, mission fleet) at their cut sizes; one `bench:` JSON line each,
    written to `out_path` as JSON."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(1)
    from alore_legged_manipulator_tpu_torch import bench as tb
    from alore_legged_manipulator_tpu_torch.examples import (
        bench_backend, bench_mission_fleet, bench_mission_legs)
    runs = {}
    for name, fn in (("backend", tb.backend_line),
                     ("backend_fleet", bench_backend.backend_fleet_line),
                     ("mission_legs", bench_mission_legs.legs_line),
                     ("mission_fleet",
                      bench_mission_fleet.mission_fleet_line)):
        line, out, launches, wall = _bench_run(name, fn)
        runs[name] = {"cut": BENCH_CUTS[name], "line": line,
                      "out": _jsonable(
                          {k: (v.tolist() if isinstance(v, np.ndarray)
                               else v) for k, v in out.items()}),
                      "launches": launches, "wall_s": wall}
        print("bench: " + json.dumps({"name": name, **runs[name]}),
              flush=True)
    with open(out_path, "w") as f:
        json.dump(runs, f)


def start_bench_child():
    """Starts the child of phase 13; returns [(name, process, output
    path, log path)] as `start_example_children` does."""
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "chip_smoke_examples")
    os.makedirs(out_dir, exist_ok=True)
    out, log = (os.path.join(out_dir, f"bench_child.{ext}")
                for ext in ("json", "log"))
    for p in (out, log):
        if os.path.exists(p):
            os.remove(p)
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke.bench_child({out!r})"],
            cwd=root, stdout=f, stderr=subprocess.STDOUT)
    return [("bench_child", proc, out, log)]


def join_bench_child(child):
    """Waits for the child of phase 13 (BENCH_CHILD_TIMEOUT_S), fails if
    it exited non-zero; returns its runs."""
    (name, proc, out, log), = child
    try:
        rc = proc.wait(timeout=BENCH_CHILD_TIMEOUT_S)
    finally:
        _kill_children(child)
    if rc != 0:
        with open(log) as f:
            print(f.read()[-6000:], flush=True)
        raise AssertionError(f"{name} exited {rc}")
    with open(out) as f:
        return json.load(f)


def bench_kernel_checks(wf, wfc, tb, bf_row):
    """K1 on the first 1024 lanes of the wavefront line's 16384x100x100
    batch and K2 on the front-end line's 1024-lane batch, bit-identical
    to their plain versions, timed with CUDA events beside their bounds;
    K1 also over the whole 16384-lane batch, bit-identical there too.
    Returns {kernel: {label: measurements}}."""
    from alore_legged_manipulator_tpu_torch.ops.wavefront_bench import (
        bound, time_ms)
    blocked = tb.wavefront_bench_map(torch.device("cuda"))
    s, g = tb.wavefront_starts_goals(16384, torch.device("cuda"))
    n = 1024
    occ = blocked.expand(n, *blocked.shape).contiguous().cpu().numpy()
    m_wf = check_kernels(wf, wfc, "bench_wavefront 1024 of 16384x100x100",
                         occ, g[:n].cpu().numpy(), s[:n].cpu().numpy(),
                         path_len=256, iters=5)
    m_fe = check_kernels(wf, wfc, "bench_frontend 1024x100x100", occ,
                         bf_row["goals"].cpu().numpy(),
                         bf_row["starts"].cpu().numpy(), path_len=256,
                         iters=5)
    blk = blocked.expand(16384, *blocked.shape).contiguous()
    B, H, W = blk.shape
    # the whole batch at the line's launch size: the plain version run
    # once (and timed so), K1's field, packed word and sweep counts held
    # to it bit for bit
    d_k, p_k, sweeps = wfc.wavefront_packed_cuda(blk, g, return_sweeps=True)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    d_p, p_p, sweeps_p = wf.wavefront_packed_torch(blk, g,
                                                   return_sweeps=True)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1)
    label = f"bench_wavefront {B}x{H}x{W}"
    assert torch.equal(d_k, d_p), f"{label}: K1 dist differs from plain"
    assert torch.equal(p_k, p_p), f"{label}: K1 packed differs from plain"
    assert torch.equal(sweeps, sweeps_p), f"{label}: K1 sweep counts differ"
    err = float((d_k - d_p).abs().max())
    # the line's other stage, the eager 256-step descent on K1's word
    descent_ms = time_ms(lambda: wf.extract_path_turns(p_k, s, 256), 1,
                         warmup=1)
    del d_k, p_k, d_p, p_p
    ms = time_ms(lambda: wfc.wavefront_packed_cuda(blk, g), 3, warmup=1)
    bound_ms, bound_by = bound(B, H, W, int(sweeps.to(torch.int64).sum()),
                               True)
    full = dict(shape=f"{B}x{H}x{W}", ms=ms, plain_ms=plain_ms,
                max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                descent_ms=descent_ms)
    print(f"{label} wavefront_packed: bit-identical to plain; "
          + json.dumps(full), flush=True)
    return {"wavefront_packed": {"bench_wavefront_1024": m_wf[
                "wavefront_packed"], "bench_wavefront_16384": full},
            "octile_distance_field": {"bench_frontend_1024": m_fe[
                "octile_distance_field"]}}


def check_bench_lines(runs):
    """The non-timing fields of every line: finite, the back end's plans
    on goal (tests/test_backend.py's 1.5x the ALM tolerance) and free of
    collision, the mission fleet's `delivered_frac` at least phase 3's
    floor (0.85), and each kernel of a line's path launched."""
    from alore_legged_manipulator_tpu_torch.planner.backend import (
        BackendConfig)
    goal_tol = BackendConfig().alm.tolerance * 1.5
    for name, r in runs.items():
        for k, v in r["line"].items():
            if isinstance(v, float):
                assert np.isfinite(v), (name, k, v)
    out = runs["nmpc_rti"]["out"]
    assert np.isfinite(out["checksum"]), out
    assert np.isfinite(runs["nmpc_latency"]["out"]["checksum"])
    assert runs["wavefront"]["out"]["path_cells"] > 0
    bk = runs["backend"]["out"]
    assert bk["collisions"] == 0 and bk["goal_err_max"] < goal_tol, bk
    assert np.isfinite(bk["lat_checksum"]), bk
    for name in ("backend_fleet", "mission_legs"):
        line = runs[name]["line"]
        assert line["collision_frac"] == 0.0, (name, line)
        assert max(runs[name]["out"]["final_xy_err"]) < goal_tol, (name, line)
    assert runs["mission_fleet"]["line"]["delivered_frac"] >= 0.85, \
        runs["mission_fleet"]["line"]
    assert all(r["n_ok"] == r["B"] for r in runs["frontend"]["rows"])
    for name, kernel in (("wavefront", "wavefront_packed"),
                         ("mission_fleet", "wavefront_packed"),
                         ("frontend", "octile_distance_field"),
                         ("closed_loop", "nmpc_feedback"),
                         ("mission_legs", "nmpc_feedback"),
                         ("mission_fleet", "nmpc_feedback")):
        assert runs[name]["launches"][kernel] >= 1, \
            f"{name}: {kernel} was not launched"
    # the NMPC lines: a warm chain, then one chain a timed repeat, one K3
    # launch an RTI tick
    for name, reps in (("nmpc_rti", "iters"), ("nmpc_latency", "calls")):
        cut = BENCH_CUTS[name]
        assert runs[name]["launches"]["nmpc_feedback"] == \
            cut["chain"] * (1 + cut[reps]), (name, runs[name]["launches"])


def bench_lines_on_card(wf, wfc, child):
    """Phase 13: the quick lines in this process, the kernel comparisons
    at the benches' shapes, then the child's lines joined; every line
    printed as a `bench:` JSON line and held by `check_bench_lines`.
    Returns ({line: launches}, the kernel comparisons)."""
    from alore_legged_manipulator_tpu_torch import bench as tb
    from alore_legged_manipulator_tpu_torch.examples import (
        bench_closed_loop, bench_frontend, bench_mapping, bench_physics_env)
    runs = {}
    for name, fn in (("nmpc_rti", tb.nmpc_rti_line),
                     ("nmpc_latency", tb.nmpc_latency_line),
                     ("wavefront", tb.wavefront_line),
                     ("closed_loop", bench_closed_loop.closed_loop_line),
                     ("physics_env", bench_physics_env.physics_env_line),
                     ("mapping", bench_mapping.mapping_line)):
        line, out, launches, wall = _bench_run(name, fn)
        if name == "physics_env":       # its line is the JAX bench's text
            line, out = {"text": line, **{k: v for k, v in out.items()
                                          if k != "state"}}, {}
        out = {k: float(v) for k, v in out.items()
               if isinstance(v, (int, float))}
        runs[name] = {"cut": BENCH_CUTS[name], "line": line, "out": out,
                      "launches": launches, "wall_s": wall}
        print("bench: " + json.dumps({"name": name, **runs[name]}),
              flush=True)
    print(f"nmpc_rti at B=16384: peak memory "
          f"{runs['nmpc_rti']['out']['peak_mem_bytes'] / 2**30:.2f} GiB",
          flush=True)
    reset_launches()
    t0 = time.perf_counter()
    rows = bench_frontend.frontend_rows(**BENCH_CUTS["frontend"],
                                        device="cuda")
    torch.cuda.synchronize()
    runs["frontend"] = {
        "cut": BENCH_CUTS["frontend"], "line": {"rows": [{k: v for k, v in r.items() if k not in (
            "host_flats", "starts", "goals")} for r in rows]},
        "launches": kernel_launches(), "wall_s": time.perf_counter() - t0}
    print("bench: " + json.dumps({"name": "frontend", **runs["frontend"]}),
          flush=True)
    kernels = bench_kernel_checks(wf, wfc, tb, rows[-1])
    t0 = time.perf_counter()
    child_runs = join_bench_child(child)
    print(f"phase 13's child joined after {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, r in child_runs.items():
        print("bench: " + json.dumps({"name": name, **r}), flush=True)
    runs.update(child_runs)
    runs["frontend"]["rows"] = runs["frontend"]["line"]["rows"]
    check_bench_lines(runs)
    return {name: r["launches"] for name, r in runs.items()}, kernels


def bench_probe():
    """Phase 13 alone:
    `python3 -c "import chip_smoke; chip_smoke.bench_probe()"`."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from alore_legged_manipulator_tpu_torch.ops import wavefront as wf
    from alore_legged_manipulator_tpu_torch.ops import wavefront_cuda as wfc
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    set_precision_policy()
    wfc.build()
    child = start_bench_child()
    atexit.register(_kill_children, child)
    _phase("the throughput drivers at cut sizes")
    t0 = time.perf_counter()
    bench_lines_on_card(wf, wfc, child)
    print(f"phase 13 wall time: {time.perf_counter() - t0:.1f} s",
          flush=True)


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
    from alore_legged_manipulator_tpu_torch.ops import (
        nmpc_feedback_cuda as nfc)
    t0 = time.perf_counter()
    so, feedback_log = nfc.build()
    print(f"built {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    from alore_legged_manipulator_tpu_torch.ops import qp_admm_cuda as qac
    t0 = time.perf_counter()
    so, log = qac.build()
    print(f"built {so.name} (K4) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas (K4):", line.strip(), flush=True)
    # the example twins of phase 12 run in child processes beside the
    # phases below; any still running when the script ends is killed
    children = start_example_children()
    atexit.register(_kill_children, children)
    print("phase 12's children started: "
          + ", ".join(name for name, *_ in children), flush=True)
    bench_child_proc = start_bench_child()
    atexit.register(_kill_children, bench_child_proc)
    print("phase 13's child started", flush=True)

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
    k3 = nmpc_feedback_on_card(feedback_log)
    k4 = qp_admm_on_card()

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
    reset_launches()
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
    launches = kernel_launches()
    rounds = len(miss_counts)
    print("launches during the production mission:", json.dumps(launches),
          flush=True)
    assert launches["wavefront_packed"] == K + rounds, \
        f"K1 ran {launches['wavefront_packed']} times, not {K} + {rounds}"
    assert launches["octile_distance_field"] == 1, \
        "K2 did not run once through octile_distance_field"
    assert launches["nmpc_feedback"] > 0, "K3 did not run in the pushes"
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
    # bench.py's mission line (`bench_mission`: the same fleet, profile
    # and rounds) from this run: no warm-up, one timed iteration
    from alore_legged_manipulator_tpu_torch.bench import mission_summary
    print("bench: " + json.dumps({
        "name": "mission", "of": "phase 3's fleet and rounds, no warm-up, "
        "1 timed iteration, no start jitter",
        "line": mission_summary(B, K, [wall_fleet + wall_rounds], res,
                                miss_counts, cfg, corr_ticks,
                                torch.device("cuda")),
        "launches": launches}), flush=True)
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
    launches_ring = ring_fleet(mf, wf, items32, targets32, robot0, esdf,
                               icr, field_m, base)
    leg_phases(mf, items32, targets32, robot0, esdf, icr, cfg,
               push_ticks=LEG_PUSH_TICKS)
    _phase("small fleet: card vs CPU plain")
    small_fleet_card_vs_cpu(items32, targets32, robot0, occ, cfg, icr)

    # ---- 5. the contact plant ----
    _phase("contact-plant fleet B=64 K=1 on the card (compact, corrections)")
    launches_phys, _ = physics_fleet(mf, esdf, icr, cfg.backend)
    _phase("contact plant: card vs CPU")
    physics_card_vs_cpu()
    _phase("lidar-mapped arrangement mission on the card, contact plant "
           f"(first object, plan and first {MAPPED_PUSH_S} s of its push)")
    _, launches_mapped, push_plan = arrangement_on_card()

    # ---- 6. the planner simulation ----
    _phase("planner simulation, LTV-MPC, corridor (perspective)")
    _, launches_ps_ltv = planner_sim_on_card("corridor", PS_LTV_T, "ltv",
                                             (0.15, 0.45))
    _phase("planner simulation, NMPC, corridor (raycast)")
    _, launches_ps_nmpc = planner_sim_on_card(
        "nmpc_corridor_raycast", PS_NMPC_T, "nmpc", (0.2, 1.0))

    # ---- 7. variants on the card ----
    _phase("variants on the card")
    variants_on_card()

    # ---- 8. the trained high-level policy, served ----
    _phase("trained policy: card vs CPU, B=1 latency")
    policy_card_vs_cpu()
    _phase("tracking eval on the contact plant, 256 lanes x 100 steps")
    reset_launches()
    tracking_eval_on_card()
    launches_eval = kernel_launches()
    _phase("bus mission with the trained policy in the loop")
    _, launches_bus = bus_mission_on_card()
    _phase("low-level WBC: card vs CPU")
    low_level_card_vs_cpu()

    # ---- 9. training and camera perception ----
    _phase(f"training: PPO on the contact plant, B=1536 x 24 steps, "
           f"{TRAIN_ITERS} iterations from the CSV's start")
    reset_launches()
    state, hist_train, _, params_two = training_on_card()
    launches_train = kernel_launches()
    print("training, dispatched operations: "
          + json.dumps(train_dispatches(_train_cfg())), flush=True)
    _phase("training: checkpoint round trip, one f64 update card vs CPU")
    checkpoint_round_trip_on_card(state)
    ppo_update_card_vs_cpu()
    _phase("camera: card vs CPU, bus mission on camera perception")
    _, card_map = camera_card_vs_cpu()
    _, launches_cam = camera_bus_mission_on_card()

    # ---- 10. the data-parallel layer and the last modules ----
    _phase("mesh and the last modules")
    t_mesh = time.perf_counter()
    launches_mesh, launches_mesh_tick = mesh_and_last_modules(
        hist_train, params_two, push_plan, card_map)
    print(f"phase 10 wall time: {time.perf_counter() - t_mesh:.1f} s",
          flush=True)

    # ---- 11. the compiled reference's goldens on the card ----
    _phase("reference goldens on the card")
    t_gold = time.perf_counter()
    reference_goldens_on_card()
    print(f"phase 11 wall time: {time.perf_counter() - t_gold:.1f} s",
          flush=True)

    # ---- 12. the port's entry points ----
    _phase("the port's entry points: entry(), mission_validation, the example "
           "children")
    t_entry = time.perf_counter()
    launches_entry, launches_validation, example_runs = entry_points_on_card(
        smi, children)
    print(f"phase 12 wall time (the children's joins included): "
          f"{time.perf_counter() - t_entry:.1f} s", flush=True)

    # ---- 13. the throughput drivers at cut sizes ----
    _phase("the throughput drivers (bench.py's twin, the example benches) at "
           "cut sizes")
    t_bench = time.perf_counter()
    launches_bench, bench_kernels = bench_lines_on_card(wf, wfc,
                                                        bench_child_proc)
    print(f"phase 13 wall time (the child's join included): "
          f"{time.perf_counter() - t_bench:.1f} s", flush=True)

    # ---- 14. result lines ----
    # each kernel's launches on each path
    paths = dict(
        launches=launches, launches_ring_fleet=launches_ring,
        launches_physics_fleet=launches_phys,
        launches_mapped_arrangement=launches_mapped,
        launches_planner_sim_ltv=launches_ps_ltv,
        launches_planner_sim_nmpc=launches_ps_nmpc,
        launches_policy_eval=launches_eval, launches_bus_mission=launches_bus,
        launches_training=launches_train, launches_camera_mission=launches_cam,
        launches_mesh_tick=launches_mesh_tick,
        launches_mesh_mission=launches_mesh, launches_entry=launches_entry,
        launches_mission_validation=launches_validation,
        **{f"launches_{child}_{r['example']}": r["kernel_launches"]
           for child, rs in example_runs.items() for r in rs},
        launches_bench_mission=launches,
        **{f"launches_bench_{line}": n for line, n in launches_bench.items()})
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
            replaces=replaces,
            **{path: n[name] for path, n in paths.items()},
            max_abs_err=max([m["max_abs_err"], m100[name]["max_abs_err"],
                             m64[name]["max_abs_err"]]
                            + [b["max_abs_err"]
                               for b in bench_kernels[name].values()]),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=None, shape=m["shape"],
            ms_64x80x80=m64[name]["ms"], plain_ms_64x80x80=m64[name]["plain_ms"],
            bound_ms_64x80x80=m64[name]["bound_ms"],
            ms_100x100=m100[name]["ms"], plain_ms_100x100=m100[name]["plain_ms"],
            bound_ms_100x100=m100[name]["bound_ms"],
            bench_shapes={label: {k: b[k] for k in (
                "shape", "ms", "plain_ms", "max_abs_err", "bound_ms",
                "bound_by")}
                for label, b in bench_kernels[name].items()}))
    m1, m16k = k3[1], k3[16384]
    kern.append(dict(
        name="nmpc_feedback", route="cuda",
        source="alore_legged_manipulator_tpu_torch/csrc/nmpc_feedback.cu",
        replaces=None,
        **{path: n["nmpc_feedback"] for path, n in paths.items()},
        max_abs_err=max(max(m["max_gap_x"], m["max_gap_u"])
                        for m in k3.values()),
        ms=m16k["ms"], plain_ms=m16k["plain_ms"], bound_ms=m16k["bound_ms"],
        bound_by=m16k["bound_by"], library_ms=None, shape=m16k["shape"],
        device_ms=m16k["device_ms"], ms_b1=m1["ms"],
        plain_ms_b1=m1["plain_ms"], bound_ms_b1=m1["bound_ms"],
        device_ms_b1=m1["device_ms"], registers=m16k["registers"],
        blocks_per_sm=m16k["blocks_per_sm"]))
    a1, a4k = k4[1], k4[4096]
    kern.append(dict(
        name="qp_admm", route="cuda",
        source="alore_legged_manipulator_tpu_torch/csrc/qp_admm.cu",
        replaces=None,
        **{path: n["qp_admm"] for path, n in paths.items()},
        max_abs_err=max(max(m["gaps"]["x"]["kernel_vs_plain"],
                            m["gaps"]["y"]["kernel_vs_plain"])
                        for m in k4.values()),
        ms=a4k["ms"], plain_ms=a4k["plain_ms"], bound_ms=a4k["bound_ms"],
        bound_by=a4k["bound_by"], library_ms=None, shape=a4k["shape"],
        device_ms=a4k["device_ms"], ms_b1=a1["ms"],
        plain_ms_b1=a1["plain_ms"], bound_ms_b1=a1["bound_ms"],
        device_ms_b1=a1["device_ms"], registers=a4k["registers"],
        blocks_per_sm=a4k["blocks_per_sm"]))
    print(json.dumps({"kernels": kern}), flush=True)
    print(f"script wall time: {time.perf_counter() - T_START:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
