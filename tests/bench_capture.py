"""Record the JAX package's results for the benches whose programs take
minutes to compile on the CPU, for tests/test_torch_bench.py and
tests/test_torch_example_bench.py.

At the tiny sizes below, on the CPU at float32, this runs the JAX
package's own functions as `bench.py` and `examples/bench_*.py` compose
them (vmapped over the fleet, one jit a program, the same seeds and
per-repetition perturbations):

* `bench.py::bench_backend` (compact direction, B=BACKEND_B, one timed
  fleet call, one B=1 latency chain of BACKEND_CHAIN plans on the first
  goal): each lane's total duration, final XY error and collision flag
  of the timed call, and the chain's sum of piece times;
* `examples/bench_mission_legs.py` (B=LEGS_B, LEGS_TICKS ticks): each
  lane's max tracking error, final XY error and collision flag;
* `bench.py::bench_mission` (B=MISSION_B, K=MISSION_K, MISSION_TICKS,
  correction legs of MISSION_CORR ticks, one timed iteration, no
  warm-up): delivered flags and object errors before and after
  `correct_until_delivered`, the per-round miss counts;
* `examples/bench_mission_fleet.py` (B=FLEET_B, K=FLEET_K,
  CORRECTION=FLEET_CORR, CORRECTION_MODE=redispatch, ticks
  FLEET_TICKS): delivered flags and object errors before and after
  `correct_missed_legs`, the corrected count.

Each mission is run a second time with another plant-noise seed
(ALT_SEED) and the robot's start moved ALT_MOVE m: the `*_alt` object
errors give the JAX-vs-JAX gap from which the tests set their bands
(the port's noise streams are not JAX's).

Writes `alore_legged_manipulator_tpu_torch/data/bench_capture.npz`:

    JAX_PLATFORMS=cpu python tests/bench_capture.py

takes about 5 min on one CPU.
"""
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "alore_legged_manipulator_tpu_torch" / "data" / \
    "bench_capture.npz"

BACKEND_B, BACKEND_CHAIN = 2, 1
LEGS_B, LEGS_TICKS = 2, 20
# pushes long enough to carry each object metres toward its target but
# too short to deliver it (deliver_tol 0.3 m), so that every leg runs
# every correction round and the counts do not hang on the plant noise
MISSION_B, MISSION_K, MISSION_TICKS, MISSION_CORR = 2, 1, (700, 300), 30
FLEET_B, FLEET_K, FLEET_TICKS, FLEET_CORR = 2, 1, (300, 300), 50
ALT_SEED, ALT_MOVE = 1, 1e-4


def _mk(goal_xy, n_pieces=6):
    """bench.py's `mk` (and the example benches' `make_flat`)."""
    import jax.numpy as jnp

    from alore_legged_manipulator_tpu.planner.flat_traj import FlatTraj
    dtype = jnp.float32
    start = jnp.asarray([1.0, 4.0], dtype)
    d = goal_xy - start
    L = jnp.linalg.norm(d)
    yaw = jnp.arctan2(d[1], d[0])
    fr = jnp.arange(1, n_pieces, dtype=dtype) / n_pieces
    inner = jnp.stack([jnp.full((n_pieces - 1,), yaw, dtype), L * fr])
    pos = jnp.concatenate(
        [start[None] + fr[:, None] * d[None], goal_xy[None]], 0)
    pos = jnp.concatenate([pos, jnp.full((n_pieces, 1), yaw, dtype)], 1)
    total_t = jnp.maximum(L / 3.0 * 2.0, 1.0)
    z3 = jnp.zeros((), dtype)
    return FlatTraj(
        inner_yaw_s=inner, init_piece_time=total_t / n_pieces,
        inner_positions=pos,
        start_state=jnp.stack([jnp.stack([yaw, z3, z3]),
                               jnp.stack([z3, z3, z3])]),
        final_state=jnp.stack([jnp.stack([yaw, z3, z3]),
                               jnp.stack([L, z3, z3])]),
        start_xytheta=jnp.concatenate([start, yaw[None]]),
        final_xytheta=jnp.concatenate([goal_xy, yaw[None]]),
        if_cut=jnp.asarray(False))


def _esdf():
    import jax.numpy as jnp

    from alore_legged_manipulator_tpu.ops.esdf import esdf_from_occupancy
    occ = np.zeros((80, 80), bool)
    occ[30:40, 44:50] = True
    return esdf_from_occupancy(jnp.asarray(occ), jnp.zeros(2), 0.1)


def _goals(B):
    rng = np.random.default_rng(0)
    return np.stack([rng.uniform(5.0, 7.0, B), rng.uniform(3.0, 5.0, B)], 1)


def backend():
    import jax
    import jax.numpy as jnp

    from alore_legged_manipulator_tpu.planner.backend import (BackendConfig,
                                                              plan_backend)
    esdf = _esdf()
    cfg = BackendConfig(solver_direction="compact")
    goals = jnp.asarray(_goals(BACKEND_B), jnp.float32)

    @jax.jit
    def fleet(goals):
        res = jax.vmap(lambda g: plan_backend(_mk(g), esdf, cfg))(goals)
        return (jnp.sum(res.times, -1), jnp.linalg.norm(res.final_xy_err,
                                                        axis=-1),
                res.collision)

    @jax.jit
    def chained(goal):
        def body(g, _):
            res = plan_backend(_mk(g), esdf, cfg)
            return g + 1e-6 * jnp.tanh(res.final_xy_err), jnp.sum(res.times)
        _, sums = jax.lax.scan(body, goal, None, length=BACKEND_CHAIN)
        return jnp.sum(sums)

    dur, err, coll = fleet(goals + jnp.float32(1e-6))
    lat = chained(goals[0] + jnp.float32(1e-6))
    # the example bench's fleet call has no jitter
    ex_dur, ex_err, ex_coll = fleet(goals)
    return {"backend_duration": dur, "backend_final_xy_err": err,
            "backend_collision": coll, "backend_lat_checksum": lat,
            "ex_backend_duration": ex_dur, "ex_backend_final_xy_err": ex_err,
            "ex_backend_collision": ex_coll}


def legs():
    import jax
    import jax.numpy as jnp

    from alore_legged_manipulator_tpu.control.tracked_traj import (
        build_tracked_traj)
    from alore_legged_manipulator_tpu.core.dynamics import ICRParams
    from alore_legged_manipulator_tpu.planner.backend import (BackendConfig,
                                                              plan_backend)
    from alore_legged_manipulator_tpu.planner.flat_traj import Polynome
    from alore_legged_manipulator_tpu.runtime.closed_loop import (
        LoopConfig, simulate_tracking)
    dtype = jnp.float32
    esdf = _esdf()
    cfg = BackendConfig(solver_direction="compact")
    icr = ICRParams(yr=-0.3, yl=0.3, xv=0.2)

    def one_leg(goal_xy):
        flat = _mk(goal_xy)
        res = plan_backend(flat, esdf, cfg)
        msg = Polynome(
            traj_start_time=jnp.zeros((), dtype), inner_points=res.inner,
            piece_times=res.times, init_state=flat.start_state,
            tail_state=res.tail_state, start_position=flat.start_xytheta,
            icr=jnp.asarray([icr.yr, icr.yl, icr.xv], dtype))
        tt = build_tracked_traj(msg, n_grid=256)
        tr = simulate_tracking(tt, icr, LEGS_TICKS, LoopConfig(), seed=0)
        return (jnp.max(tr.pos_err), jnp.linalg.norm(res.final_xy_err),
                res.collision)

    out = jax.jit(jax.vmap(one_leg))(jnp.asarray(_goals(LEGS_B), dtype))
    return dict(zip(("legs_track_err_max", "legs_final_xy_err",
                     "legs_collision"), out))


def _mission_inputs(B, K):
    import jax.numpy as jnp

    from alore_legged_manipulator_tpu.runtime.mission_fleet import (
        spaced_scenarios)
    items, targets = spaced_scenarios(B, K, np.random.default_rng(0))
    robot0 = jnp.tile(jnp.asarray([1.0, 4.0, 0.0], jnp.float32), (B, 1))
    return (jnp.asarray(items, jnp.float32), jnp.asarray(targets, jnp.float32),
            robot0)


def mission():
    import jax

    from alore_legged_manipulator_tpu.core.dynamics import ICRParams
    from alore_legged_manipulator_tpu.planner.backend import BackendConfig
    from alore_legged_manipulator_tpu.runtime.mission_fleet import (
        MissionFleetConfig, correct_until_delivered, run_mission)
    esdf = _esdf()
    icr = ICRParams(yr=-0.3, yl=0.3, xv=0.2)
    cfg = MissionFleetConfig(
        approach_ticks=MISSION_TICKS[0], push_ticks=MISSION_TICKS[1],
        backend=BackendConfig(solver_direction="compact"))
    items, targets, robot0 = _mission_inputs(MISSION_B, MISSION_K)
    fleet = jax.jit(jax.vmap(
        lambda i, t, r, s: run_mission(i, t, r, esdf, icr, cfg, seed=s),
        in_axes=(0, 0, 0, None)))

    def run(move, seed):
        base = fleet(items, targets, robot0.at[:, 0].add(move), seed)
        res, miss = correct_until_delivered(base, targets, esdf, icr, cfg,
                                            MISSION_CORR, seed=seed)
        return base, res, miss
    base, res, miss_counts = run(1e-6, 0)
    alt_base, alt_res, _ = run(1e-6 + ALT_MOVE, ALT_SEED)
    return {"mission_delivered_before": base.delivered,
            "mission_delivered": res.delivered,
            "mission_object_err_before": base.object_err,
            "mission_object_err": res.object_err,
            "mission_object_err_before_alt": alt_base.object_err,
            "mission_object_err_alt": alt_res.object_err,
            "mission_miss_counts": np.asarray(miss_counts, np.int64)}


def mission_fleet():
    import jax

    from alore_legged_manipulator_tpu.core.dynamics import ICRParams
    from alore_legged_manipulator_tpu.runtime.mission_fleet import (
        MissionFleetConfig, correct_missed_legs, run_mission)
    esdf = _esdf()
    icr = ICRParams(yr=-0.3, yl=0.3, xv=0.2)
    cfg = MissionFleetConfig(approach_ticks=FLEET_TICKS[0],
                             push_ticks=FLEET_TICKS[1], plant="kinematic",
                             correction_ticks=0)
    items, targets, robot0 = _mission_inputs(FLEET_B, FLEET_K)
    fleet = jax.jit(jax.vmap(
        lambda i, t, r, s: run_mission(i, t, r, esdf, icr, cfg, seed=s),
        in_axes=(0, 0, 0, None)))

    def run(move, seed):
        base = fleet(items, targets, robot0.at[:, 0].add(move), seed)
        res, n = correct_missed_legs(base, targets, esdf, icr, cfg,
                                     correction_ticks=FLEET_CORR, seed=seed)
        return base, res, n
    base, res, n_corrected = run(0.0, 0)
    alt_base, alt_res, _ = run(ALT_MOVE, ALT_SEED)
    return {"fleet_delivered_before": base.delivered,
            "fleet_delivered": res.delivered,
            "fleet_object_err_before": base.object_err,
            "fleet_object_err": res.object_err,
            "fleet_object_err_before_alt": alt_base.object_err,
            "fleet_object_err_alt": alt_res.object_err,
            "fleet_corrected": np.asarray(n_corrected, np.int64)}


def main():
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    out = {}
    for part in (backend, legs, mission, mission_fleet):
        got = {k: np.asarray(v) for k, v in part().items()}
        print(part.__name__, {k: v.tolist() for k, v in got.items()},
              flush=True)
        out.update(got)
    np.savez_compressed(OUT, **out)
    print("->", OUT)


if __name__ == "__main__":
    main()
