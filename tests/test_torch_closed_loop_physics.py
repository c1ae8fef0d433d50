"""Port parity: the closed loop on the contact-physics plant, and the
mission fleet with `plant="physics"`.

* `_docked_bodies` agrees with JAX to 1e-12 (float64).
* `simulate_tracking_physics` on two tracked trajectories built by the
  JAX package (carried over with `from_jax_numpy`), float64, pose noise
  off (the only random input), 320 ticks: object and robot poses, EKF
  states, wheel commands, tracking errors and grasp gaps agree with the
  JAX loop (vmapped) at every tick to 1e-6: the same arithmetic, with
  last-bit differences fed back through 320 ticks of NMPC, EKF and 640
  contact substeps.
* The port's own default-noise run (a 5 m push planned by the port's
  back end, float32) meets tests/test_closed_loop_physics.py's bounds:
  pos_err mean < 0.05 m and max < 0.12 m, grasp gap < 0.02 m, and a
  plausible identified ICR.
* A B=2, K=1 `run_mission(plant="physics")` (float64, noise off) against
  the JAX fleet, and one physics correction round from the JAX fleet's
  own result: the same lanes miss and are corrected, delivered lanes
  keep every field, and the outcomes agree to a few times the largest
  gap seen: the back ends' final residuals to 5e-7 (seen: 6.5e-8 m), the
  push traces, final object errors and robot poses to 2e-6 (seen: 3.8e-7
  m) and the round's object errors to 1e-9 (seen: 1.0e-10 m).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.control import tracked_traj as jtt
from alore_legged_manipulator_tpu.core.dynamics import ICRParams as JICR
from alore_legged_manipulator_tpu.ops.esdf import (
    esdf_from_occupancy as j_esdf_from_occupancy)
from alore_legged_manipulator_tpu.planner.flat_traj import Polynome as JPoly
from alore_legged_manipulator_tpu.runtime import closed_loop_physics as jclp
from alore_legged_manipulator_tpu.runtime import mission_fleet as jmf
from alore_legged_manipulator_tpu_torch.control.tracked_traj import (
    build_tracked_traj)
from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams as TICR
from alore_legged_manipulator_tpu_torch.ops.esdf import esdf_from_occupancy
from alore_legged_manipulator_tpu_torch.planner.backend import (
    BackendConfig, plan_backend)
from alore_legged_manipulator_tpu_torch.planner.flat_traj import Polynome
from alore_legged_manipulator_tpu_torch.runtime import closed_loop_physics \
    as tclp
from alore_legged_manipulator_tpu_torch.runtime import mission_fleet as tmf

torch.set_num_threads(1)

N_TICKS = 320
ICR = (-0.3, 0.3, 0.2)


def _messages():
    """Two pushes: a curved one and a turning one."""
    rng = np.random.default_rng(5)
    n = 4
    msgs = []
    for b in range(2):
        L = 2.0 + b
        yaw0 = 0.4 + 0.8 * b
        inner = np.stack([yaw0 + 0.25 * (b + 1) * np.sin(np.arange(1, n)),
                          L * np.arange(1, n) / n])
        msgs.append(JPoly(
            traj_start_time=np.float64(0.0), inner_points=inner,
            piece_times=rng.uniform(0.6, 0.9, n),
            init_state=np.array([[yaw0, 0.0, 0.0], [0.0, 0.0, 0.0]]),
            tail_state=np.array([[yaw0 + 0.3, 0.0, 0.0], [L, 0.0, 0.0]]),
            start_position=np.array([1.0, 2.0 + 2 * b, yaw0]),
            icr=np.array(ICR)))
    return JPoly(*(np.stack(f) for f in zip(*msgs)))


def _to_f32(obj):
    if torch.is_tensor(obj):
        return obj.to(torch.float32) if obj.is_floating_point() else obj
    return type(obj)(*(_to_f32(v) for v in obj))


def test_docked_bodies_match_jax():
    poses = np.array([[1.0, 2.0, 0.3], [-0.5, 4.0, -2.2], [3.0, 3.0, 0.0]])
    cfg_j = jclp.PhysicsLoopConfig()
    for p in poses:
        ref, ar, ao = jclp._docked_bodies(jnp.asarray(p), cfg_j, jnp.float64)
        got, gr, go = tclp._docked_bodies(torch.as_tensor(p)[None],
                                          tclp.PhysicsLoopConfig(),
                                          torch.float64)
        for name, a, b in zip(ref._fields, ref, got):
            np.testing.assert_allclose(b[0].numpy(), np.asarray(a), rtol=0,
                                       atol=1e-12, err_msg=name)
        np.testing.assert_array_equal(gr.numpy(), np.asarray(ar))
        np.testing.assert_array_equal(go.numpy(), np.asarray(ao))


@pytest.fixture(scope="module")
def tracked():
    msg = jax.tree.map(jnp.asarray, _messages())
    cfg_j = jclp.PhysicsLoopConfig(pose_noise=0.0)
    tt_j = jax.jit(jax.vmap(lambda m: jtt.build_tracked_traj(m, n_grid=256)))(
        msg)
    ref = jax.jit(jax.vmap(lambda tt: jclp.simulate_tracking_physics(
        tt, N_TICKS, cfg_j)))(tt_j)
    tt_t = from_jax_numpy(jax.tree.map(np.asarray, tt_j))
    got = tclp.simulate_tracking_physics(
        tt_t, N_TICKS, tclp.PhysicsLoopConfig(pose_noise=0.0))
    return jax.tree.map(np.asarray, ref), got


def test_tracking_matches_jax_tick_for_tick(tracked):
    ref, got = tracked
    assert got.obj_xytheta.shape == (2, N_TICKS, 3)
    assert got.est.dtype == torch.float64
    for name in ref._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(ref, name), rtol=0, atol=1e-6,
                                   err_msg=name)
    # the objects were really carried along the references
    moved = np.linalg.norm(ref.obj_xytheta[:, -1, :2]
                           - ref.obj_xytheta[:, 0, :2], axis=-1)
    assert np.all(moved > 1.5)
    assert float(got.pos_err.max()) < 0.12
    assert float(got.grasp_gap.max()) < 0.02


def test_default_noise_run_meets_the_jax_bounds():
    """tests/test_closed_loop_physics.py's scenario in the port alone: a
    straight 5 m push planned by the port's back end, tracked in float32
    with the default pose noise."""
    occ = torch.zeros((80, 80), dtype=torch.bool)
    esdf = esdf_from_occupancy(occ, torch.zeros(2), 0.1)
    start = torch.tensor([[1.0, 4.0]], dtype=torch.float64)
    goal = torch.tensor([[6.0, 4.2]], dtype=torch.float64)
    flat = tmf._straight_flat(start, torch.zeros(1, dtype=torch.float64),
                              goal, 5, 3.0)
    res = plan_backend(flat, esdf, BackendConfig())
    assert not bool(res.collision.any())
    msg = Polynome(
        traj_start_time=torch.zeros(1, dtype=torch.float64),
        inner_points=res.inner, piece_times=res.times,
        init_state=flat.start_state, tail_state=res.tail_state,
        start_position=flat.start_xytheta,
        icr=torch.tensor([ICR], dtype=torch.float64))
    tt = _to_f32(build_tracked_traj(msg))
    n_ticks = min(int(float(tt.duration[0]) / 0.01), 900)
    out = tclp.simulate_tracking_physics(tt, n_ticks,
                                         tclp.PhysicsLoopConfig(), seed=0)
    pe = out.pos_err[0].numpy()
    assert pe.mean() < 0.05, pe.mean()
    assert pe.max() < 0.12, pe.max()
    assert float(out.grasp_gap.max()) < 0.02
    icr = out.est[0, -1, 3:6].numpy()
    assert np.all(np.isfinite(icr))
    assert icr[1] - icr[0] > 0.1
    assert -1.0 < icr[2] < 1.0


# ---------------------------------------------------------------------------
# the fleet on the contact plant
# ---------------------------------------------------------------------------

ITEMS = np.array([[[1.0, 4.0]], [[2.0, 2.0]]])
TARGETS = np.array([[[6.0, 4.0]], [[3.5, 2.0]]])
ROBOT0 = np.tile(np.array([0.5, 4.0, 0.0]), (2, 1))
PUSH, CORR = 220, 220


def _fleet_cfgs():
    kw = dict(approach_ticks=300, push_ticks=PUSH, plant="physics")
    return (jmf.MissionFleetConfig(
                phys_loop=jclp.PhysicsLoopConfig(pose_noise=0.0), **kw),
            tmf.MissionFleetConfig(
                phys_loop=tclp.PhysicsLoopConfig(pose_noise=0.0), **kw))


@pytest.fixture(scope="module")
def fleet():
    occ = np.zeros((80, 80), bool)
    e_j = j_esdf_from_occupancy(jnp.asarray(occ), jnp.zeros(2), 0.1)
    e_t = esdf_from_occupancy(torch.as_tensor(occ), torch.zeros(2), 0.1)
    cfg_j, cfg_t = _fleet_cfgs()
    ref = jax.jit(jax.vmap(lambda i, t, r: jmf.run_mission(
        i, t, r, e_j, JICR(*ICR), cfg_j)))(
            jnp.asarray(ITEMS), jnp.asarray(TARGETS), jnp.asarray(ROBOT0))
    got = tmf.run_mission(ITEMS, TARGETS, ROBOT0, e_t, TICR(*ICR), cfg_t,
                          device="cpu")
    fixed_j, n_j = jmf.correct_missed_legs(ref, jnp.asarray(TARGETS), e_j,
                                           JICR(*ICR), cfg_j, CORR)
    ref_np = jax.tree.map(np.asarray, ref)
    fixed_t, n_t = tmf.correct_missed_legs(from_jax_numpy(ref_np), TARGETS,
                                           e_t, TICR(*ICR), cfg_t, CORR)
    return ref_np, got, jax.tree.map(np.asarray, fixed_j), n_j, fixed_t, n_t


def test_physics_fleet_matches_jax(fleet):
    ref, got = fleet[:2]
    assert got.push_traj.shape == (2, 1, PUSH, 3)
    for v in got:
        if v.dtype.is_floating_point:
            assert bool(torch.isfinite(v).all())
    # lane 0's 5 m leg misses the 2.2 s budget on both sides, lane 1
    # delivers
    np.testing.assert_array_equal(got.delivered.numpy(), ref.delivered)
    assert ref.delivered.tolist() == [[False], [True]]
    np.testing.assert_allclose(got.plan_err.numpy(), ref.plan_err, rtol=0,
                               atol=5e-7)
    np.testing.assert_allclose(got.object_err.numpy(), ref.object_err,
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.robot_final.numpy(), ref.robot_final,
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.push_traj.numpy(), ref.push_traj, rtol=0,
                               atol=2e-6)


def test_physics_correction_round_matches_jax(fleet):
    ref, _, fixed_j, n_j, fixed_t, n_t = fleet
    assert n_j == n_t == 1
    np.testing.assert_array_equal(fixed_t.delivered.numpy(), fixed_j.delivered)
    assert bool(fixed_t.delivered[0, 0])
    np.testing.assert_allclose(fixed_t.object_err.numpy(), fixed_j.object_err,
                               rtol=0, atol=1e-9)
    # the delivered lane keeps every field bit for bit
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(fixed_t, name)[1].numpy(),
                                      getattr(ref, name)[1], err_msg=name)
    # and a physics round runs through correct_until_delivered too
    occ = torch.zeros((80, 80), dtype=torch.bool)
    e_t = esdf_from_occupancy(occ, torch.zeros(2), 0.1)
    out, counts = tmf.correct_until_delivered(
        from_jax_numpy(ref), TARGETS, e_t, TICR(*ICR), _fleet_cfgs()[1], CORR,
        max_rounds=1)
    assert counts == [1]
    assert torch.equal(out.object_err, fixed_t.object_err)
