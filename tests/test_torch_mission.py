"""Port parity, whole slice: one mission fleet end to end.

`run_mission` at B=2 missions of K=1 object on the 80x80 mission map
(bench.py's geometry), approach_ticks=300, push_ticks=400, float64, on
the CPU: the JAX program vmapped over the fleet, the port batched.

* The kinematic approach agrees to 1e-12 (the same closed-form ticks).
* The front end's path cells are identical (exact integer search on the
  same blocked grid), and its FlatTraj agrees to 1e-12.
* Both sides deliver every object (`object_err < deliver_tol`).  The
  back end's line searches may take different valid optima after
  last-bit differences, so the pushes are compared on outcome, not
  iterate by iterate.

The contact plant has its own file (tests/test_torch_closed_loop_physics.py),
as do the correction legs and the straight front end
(tests/test_torch_corrections.py).

`MappedPlanManager` in both map modes (perspective; raycast with the
circular-support carve) against JAX, as tests/test_mission.py holds
JAX: float64, the wall south of the robot found in both; after each
scan the planning occupancy and the gridmap are equal cell for cell,
the log odds agree to 1e-12, and the planning ESDF to 1e-6 (float32
fields).  An unseen wall then forces a replan around it from the
fused map on both sides, with the same front-end input.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.core.dynamics import ICRParams as JICR
from alore_legged_manipulator_tpu.ops import wavefront as jw
from alore_legged_manipulator_tpu.ops.esdf import (
    esdf_from_occupancy as j_esdf_from_occupancy)
from alore_legged_manipulator_tpu.runtime import mission_fleet as jmf
from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams as TICR
from alore_legged_manipulator_tpu_torch.ops import wavefront as tw
from alore_legged_manipulator_tpu_torch.ops.esdf import esdf_from_occupancy
from alore_legged_manipulator_tpu_torch.runtime import mission_fleet as tmf

# one intra-op thread: these tests run beside other test workers, and
# their many small tensor ops only slow down when threads oversubscribe
torch.set_num_threads(1)

ITEMS = np.array([[[2.0, 2.5]], [[2.2, 5.5]]])
TARGETS = np.array([[[6.0, 2.5]], [[6.2, 5.5]]])
ROBOT0 = np.array([[1.0, 4.0, 0.0], [1.0, 4.0, 0.0]])
ICR = (-0.3, 0.3, 0.2)


def _occ():
    occ = np.zeros((80, 80), bool)
    occ[30:40, 44:50] = True
    return occ


def _esdfs():
    return (j_esdf_from_occupancy(jnp.asarray(_occ()), jnp.zeros(2), 0.1),
            esdf_from_occupancy(torch.as_tensor(_occ()), torch.zeros(2), 0.1))


def _cfgs():
    kw = dict(approach_ticks=300, push_ticks=400)
    return jmf.MissionFleetConfig(**kw), tmf.MissionFleetConfig(**kw)


@pytest.fixture(scope="module")
def missions():
    e_j, e_t = _esdfs()
    cfg_j, cfg_t = _cfgs()
    ref = jax.jit(jax.vmap(lambda i, t, r: jmf.run_mission(
        i, t, r, e_j, JICR(*ICR), cfg_j)))(
        jnp.asarray(ITEMS), jnp.asarray(TARGETS), jnp.asarray(ROBOT0))
    got = tmf.run_mission(ITEMS, TARGETS, ROBOT0, e_t, TICR(*ICR), cfg_t,
                          device="cpu")
    return jax.tree.map(np.asarray, ref), got


def test_both_deliver(missions):
    ref, got = missions
    cfg_t = _cfgs()[1]
    assert got.object_err.shape == (2, 1)
    assert got.push_traj.shape == (2, 1, cfg_t.push_ticks, 3)
    assert got.object_err.dtype == torch.float64
    for v in got:
        if v.dtype.is_floating_point:
            assert bool(torch.isfinite(v).all())
    assert bool(got.delivered.all()), got.object_err
    assert bool(np.all(ref.delivered)), ref.object_err
    assert float(got.object_err.max()) < cfg_t.deliver_tol
    assert not bool(got.collision.any())
    assert float(got.plan_err.max()) < 1e-2


def test_front_end_identical(missions):
    """Approach, path cells and FlatTraj of the leg, from the same state."""
    e_j, e_t = _esdfs()
    cfg_j, cfg_t = _cfgs()
    rob_ref = jax.vmap(lambda r, g: jmf._approach(r, g, cfg_j.fsm,
                                                  cfg_j.approach_ticks))(
        jnp.asarray(ROBOT0), jnp.asarray(ITEMS[:, 0]))
    rob = tmf._approach(torch.as_tensor(ROBOT0), torch.as_tensor(ITEMS[:, 0]),
                        cfg_t.fsm, cfg_t.approach_ticks)
    np.testing.assert_allclose(rob.numpy(), np.asarray(rob_ref), rtol=0,
                               atol=1e-12)

    start, tgt = ITEMS[:, 0], TARGETS[:, 0]
    yaw = np.asarray(rob_ref)[:, 2]
    flat_ref = jax.vmap(lambda s, y, g: jmf._wavefront_flat(
        e_j, s, y, g, cfg_j))(*map(jnp.asarray, (start, yaw, tgt)))
    flat = tmf._wavefront_flat(e_t, *map(torch.tensor, (start, yaw, tgt)),
                               cfg_t)
    for name, a, b in zip(flat._fields, flat, flat_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12, err_msg=name)

    blocked = np.asarray(e_j.dist) < cfg_j.wf_safe_dis
    cells = lambda p: np.clip(((p - 0.0) / 0.1).astype(np.int32), 0, 79)
    for b in range(2):
        _, c_ref, v_ref = jw.wavefront_path(
            jnp.asarray(blocked), jnp.asarray(cells(tgt[b])),
            jnp.asarray(cells(start[b])), cfg_j.path_max_len, impl="xla")
        _, c, v = tw.wavefront_path(
            torch.as_tensor(blocked)[None], torch.as_tensor(cells(tgt[b]))[None],
            torch.as_tensor(cells(start[b]))[None], cfg_t.path_max_len)
        np.testing.assert_array_equal(c[0].numpy(), np.asarray(c_ref))
        np.testing.assert_array_equal(v[0].numpy(), np.asarray(v_ref))
        assert int(v.sum()) > 30


def test_painted_esdf_matches():
    e_j, e_t = _esdfs()
    centers = np.array([[[3.0, 5.0], [5.5, 2.0]], [[4.2, 6.1], [2.0, 1.5]]])
    ref = jax.vmap(lambda c: jmf._painted_esdf(e_j, c, (0.4, 0.4)).dist)(
        jnp.asarray(centers))
    got = tmf._painted_esdf(e_t, torch.as_tensor(centers), (0.4, 0.4))
    # float32 fields: the painted occupancy is identical, and the EDT's
    # last bit may differ (XLA fuses res * sqrt(.) and the signed
    # combination in its own order): 1e-6 m, two ulps at 5 m
    np.testing.assert_array_equal(got.dist.numpy() <= 0.05,
                                  np.asarray(ref) <= 0.05)
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def _mapped_pair(mode, cir_sup, occ, max_range=4.0, **cfg_kw):
    from alore_legged_manipulator_tpu.mission import plan_manager as jpm
    from alore_legged_manipulator_tpu.world.lidar import LidarConfig as JLC
    from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
    from alore_legged_manipulator_tpu_torch.mission import plan_manager as tpm
    from alore_legged_manipulator_tpu_torch.world.lidar import (
        LidarConfig as TLC)
    cfg = jpm.PlanManagerConfig(dtype=jnp.float64, **cfg_kw)
    kw = dict(occ=occ, lower=(0.0, 0.0), res=0.1, map_mode=mode,
              cir_sup=cir_sup)
    pj = jpm.MappedPlanManager(cfg=cfg, lidar_cfg=JLC(max_range=max_range),
                               **kw)
    pt = tpm.MappedPlanManager(cfg=from_jax_numpy(cfg), device="cpu",
                               lidar_cfg=TLC(max_range=max_range), **kw)
    return pj, pt


def _same_map(pj, pt):
    np.testing.assert_array_equal(pt.occ, np.asarray(pj.occ))
    np.testing.assert_array_equal(pt._map_state.grid.numpy(),
                                  np.asarray(pj._map_state.grid))
    np.testing.assert_allclose(pt._map_state.log_odds.numpy(),
                               np.asarray(pj._map_state.log_odds), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(pt.esdf.dist.numpy(), np.asarray(pj.esdf.dist),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode,cir_sup", [("perspective", False),
                                          ("raycast", True)])
def test_mapped_plan_manager_modes_match_jax(mode, cir_sup):
    """tests/test_mission.py's discovery case on both sides: both
    pipelines expose the wall to the planning map after sensing."""
    from alore_legged_manipulator_tpu_torch.world.lidar import (
        occupancy_classes)
    occ = np.zeros((60, 60), bool)
    occ[10:50, 28:32] = True            # wall at y in [2.8, 3.2)
    pj, pt = _mapped_pair(mode, cir_sup, occ)
    assert not pt.occ.any(), "map must start empty"
    _same_map(pj, pt)
    for pose in [(3.0, 1.2, 1.57)] * 3 + [(2.0, 1.0, 0.5)]:
        pj.sense(pose)
        pt.sense(pose)
        _same_map(pj, pt)
    assert pt.occ[25:35, 28].any()
    _, free, _ = occupancy_classes(pt._map_state, pt.occupancy_cfg)
    assert bool(free[30, 20])
    if cir_sup:
        assert int(free.sum()) > 400


def test_mapped_plan_manager_replans_around_discovered_wall():
    """The first plan goes straight through the unseen wall on both
    sides; after sensing along the detour both replan around it
    (tests/test_mission.py's case), from the same front-end input."""
    from alore_legged_manipulator_tpu.mission import plan_manager as jpm
    from alore_legged_manipulator_tpu_torch.mission import plan_manager as tpm
    occ = np.zeros((80, 80), bool)
    occ[38:44, 20:60] = True
    pj, pt = _mapped_pair("raycast", False, occ, max_range=10.0,
                          replan_period=0.5)
    start, goal = (4.0, 1.0, 1.57), (4.0, 7.0, 1.57)
    true_esdf = j_esdf_from_occupancy(jnp.asarray(occ), jnp.zeros(2), 0.1)
    flats = {"jax": [], "port": []}
    orig = {"jax": jpm.plan_frontend, "port": tpm.plan_frontend}

    def recording(side):
        def f(*a, **kw):
            out = orig[side](*a, **kw)
            flats[side].append(out)
            return out
        return f
    jpm.plan_frontend, tpm.plan_frontend = recording("jax"), recording("port")
    try:
        clearance = {}
        for side, pm in (("jax", pj), ("port", pt)):
            pm.set_goal(goal)
            assert pm.tick(0.0, start) is not None
            blind = _min_true_clearance(pm, start, true_esdf)
            for pose in [(4.0, 1.5, 1.57), (2.5, 2.5, 0.0), (2.5, 4.0, 0.0),
                         (2.5, 5.5, 0.0)]:
                for _ in range(8):
                    pm.sense(pose)
            pm.state = jpm.PlanState.IDLE if side == "jax" \
                else tpm.PlanState.IDLE
            pm.plan_start_time = -1.0
            pm.set_goal(goal)
            assert pm.tick(1.0, start) is not None, pm.state
            clearance[side] = (blind, _min_true_clearance(pm, start,
                                                          true_esdf))
    finally:
        jpm.plan_frontend, tpm.plan_frontend = orig["jax"], orig["port"]
    _same_map(pj, pt)
    for fj, ft in zip(flats["jax"], flats["port"]):
        for name in fj._fields:
            np.testing.assert_array_equal(getattr(ft, name).numpy()[0],
                                          np.asarray(getattr(fj, name)),
                                          err_msg=name)
    for side in ("jax", "port"):
        blind, aware = clearance[side]
        assert blind < 0.0, (side, blind)
        assert aware > 0.05, (side, aware)


def _min_true_clearance(pm, start, true_esdf):
    """The smallest true-world distance along the manager's plan."""
    from alore_legged_manipulator_tpu.core.flow import simpson_flow_positions
    from alore_legged_manipulator_tpu.ops.esdf import sample_dist_bilinear
    tt = pm.tracked
    coeffs = np.asarray(tt.traj.coeffs.numpy()[0] if hasattr(
        tt.traj.coeffs, "numpy") else tt.traj.coeffs)
    times = np.asarray(tt.traj.times.numpy()[0] if hasattr(
        tt.traj.times, "numpy") else tt.traj.times)
    node_xy, _, _ = simpson_flow_positions(jnp.asarray(coeffs),
                                           jnp.asarray(times),
                                           jnp.asarray(start[:2]), 0.2, 8)
    return float(jnp.min(sample_dist_bilinear(true_esdf,
                                              node_xy.reshape(-1, 2))))


def test_default_device_is_the_card(monkeypatch):
    """device=None means CUDA; without a card it raises, never falling
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, e_t = _esdfs()
    with pytest.raises(RuntimeError):
        tmf.run_mission(ITEMS, TARGETS, ROBOT0, e_t, TICR(*ICR))
    from alore_legged_manipulator_tpu_torch.mission.plan_manager import (
        MappedPlanManager)
    with pytest.raises(RuntimeError):
        MappedPlanManager(occ=np.zeros((10, 10), bool), lower=(0.0, 0.0),
                          res=0.1)
