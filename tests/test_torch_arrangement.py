"""Port parity: the arrangement mission and the layers under it.

* Mission ordering: the port's copy of mission/ordering.py against the
  compiled reference's goldens (tests/golden/ordering), as
  tests/test_ordering_parity.py holds JAX: visit orders exact, costs to
  1e-12.  The copies of ordering.py and object_fsm.py stay the JAX
  package's text.
* `ObjectFsm`: the state, robot command and object command of every tick
  of tests/test_object_fsm.py's simulated missions equal JAX's exactly.
* `PlanManager` (float64, on the CPU): painting gives JAX's occupancy
  cell for cell and its field to 1e-6 (float32 ESDF); an unreachable goal
  ends in EMERGENCY_STOP on both sides; a plan, a replan from the
  predicted state and the goal gate go through the same states, the
  predicted replan state agrees within 1 cm (the back ends settle on
  optima a few mm apart) and both trajectories end at the goal.
* `ArrangementMission.run` with one object, on each plant, float64,
  noise off: the same visit order, the same FSM edge sequence, the same
  `delivered`, the same simulated time and approach track, the object
  push planned from the same front-end output bit for bit, the port's
  plan ending within 5 mm of the goal, and the outcomes within a few
  times the gaps seen: final object error to 0.01 m (seen: 5.9e-4 m
  kinematic, 2.2e-3 m physics), the pushed object's last pose to 0.02
  (seen: 1.8e-3, 1.04e-2) and the p95 tracking error to 0.01 m (seen:
  2.9e-4, 2.9e-3).  The gaps come from the back end, not the plant: on
  this scene's push the MINCO back end is chaotic at float64 -- given
  JAX's own front-end output, the port's inner points end up to 8.2 cm
  from JAX's (207 against 198 stage-2 iterations), and JAX's own back
  end moves its inner points 17 cm when its input moves 1e-12 m; both
  plans end at the goal.
* The same one-object mission with `mapped=True` (the planning map
  starts empty and is fused from 3 m lidar scans, raycast with the
  circular-support carve and perspective), kinematic plant: the same
  checks, with as many scans on both sides.
* The mission and the manager run on the card unless given device="cpu".
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.mission import object_fsm as jfsm
from alore_legged_manipulator_tpu.mission import ordering as jord
from alore_legged_manipulator_tpu.mission import plan_manager as jpm
from alore_legged_manipulator_tpu.runtime import arrangement as jarr
from alore_legged_manipulator_tpu.runtime import closed_loop as jcl
from alore_legged_manipulator_tpu.runtime import closed_loop_physics as jclp
from alore_legged_manipulator_tpu.world import plant as jpl
from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.mission import object_fsm as tfsm
from alore_legged_manipulator_tpu_torch.mission import ordering as tord
from alore_legged_manipulator_tpu_torch.mission import plan_manager as tpm
from alore_legged_manipulator_tpu_torch.runtime import arrangement as tarr
from tests.test_ordering_parity import CASES

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# ordering and the task FSM (host copies)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["ordering", "object_fsm"])
def test_host_copies_keep_the_jax_text(module):
    src = {"ordering": (jord, tord), "object_fsm": (jfsm, tfsm)}[module]
    assert inspect.getsource(src[1]) == inspect.getsource(src[0])


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_ordering_matches_reference_golden(idx):
    mode, shape, mat, ref_cost, ref = CASES[idx]
    if mode == "B":
        order, cost = tord.branch_and_bound_order(mat, shape)
        assert [0] + order == ref
    elif mode == "G":
        cost, path = tord._greedy_fixed(mat, shape, list(range(shape)))
        assert path == ref
    else:
        assignment, cost = tord.hungarian(mat)
        assert assignment == ref
    assert cost == pytest.approx(ref_cost, rel=1e-12)


def _fsm_run(mod, items, targets, order, max_steps=6000):
    """tests/test_object_fsm.py's simulated mission; returns the trace of
    (state, robot command, object command) per tick."""
    fsm = mod.ObjectFsm(items=[np.asarray(i, float) for i in items],
                        targets=[np.asarray(t, float) for t in targets],
                        order=order)
    robot = np.array([0.0, 0.0, 0.0])
    objects = [np.asarray(i, float)[:2].copy() for i in items]
    dt, trace = 0.05, []
    for _ in range(max_steps):
        cur_obj = objects[fsm.order[fsm.task_idx]] \
            if fsm.task_idx < len(fsm.order) else objects[-1]
        if fsm.state == mod.FsmState.WAIT_ROBOT_PATH:
            fsm.set_robot_path([robot[:2] + (cur_obj - robot[:2]) * (k + 1) / 6
                                for k in range(5)])
        if fsm.state == mod.FsmState.WAIT_OBJECT_PATH:
            fsm.object_path_ready()

        def follower():
            d = fsm.current_target()[:2] - cur_obj
            dist = np.linalg.norm(d)
            if dist < 0.1:
                return np.zeros(3), True
            v = np.clip(d / max(dist, 1e-6) * 0.5, -0.5, 0.5)
            return np.array([v[0], v[1], 0.0]), False

        state, rv, ov = fsm.tick(robot, cur_obj, follower)
        trace.append((state.name, tuple(rv), tuple(ov)))
        robot[0] += rv[0] * np.cos(robot[2]) * dt
        robot[1] += rv[0] * np.sin(robot[2]) * dt
        robot[2] += rv[2] * dt
        if state == mod.FsmState.OBJECT_TRACKING:
            cur_obj += ov[:2] * dt
            robot[0] += ov[0] * dt
            robot[1] += ov[1] * dt
        if state == mod.FsmState.DONE:
            break
    return trace


@pytest.mark.parametrize("scene", ["single", "three"])
def test_object_fsm_ticks_match_jax(scene):
    if scene == "single":
        items, targets, order = [(2.0, 1.0, 0.0)], [(4.0, 3.0, 0.0)], [0]
    else:
        items = [(2.0, 1.0, 0.0), (1.0, 3.0, 0.0), (3.5, 0.5, 0.0)]
        targets = [(5.0, 4.0, 0.0), (4.0, 5.0, 0.0), (5.5, 2.0, 0.0)]
        order = [1, 0, 2]
    ref = _fsm_run(jfsm, items, targets, order)
    got = _fsm_run(tfsm, items, targets, order)
    assert got == ref
    assert got[-1][0] == "DONE"


# ---------------------------------------------------------------------------
# the plan manager
# ---------------------------------------------------------------------------

def _pm_pair(occ, **kw):
    cfg_j = jpm.PlanManagerConfig(dtype=jnp.float64, **kw)
    cfg_t = from_jax_numpy(cfg_j)
    assert cfg_t.dtype == torch.float64
    return (jpm.PlanManager(occ=occ.copy(), lower=(0.0, 0.0), res=0.1,
                            cfg=cfg_j),
            tpm.PlanManager(occ=occ.copy(), lower=(0.0, 0.0), res=0.1,
                            cfg=cfg_t, device="cpu"))


def test_plan_manager_painting_matches_jax():
    occ = np.zeros((40, 40), bool)
    occ[5:8, 20:30] = True
    pj, pt = _pm_pair(occ)
    for center, half, obs in (((2.0, 2.0), 0.3, True), ((2.25, 1.05), 0.25,
                                                         True),
                              ((2.0, 2.0), 0.3, False), ((0.55, 2.5), 0.4,
                                                         True)):
        pj.paint_square(center, half_size=half, make_obs=obs)
        pt.paint_square(center, half_size=half, make_obs=obs)
        assert isinstance(pt.occ, np.ndarray)
        np.testing.assert_array_equal(pt.occ, pj.occ)
        np.testing.assert_allclose(pt.esdf.dist.numpy(),
                                   np.asarray(pj.esdf.dist), rtol=0,
                                   atol=1e-6)
    assert pt.occ[6, 25] and not pt.occ[20, 20]


def test_plan_manager_emergency_on_unreachable():
    occ = np.zeros((40, 40), bool)
    occ[:, 20] = True
    for pm in _pm_pair(occ):
        pm.set_goal((2.0, 3.5, 0.0))
        assert pm.tick(0.0, (2.0, 0.5, 0.0)) is None
        assert pm.state.name == "EMERGENCY_STOP"
        # an emergency stop holds through later goals and ticks
        pm.set_goal((1.0, 1.0, 0.0))
        assert pm.tick(1.0, (2.0, 0.5, 0.0)) is None
        assert pm.state.name == "EMERGENCY_STOP"


def test_plan_manager_tick_sequence_matches_jax():
    """Plan, one replan from the predicted state (search start moved
    along the trajectory), then the goal gate."""
    occ = np.zeros((50, 50), bool)
    occ[22:28, 15:30] = True
    pj, pt = _pm_pair(occ, replan_period=1.0)
    states, fronts = {}, {}
    for name, pm in (("jax", pj), ("port", pt)):
        pm.set_goal((4.2, 3.0, 0.0))
        seq = []
        msg = pm.tick(0.0, (0.8, 1.5, 0.0))
        seq.append((pm.state.name, msg is not None))
        # follow the first trajectory perfectly
        pose, _, _ = pm.predicted_state(1.05 - pm.plan_start_time)
        fronts[name] = pose
        msg = pm.tick(1.05, pose)
        seq.append((pm.state.name, msg is not None))
        end, _, _ = pm.predicted_state(1e3)
        np.testing.assert_allclose(end[:2], [4.2, 3.0], atol=0.05)
        msg = pm.tick(pm.plan_start_time + pm.traj_total_time - 0.2,
                      (4.0, 3.0, 0.0))
        seq.append((pm.state.name, msg is not None))
        states[name] = seq
    assert states["port"] == states["jax"]
    assert states["port"][:2] == [("PLANNING", True), ("REPLAN", True)]
    np.testing.assert_allclose(fronts["port"], fronts["jax"], rtol=0,
                               atol=0.01)


def test_plan_manager_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tpm.PlanManager(occ=np.zeros((10, 10), bool), lower=(0.0, 0.0),
                        res=0.1)


# ---------------------------------------------------------------------------
# the arrangement mission
# ---------------------------------------------------------------------------

def _recording(cls, edges):
    """The FSM class with every change of `state` appended to `edges`."""
    class Recording(cls):
        def __setattr__(self, key, value):
            if key == "state" and (not edges or edges[-1] != value.name):
                edges.append(value.name)
            super().__setattr__(key, value)
    return Recording


def _calls(fn, out):
    """`fn`, with every result appended to `out`."""
    def wrapped(*args, **kwargs):
        res = fn(*args, **kwargs)
        out.append(res)
        return res
    return wrapped


def _scene(**kw):
    occ = np.zeros((60, 60), bool)
    occ[28:32, 10:30] = True
    return dict(occ=occ, lower=(0.0, 0.0), res=0.1, items=[(1.5, 1.5, 0.0)],
                targets=[(4.5, 4.0, 0.0)], **kw)


@pytest.mark.parametrize("plant", ["kinematic", "physics"])
def test_one_object_arrangement_matches_jax(plant, monkeypatch):
    _one_object_matches_jax(plant == "physics", monkeypatch)


@pytest.mark.parametrize("mode,cir_sup", [("raycast", True),
                                          ("perspective", False)])
def test_one_object_mapped_arrangement_matches_jax(mode, cir_sup,
                                                   monkeypatch):
    """The same mission on a map that starts empty and is built from
    lidar scans (range 3 m): the wall is found while the robot moves.
    The maps, the approach and the push's front-end input are equal on
    both sides; from that same input the chaotic back end (ROADMAP.md
    section 3) plans raycast's push 0.11 s longer on the port, so the
    simulated time may differ by the push's length, to 0.25 s."""
    from alore_legged_manipulator_tpu.world.lidar import LidarConfig as JLC
    from alore_legged_manipulator_tpu_torch.world.lidar import (
        LidarConfig as TLC)
    senses = {"jax": 0, "port": 0}
    for side, mod in (("jax", jpm), ("port", tpm)):
        orig = mod.MappedPlanManager.sense

        def counted(self, *a, _orig=orig, _side=side, **kw):
            senses[_side] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(mod.MappedPlanManager, "sense", counted)
    _one_object_matches_jax(
        False, monkeypatch,
        jax_kw=dict(mapped=True, map_mode=mode, cir_sup=cir_sup,
                    lidar_cfg=JLC(max_range=3.0)),
        port_kw=dict(mapped=True, map_mode=mode, cir_sup=cir_sup,
                     lidar_cfg=TLC(max_range=3.0)), push_time_tol=0.25)
    assert senses["port"] == senses["jax"] > 8


def _one_object_matches_jax(physics, monkeypatch, jax_kw=None, port_kw=None,
                            push_time_tol=0.0):
    jax_kw, port_kw = jax_kw or {}, port_kw or {}
    pm_cfg = jpm.PlanManagerConfig(dtype=jnp.float64)
    loop = jcl.LoopConfig(plant=jpl.PlantConfig(add_noise=False))
    phys = jclp.PhysicsLoopConfig(pose_noise=0.0)
    edges = {"jax": [], "port": []}
    monkeypatch.setattr(jarr, "ObjectFsm", _recording(jfsm.ObjectFsm,
                                                      edges["jax"]))
    monkeypatch.setattr(tarr, "ObjectFsm", _recording(tfsm.ObjectFsm,
                                                      edges["port"]))
    # what each manager's front end hands its back end, and the port's
    # back-end results
    flats = {"jax": [], "port": []}
    plans = []
    for side, mod in (("jax", jpm), ("port", tpm)):
        monkeypatch.setattr(mod, "plan_frontend", _calls(
            mod.plan_frontend, flats[side]))
    monkeypatch.setattr(tpm, "plan_backend", _calls(tpm.plan_backend, plans))
    start = (4.5, 0.5, 1.57)
    ref = jarr.ArrangementMission(**_scene(
        pm_cfg=pm_cfg, loop_cfg=loop, phys_cfg=phys,
        use_physics_plant=physics, **jax_kw)).run(start, record_tracks=True)
    got = tarr.ArrangementMission(**_scene(
        pm_cfg=from_jax_numpy(pm_cfg), loop_cfg=from_jax_numpy(loop),
        phys_cfg=from_jax_numpy(phys), use_physics_plant=physics,
        device="cpu", **port_kw)).run(start, record_tracks=True)
    assert got.order == ref.order == [0]
    assert edges["port"] == edges["jax"]
    assert edges["port"][-1] == "DONE" and "RELEASING" in edges["port"]
    assert got.delivered == ref.delivered == [True]
    assert got.sim_time_s == pytest.approx(ref.sim_time_s,
                                           abs=push_time_tol or 1e-9)
    np.testing.assert_array_equal(got.robot_track, ref.robot_track)
    # the back end gets the same input, and the port's plan ends at the goal
    assert len(flats["port"]) == len(flats["jax"]) == len(plans) == 1
    for name in flats["jax"][0]._fields:
        np.testing.assert_array_equal(
            getattr(flats["port"][0], name).numpy()[0],
            np.asarray(getattr(flats["jax"][0], name)), err_msg=name)
    assert float(plans[0].final_xy_err.norm()) < 0.005
    np.testing.assert_allclose(got.final_object_err, ref.final_object_err,
                               rtol=0, atol=0.01)
    np.testing.assert_allclose(got.object_tracks[0][-1],
                               ref.object_tracks[0][-1], rtol=0, atol=0.02)
    if not push_time_tol:
        assert got.object_tracks[0].shape == ref.object_tracks[0].shape
    assert got.push_tracking_err_p95 == pytest.approx(
        ref.push_tracking_err_p95, abs=0.01)


def test_mission_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tarr.ArrangementMission(**_scene()).run((4.5, 0.5, 1.57))
