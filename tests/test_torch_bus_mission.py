"""Port parity: the arrangement mission over the message bus
(`runtime/bus_mission.py`), host numpy on both sides.

* `run_bus_mission` with the kinematic controller node: two and three
  objects, default and custom visit orders, against the JAX package's:
  equal tick counts, delivery flags and final errors, bit for bit (both
  packages run the same host arithmetic; the port's FSM, contracts and
  arm loop are copies).
* The three nodes tick by tick: every `/env_obs`, `/env_control_data`,
  `/simulator/carstate` and arm-state message published on the port's
  bus equals the JAX bus's.
* `perception="camera"` runs on the port (it raised `ValueError` while
  the camera modules were missing): a one-object mission on the CPU
  gives the JAX package's tick count, flags and errors
  (tests/test_torch_camera_perception.py holds the two-object one).
"""
import numpy as np
import pytest

from alore_legged_manipulator_tpu.runtime import bus_mission as jbm
from alore_legged_manipulator_tpu.runtime import deploy as jdep
from alore_legged_manipulator_tpu_torch.runtime import bus_mission as tbm
from alore_legged_manipulator_tpu_torch.runtime import deploy as tdep

CASES = {
    "two": dict(items=[(2.0, 0.5, 0.0), (1.0, -2.0, 0.3)],
                targets=[(4.0, 2.0, 0.0), (3.0, -3.0, 0.0)], order=None),
    "three_reordered": dict(items=[(2.0, 1.0, 0.0), (-1.5, 1.0, 1.0),
                                   (0.5, -2.5, -0.5)],
                            targets=[(3.5, 2.5, 0.0), (-3.0, 2.0, 0.0),
                                     (2.0, -3.5, 0.0)],
                            order=[2, 0, 1]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_bus_mission_matches_jax(case):
    kw = CASES[case]
    ref = jbm.run_bus_mission(kw["items"], kw["targets"], kw["order"],
                              robot_start=(0.0, 0.0, 0.2), seed=3)
    got = tbm.run_bus_mission(kw["items"], kw["targets"], kw["order"],
                              robot_start=(0.0, 0.0, 0.2), seed=3)
    assert got.ticks == ref.ticks
    assert got.delivered == ref.delivered
    assert got.final_err == ref.final_err
    assert all(got.delivered)


def test_nodes_publish_the_same_messages():
    kw = CASES["two"]
    logs = []
    for bm, dep in ((jbm, jdep), (tbm, tdep)):
        bus = dep.MessageBus()
        log = []
        for topic in (bm.TOPIC_OBS, bm.TOPIC_CTRL, bm.TOPIC_CARSTATE,
                      "/arm_current_state", "/hand_current_state"):
            bus.subscribe(topic, lambda m, t=topic: log.append(
                (t, np.array(m, copy=True))))
        world = bm.WorldState(robot=np.zeros(3),
                              objects=[np.asarray(i, float).copy()
                                       for i in kw["items"]])
        percept = bm.PerceptionNode(bus, seed=5)
        fsm = bm.MissionFsmNode(bus, kw["items"], kw["targets"], [0, 1])
        ctrl = bm.ControllerNode(bus, world)
        for _ in range(400):
            percept.tick(world)
            fsm.tick()
            ctrl.tick()
        logs.append(log)
    assert len(logs[0]) == len(logs[1]) > 1500
    for (ta, a), (tb, b) in zip(*logs):
        assert ta == tb
        np.testing.assert_array_equal(a, b)


def test_camera_perception_is_not_ported_yet():
    kw = dict(items=[(3.0, 0.4, 0.0)], targets=[(5.0, 1.0, 0.0)],
              perception="camera", seed=2)
    ref = jbm.run_bus_mission(**kw)
    got = tbm.run_bus_mission(**kw, device="cpu")
    assert (got.ticks, got.delivered, got.final_err) == \
        (ref.ticks, ref.delivered, ref.final_err)
    assert all(got.delivered)
