"""Port parity: the high-level controller node with the policy in the
loop (`runtime/highlevel_controller.py`) over the bus mission's
perception and FSM nodes.

* Oracle policy, surrogate env: the full perception -> FSM -> policy
  controller mission, JAX against the port.  The JAX node's env starts
  from its reset at float64 (its node hard-codes float32 where the FSM's
  command, the action and the anchored pose cross into the env, and so
  does the port's); the port's node starts from that state, converted.
  Tick count, the FSM state of every tick and the final poses agree to
  1e-9 (seen: 577 ticks on both, final poses 4.4e-16 m apart).
* The trained policy (`models/weights/highlevel_physics_6000.npz`
  against the orbax checkpoint it came from), contact plant, the
  mission of examples/train_and_deploy_highlevel.py (item (2, 0.5),
  target (4, 2), dt 0.02): both packages reach DONE under the example's
  0.5 m criterion.  The port's anchored contact scene is the JAX
  package's (same key, converted), both at float32.  Seen (CPU): JAX
  459 ticks and 0.2791 m, the port 460 ticks and 0.2579 m; held to 10
  ticks and 0.05 m.  With its own generator's contact scene the port
  delivers too (seen: 515 ticks, 0.2750 m).
* The actor policy function gives the JAX one's action on the same
  state (1e-5 relative); robot tracking and idle coasting on the port
  alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.models.actor_critic import (
    PhysicActorCritic as JAC)
from alore_legged_manipulator_tpu.rl import env as jenv
from alore_legged_manipulator_tpu.rl import env_physics as jep
from alore_legged_manipulator_tpu.runtime import bus_mission as jbm
from alore_legged_manipulator_tpu.runtime import deploy as jdep
from alore_legged_manipulator_tpu.runtime import highlevel_controller as jhl
from alore_legged_manipulator_tpu_torch.convert import (add_lane_axis,
                                                      from_jax_numpy)
from alore_legged_manipulator_tpu_torch.models.torch_convert import (
    load_highlevel_actor)
from alore_legged_manipulator_tpu_torch.runtime import bus_mission as tbm
from alore_legged_manipulator_tpu_torch.runtime import deploy as tdep
from alore_legged_manipulator_tpu_torch.runtime import (
    highlevel_controller as thl)
from alore_legged_manipulator_tpu_torch.runtime.contracts import (
    EnvControlData, TaskState)
from tests.export_highlevel_weights import restore_params

torch.set_num_threads(1)

ITEMS = [(2.0, 0.5, 0.0)]
TARGETS = [(4.0, 2.0, 0.0)]


def _np(tree):
    return jax.tree.map(np.array, tree)


def _world(mod):
    return mod.WorldState(robot=np.zeros(3),
                          objects=[np.asarray(ITEMS[0], float).copy()]
                          + [np.zeros(3) for _ in range(3)])


def run_mission(bm, dep, hl, make_ctrl, perception_seed=7, max_ticks=20000):
    bus = dep.MessageBus()
    world = _world(bm)
    percept = bm.PerceptionNode(bus, seed=perception_seed)
    fsm_node = bm.MissionFsmNode(bus, ITEMS, TARGETS, order=[0], dt=0.02)
    ctrl = make_ctrl(bus, world)
    states, ticks = [], 0
    done = type(fsm_node.fsm.state).DONE
    while fsm_node.fsm.state != done and ticks < max_ticks:
        percept.tick(world)
        fsm_node.tick()
        ctrl.tick(dt=0.02)
        states.append(fsm_node.fsm.state.name)
        ticks += 1
    err = float(np.linalg.norm(world.objects[0][:2]
                               - np.asarray(TARGETS[0])[:2]))
    return dict(ticks=ticks, states=states, world=world, err=err,
                state=fsm_node.fsm.state.name, ctrl=ctrl)


def test_oracle_surrogate_mission_matches_jax():
    seed = 0
    js0 = jenv.env_reset(jax.random.PRNGKey(seed), jenv.PushEnvConfig(),
                         jnp.float64)

    def jax_ctrl(bus, world):
        c = jhl.HighLevelControllerNode(bus, world,
                                        jhl.make_oracle_policy())
        c.env_state = js0
        return c

    def port_ctrl(bus, world):
        c = thl.HighLevelControllerNode(bus, world,
                                        thl.make_oracle_policy(),
                                        device="cpu")
        c.env_state = from_jax_numpy(add_lane_axis(_np(js0)))
        return c

    ref = run_mission(jbm, jdep, jhl, jax_ctrl)
    got = run_mission(tbm, tdep, thl, port_ctrl)
    assert ref["state"] == "DONE" and ref["err"] < 0.5
    assert got["ticks"] == ref["ticks"]
    assert got["states"] == ref["states"]
    for a, b in zip(got["world"].objects + [got["world"].robot],
                    ref["world"].objects + [ref["world"].robot]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def trained():
    params = restore_params()
    return params["actor"], load_highlevel_actor(device="cpu")


def test_trained_physics_mission_both_deliver(trained):
    jparams, actor = trained

    def jax_ctrl(bus, world):
        return jhl.HighLevelControllerNode(
            bus, world, jhl.make_actor_policy(JAC(), jparams), physics=True)

    def port_ctrl(bus, world):
        c = thl.HighLevelControllerNode(bus, world,
                                        thl.make_actor_policy(actor),
                                        physics=True, device="cpu")
        pcfg = jep.PhysicsEnvConfig()

        def jax_anchored(obj_id, pose32):
            st = jep.env_reset(jax.random.PRNGKey(c.seed + 7919 * obj_id),
                               pcfg, obj_type=obj_id % 3,
                               obj_pose=jnp.asarray(pose32.numpy()))
            return from_jax_numpy(add_lane_axis(_np(st)))

        c.reset_physics = jax_anchored
        return c

    ref = run_mission(jbm, jdep, jhl, jax_ctrl)
    got = run_mission(tbm, tdep, thl, port_ctrl)
    assert ref["state"] == "DONE" and ref["err"] < 0.5, ref["err"]
    assert got["state"] == "DONE" and got["err"] < 0.5, got["err"]
    assert abs(got["ticks"] - ref["ticks"]) <= 10, (got["ticks"],
                                                    ref["ticks"])
    assert abs(got["err"] - ref["err"]) <= 0.05, (got["err"], ref["err"])


def test_port_trained_mission_with_its_own_resets(trained):
    _, actor = trained
    got = run_mission(tbm, tdep, thl, lambda bus, world:
                      thl.HighLevelControllerNode(
                          bus, world, thl.make_actor_policy(actor),
                          physics=True, device="cpu"))
    assert got["state"] == "DONE" and got["err"] < 0.5, got["err"]


def test_actor_policy_fn_matches_jax(trained):
    jparams, actor = trained
    pcfg = jep.PhysicsEnvConfig()
    st = jep.env_reset(jax.random.PRNGKey(4), pcfg)
    step = jax.jit(lambda s, a: jep.env_step(s, a, pcfg)[0])
    rng = np.random.default_rng(0)
    for _ in range(6):
        st = step(st, jnp.asarray(rng.uniform(-1, 1, 9), jnp.float32))
    view = jep.as_surrogate_view(st)
    ref = np.asarray(jhl.make_actor_policy(JAC(), jparams)(view.obs_hist,
                                                           view))
    tview = from_jax_numpy(add_lane_axis(_np(view)))
    got = thl.make_actor_policy(actor)(tview.obs_hist[0], tview)
    assert got.shape == (9,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _send(bus, **kw):
    bus.publish("/env_control_data", EnvControlData(**kw).pack())


def test_robot_tracking_and_idle_coasting():
    bus = tdep.MessageBus()
    world = _world(tbm)
    node = thl.HighLevelControllerNode(bus, world, thl.make_oracle_policy(),
                                       device="cpu")
    _send(bus, robot_vel_cmd=np.array([1.0, 0.0, 0.0], np.float32),
          task_state=TaskState.ROBOT_TRACKING)
    for _ in range(50):
        node.tick(dt=0.02)
    assert abs(world.robot[0] - 1.0) < 1e-6
    assert abs(node.publish_obs().robot.xyz[0] - 1.0) < 1e-6
    _send(bus, object_vel_cmd=np.array([0.5, 0.0, 0.0], np.float32),
          task_state=TaskState.OBJECT_TRACKING, object_type=0.0)
    for _ in range(150):
        node.tick(dt=0.02)
    assert world.objects[0][0] - 2.0 > 0.5
    assert abs(float(node.env_state.obj_vel[0, 0]) - 0.5) < 0.15
    _send(bus, task_state=TaskState.RELEASING, object_type=0.0)
    for _ in range(200):
        node.tick(dt=0.02)
    assert abs(float(node.env_state.obj_vel[0, 0])) < 0.05
    assert np.all(np.isfinite(world.objects[0]))
