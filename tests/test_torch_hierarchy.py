"""Port parity: the frozen low-level WBC in the env step
(`rl/hierarchy.py`, `rl/env_physics.py::hierarchical_env_step`).

The low-level policy is a randomized reference twin
(tests/test_torch_convert.py's `TorchLowAC`, imported) converted twice:
by the JAX package's `convert_low_level_actor` into flax parameters and
by the port's into the port's `ActorCriticLow`.  Robot states start at
`robot_reset` on both sides (lanes by broadcasting); env states come
from the JAX resets, converted.  Compared: one 200 Hz substep, the
decimation loop, then 20 high-level steps of the surrogate hierarchy
and of the contact-plant hierarchy with the same actions -- robot pose,
velocity, joints, the 799-d assembly carry, the env state, history,
reward and done.  Tolerance 1e-9 at float64 (gaps seen: 1.5e-14), 1e-4
at float32 (seen: 1.0e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.models.torch_convert import (
    convert_low_level_actor as j_convert)
from alore_legged_manipulator_tpu.rl import env as jenv
from alore_legged_manipulator_tpu.rl import env_physics as jep
from alore_legged_manipulator_tpu.rl import hierarchy as jh
from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.models.torch_convert import (
    convert_low_level_actor as t_convert)
from alore_legged_manipulator_tpu_torch.rl import env_physics as tep
from alore_legged_manipulator_tpu_torch.rl import hierarchy as th
from tests.test_torch_convert import TorchLowAC, _randomize

torch.set_num_threads(1)

B = 3
DTYPES = [(jnp.float64, torch.float64, 1e-9),
          (jnp.float32, torch.float32, 1e-4)]
IDS = ["f64", "f32"]


def _np(tree):
    return jax.tree.map(np.array, tree)


def _close(got, ref, tol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, float),
                               np.asarray(ref, float), rtol=0, atol=tol,
                               err_msg=what)


@pytest.fixture(scope="module")
def policies():
    sd = _randomize(TorchLowAC(), seed=42)
    pol = th.low_level_policy_cfg()
    pol.load_state_dict(t_convert(sd))
    return j_convert(sd), pol.eval()


def _pair(policies, jdt, tdt):
    jp, tp = policies
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), jp)
    return jp, tp.to(tdt)


def jax_robots(jdt, n=B):
    rs = jh.robot_reset(jdt)
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), rs)


def same_robot(tr, jr, tol):
    for f in ("base_pose", "base_vel", "q", "dq", "prev_low_action"):
        _close(getattr(tr, f), getattr(jr, f), tol, f)
    for f in ("hist", "gait_phase", "prev_leg_action"):
        _close(getattr(tr.obs_state, f), getattr(jr.obs_state, f), tol, f)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=IDS)
def test_substep_and_decimation(policies, jdt, tdt, tol):
    jp, tp = _pair(policies, jdt, tdt)
    jr = jax_robots(jdt)
    tr = from_jax_numpy(_np(jr))
    same_robot(th.robot_reset(tdt, B, device="cpu"), jr, 0.0)
    cmd = np.random.default_rng(0).uniform(-1, 1, (B, 3))
    cfg = jh.HierarchyConfig()
    policy = jh.low_level_policy_cfg()
    sub = jax.jit(jax.vmap(lambda r, c: jh.hierarchical_substep(
        r, c, jp, cfg, policy)))
    jr1 = sub(jr, jnp.asarray(cmd, jdt))
    tr1 = th.hierarchical_substep(tr, torch.as_tensor(cmd).to(tdt), tp,
                                  from_jax_numpy(cfg))
    same_robot(tr1, jr1, tol)
    app = jax.jit(jax.vmap(lambda r, c: jh.hierarchical_apply_action(
        r, c, jp, cfg)))
    jr4 = app(jr, jnp.asarray(cmd, jdt))
    tr4 = th.hierarchical_apply_action(tr, torch.as_tensor(cmd).to(tdt), tp,
                                       from_jax_numpy(cfg))
    same_robot(tr4, jr4, tol)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=IDS)
def test_surrogate_hierarchy_twenty_steps(policies, jdt, tdt, tol):
    jp, tp = _pair(policies, jdt, tdt)
    cfg = jenv.PushEnvConfig()
    js = jax.vmap(lambda k: jenv.env_reset(k, cfg, jdt))(
        jax.random.split(jax.random.PRNGKey(3), B))
    jr = jax_robots(jdt)
    ts, tr = from_jax_numpy(_np(js)), from_jax_numpy(_np(jr))
    step = jax.jit(jax.vmap(lambda s, r, a: jh.hierarchical_env_step(
        s, r, a, jp, cfg), in_axes=(0, 0, 0)))
    rng = np.random.default_rng(4)
    for k in range(20):
        a = rng.uniform(-1.2, 1.2, (B, 9)).astype(np.float32)
        js, jr, jhst, jrew, jd = step(js, jr, jnp.asarray(a))
        ts, tr, thst, trew, td = th.hierarchical_env_step(
            ts, tr, torch.as_tensor(a), tp, from_jax_numpy(cfg))
        same_robot(tr, jr, tol)
        for f in ("obj_pose", "obj_vel", "arm_q", "prev_action"):
            _close(getattr(ts, f), getattr(js, f), tol, f"{f} {k}")
        _close(thst, jhst, tol, f"hist {k}")
        _close(trew, jrew, 10 * tol, f"reward {k}")
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=IDS)
def test_contact_hierarchy_twenty_steps(policies, jdt, tdt, tol):
    jp, tp = _pair(policies, jdt, tdt)
    cfg = jep.PhysicsEnvConfig()
    js = jax.vmap(lambda k: jep.env_reset(k, cfg, jdt))(
        jax.random.split(jax.random.PRNGKey(5), B))
    jr = jax_robots(jdt)
    ts, tr = from_jax_numpy(_np(js)), from_jax_numpy(_np(jr))
    tcfg = from_jax_numpy(cfg)
    step = jax.jit(jax.vmap(lambda s, r, a: jep.hierarchical_env_step(
        s, r, a, jp, cfg)))
    rng = np.random.default_rng(6)
    for k in range(20):
        a = rng.uniform(-1.2, 1.2, (B, 9)).astype(np.float32)
        js, jr, jhst, jrew, jd = step(js, jr, jnp.asarray(a))
        ts, tr, thst, trew, td = tep.hierarchical_env_step(
            ts, tr, torch.as_tensor(a), tp, tcfg)
        same_robot(tr, jr, tol)
        _close(ts.bodies.pose, js.bodies.pose, tol, f"pose {k}")
        _close(ts.bodies.vel, js.bodies.vel, tol, f"vel {k}")
        np.testing.assert_array_equal(ts.grasp_active.numpy(),
                                      np.asarray(js.grasp_active))
        _close(thst, jhst, tol, f"hist {k}")
        _close(trew, jrew, 10 * tol, f"reward {k}")
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
