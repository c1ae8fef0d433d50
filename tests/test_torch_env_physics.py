"""Port parity: the contact-plant push env (`rl/env_physics.py`).

States come from the JAX package's resets (vmapped over split keys),
converted with `from_jax_numpy`; then 20 steps of both envs with the
same actions (numpy seed).  Compared each step: every body's pose and
velocity, the weld state, observation history, arm joints, step
counter, reward and done; also the critic observation and the surrogate
view.  Three scenes: the served default (robot + object), two static
obstacles placed in the robot's way (the collision termination), and
two dynamic bystanders.  Tolerance 1e-9 at float64 (gaps seen: 1.2e-14;
the tied contact order of ROADMAP.md section 3 did not show) and 1e-4
at float32 (seen: 4.1e-6).  The port's own generator draws are checked
for their ranges and the docked reset invariants.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.rl import env_physics as jep
from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.rl import env_physics as tep

torch.set_num_threads(1)

B = 4
OBST = (np.array([[1.2, 0.0], [-1.5, 0.4]]), np.array([0.0, 0.3]),
        np.array([[0.2, 1.0], [0.3, 0.3]]))
SCENES = {
    "default": jep.PhysicsEnvConfig(),
    "obstacles": jep.PhysicsEnvConfig(n_obstacles=2),
    "bystanders": jep.PhysicsEnvConfig(n_bystanders=2),
}
DTYPES = [(jnp.float64, torch.float64, 1e-9),
          (jnp.float32, torch.float32, 1e-4)]


def _np(tree):
    return jax.tree.map(np.array, tree)


def _close(got, ref, tol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, float),
                               np.asarray(ref, float), rtol=0, atol=tol,
                               err_msg=what)


def jax_reset(cfg, dtype, seed=0, n=B):
    obst = OBST if cfg.n_obstacles else None
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.vmap(lambda k: jep.env_reset(k, cfg, dtype,
                                            obstacles=obst))(keys)


def same_state(ts, js, tol):
    for f in ("pose", "vel", "mass", "inertia", "half_ext", "box_off",
              "mu_ground"):
        _close(getattr(ts.bodies, f), getattr(js.bodies, f), tol, f)
    for f in ("obj_anchor", "cmd", "friction", "com", "arm_q",
              "prev_action", "obs_hist"):
        _close(getattr(ts, f), getattr(js, f), tol, f)
    for f in ("grasp_active", "obj_type", "t"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), f)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f64", "f32"])
def test_twenty_steps_match_jax(scene, jdt, tdt, tol):
    cfg = SCENES[scene]
    js = jax_reset(cfg, jdt, seed=1)
    ts = from_jax_numpy(_np(js))
    tcfg = from_jax_numpy(cfg)
    same_state(ts, js, tol)
    _close(tep.critic_observation(ts, tcfg),
           jax.vmap(lambda s: jep.critic_observation(s, cfg))(js), tol,
           "critic")
    step = jax.jit(jax.vmap(lambda s, a: jep.env_step(s, a, cfg)))
    rng = np.random.default_rng(2)
    dones = []
    for k in range(20):
        a = rng.uniform(-1.2, 1.2, (B, 9)).astype(np.float32)
        a[:, 0] = np.abs(a[:, 0])          # mostly forward: reach obstacles
        js, jh, jr, jd = step(js, jnp.asarray(a))
        ts, th, tr, td = tep.env_step(ts, torch.as_tensor(a), tcfg)
        same_state(ts, js, tol)
        _close(th, jh, tol, f"hist {k}")
        _close(tr, jr, 10 * tol, f"reward {k}")
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        dones.append(td.numpy())
    view_t = tep.as_surrogate_view(ts)
    view_j = jax.vmap(jep.as_surrogate_view)(js)
    for f in ("obj_pose", "obj_vel", "mass"):
        _close(getattr(view_t, f), getattr(view_j, f), tol, f)


def test_port_reset_is_docked():
    cfg = from_jax_numpy(jep.PhysicsEnvConfig(n_bystanders=2))
    gen = torch.Generator().manual_seed(0)
    st = tep.env_reset(gen, cfg, torch.float64, n_envs=64, device="cpu")
    assert st.bodies.pose.shape == (64, 4, 3)
    # the robot's grasp point sits on the object's anchor
    wa = st.bodies.pose[:, 0, :2] + tep._rotate(
        st.bodies.pose[:, 0, 2], torch.tensor(cfg.grasp_anchor_robot,
                                              dtype=torch.float64))
    wb = st.bodies.pose[:, 1, :2] + tep._rotate(st.bodies.pose[:, 1, 2],
                                                st.obj_anchor)
    torch.testing.assert_close(wa, wb, rtol=0, atol=1e-12)
    assert bool(st.grasp_active.all())
    r = torch.linalg.vector_norm(st.bodies.pose[:, 2:, :2], dim=-1)
    assert bool(((r >= 2.0) & (r <= 3.5)).all())
    assert set(st.obj_type.tolist()) == {0, 1, 2}
    # re-anchoring at a given pose and class
    st = tep.env_reset(torch.Generator().manual_seed(1), cfg, torch.float64,
                       obj_type=2, obj_pose=(2.0, 0.5, 0.3), device="cpu")
    _close(st.bodies.pose[0, 1], [2.0, 0.5, 0.3], 1e-15, "anchored pose")
    assert int(st.obj_type[0]) == 2
