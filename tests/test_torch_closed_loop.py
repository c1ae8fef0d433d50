"""Port parity: the closed NMPC + ICR-EKF + plant loop, tick for tick.

A batch of tracked trajectories is built by the JAX package from numpy
Polynome messages and carried into the port with
`convert.from_jax_numpy`, so both loops track the very same reference.
With plant noise off (`add_noise=False`, the only random input), the
JAX loop (vmapped) and the port's batched loop must give the same plant
poses, EKF states and wheel commands at every tick to 1e-6 in float64:
the same arithmetic, with summation-order differences (~1e-15 per tick)
fed back through 150 ticks of NMPC and EKF.

The plant step is also checked on its own with pre-drawn noise, which
both sides accept: `jax.random` streams cannot be reproduced by a
`torch.Generator`, so the port takes the numbers as an argument.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from alore_legged_manipulator_tpu.control import tracked_traj as jtt
from alore_legged_manipulator_tpu.core.dynamics import ICRParams as JICR
from alore_legged_manipulator_tpu.estimator import icr_ekf as jekf
from alore_legged_manipulator_tpu.planner.flat_traj import Polynome as JPoly
from alore_legged_manipulator_tpu.runtime import closed_loop as jcl
from alore_legged_manipulator_tpu.world import plant as jpl
from alore_legged_manipulator_tpu_torch.control import tracked_traj as ttt
from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams as TICR
from alore_legged_manipulator_tpu_torch.estimator import icr_ekf as tekf
from alore_legged_manipulator_tpu_torch.runtime import closed_loop as tcl
from alore_legged_manipulator_tpu_torch.world import plant as tpl

# one intra-op thread: these tests run beside other test workers, and
# their many small tensor ops only slow down when threads oversubscribe
torch.set_num_threads(1)

B = 3
N_TICKS = 150
ICR = (-0.3, 0.3, 0.2)


def _messages():
    """Three pushes: straight, curved, and a turn-in-place start."""
    rng = np.random.default_rng(11)
    n = 4
    msgs = []
    for b in range(B):
        L = 1.5 + b
        yaw0 = 0.3 * b
        inner = np.stack([yaw0 + 0.2 * b * np.sin(np.arange(1, n)),
                          L * np.arange(1, n) / n])
        msgs.append(JPoly(
            traj_start_time=np.float64(0.0), inner_points=inner,
            piece_times=rng.uniform(0.5, 0.9, n),
            init_state=np.array([[yaw0, 0.0, 0.0], [0.0, 0.0, 0.0]]),
            tail_state=np.array([[yaw0 + 0.1 * b, 0.0, 0.0], [L, 0.0, 0.0]]),
            start_position=np.array([1.0, 2.0 + b, yaw0]),
            icr=np.array(ICR)))
    return JPoly(*(np.stack(f) for f in zip(*msgs)))


def _tracked_pair():
    msg = _messages()
    tt_j = jax.jit(jax.vmap(lambda m: jtt.build_tracked_traj(m, n_grid=256)))(
        jax.tree.map(jnp.asarray, msg))
    tt_np = jax.tree.map(np.asarray, tt_j)
    return tt_j, tt_np, from_jax_numpy(tt_np)


def test_tracked_traj_carried_over():
    """The port's own build_tracked_traj reproduces the JAX one."""
    _, tt_np, tt_t = _tracked_pair()
    msg = from_jax_numpy(_messages())
    own = ttt.build_tracked_traj(msg, n_grid=256)
    np.testing.assert_allclose(own.seq.numpy(), tt_np.seq, rtol=0, atol=1e-12)
    np.testing.assert_allclose(own.traj.coeffs.numpy(), tt_np.traj.coeffs,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(own.duration.numpy(), tt_np.duration, rtol=0,
                               atol=1e-14)
    assert isinstance(tt_t, ttt.TrackedTraj)


def test_simulate_tracking_tick_for_tick():
    tt_j, _, tt_t = _tracked_pair()
    cfg_j = jcl.LoopConfig(plant=jpl.PlantConfig(add_noise=False))
    cfg_t = tcl.LoopConfig(plant=tpl.PlantConfig(add_noise=False))
    ref = jax.jit(jax.vmap(
        lambda tt: jcl.simulate_tracking(tt, JICR(*ICR), N_TICKS, cfg_j)))(tt_j)
    got = tcl.simulate_tracking(tt_t, TICR(*ICR), N_TICKS, cfg_t)
    for name in ("xytheta", "est", "u_cmd", "pos_err", "icr_err"):
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6, err_msg=name)
    # the loop really moved the robots along their references
    assert float(got.pos_err[:, -1].max()) < 0.2
    assert float((got.xytheta[:, -1, :2] - got.xytheta[:, 0, :2]).norm(
        dim=-1).min()) > 0.5


def test_plant_step_with_given_noise():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 3))
    v, w = rng.standard_normal(B), rng.standard_normal(B)
    cmd = rng.uniform(-1.0, 1.0, (B, 2))
    noise = rng.standard_normal((B, 2))
    cfg_j, cfg_t = jpl.PlantConfig(), tpl.PlantConfig()
    st_t = tpl.PlantState(xytheta=torch.as_tensor(x), v=torch.as_tensor(v),
                          omega=torch.as_tensor(w),
                          vy=torch.zeros(B, dtype=torch.float64),
                          s=torch.zeros(B, dtype=torch.float64))
    got = tpl.plant_step(st_t, torch.as_tensor(cmd), TICR(*ICR), 0.002, cfg_t,
                         noise=torch.as_tensor(noise))
    # reference: the JAX step without noise on a command whose body
    # velocities carry the same multiplicative factors
    ref_nf = jax.vmap(lambda xx, vv, ww, u: jpl.plant_step(
        jpl.PlantState(xx, vv, ww, 0.0 * vv, 0.0 * vv), u, JICR(*ICR), 0.002,
        cfg_j._replace(add_noise=False)))(*map(jnp.asarray, (x, v, w, cmd)))
    got_nf = tpl.plant_step(st_t, torch.as_tensor(cmd), TICR(*ICR), 0.002,
                            cfg_t._replace(add_noise=False))
    for a, b in zip(got_nf, ref_nf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-14)
    # with noise: des_v, des_w scaled by (1 + sigma * n) before the rate
    # limit; recompute that limit by hand on the numpy side
    yr, yl, xv = ICR
    vl, vr = cmd[:, 0], cmd[:, 1]
    des_v = (vr * yl - vl * yr) / (yl - yr) * (1 + 0.01 * noise[:, 0])
    des_w = (vr - vl) / (yl - yr) * (1 + 0.01 * noise[:, 1])
    v_new = v + np.clip(des_v - v, -0.02, 0.02)
    w_new = w + np.clip(des_w - w, -0.04, 0.04)
    np.testing.assert_allclose(got.v.numpy(), v_new, rtol=0, atol=1e-14)
    np.testing.assert_allclose(got.omega.numpy(), w_new, rtol=0, atol=1e-14)


def test_ekf_predict_update():
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.standard_normal((B, 3)),
                        np.tile(np.array(ICR), (B, 1))
                        + 0.02 * rng.standard_normal((B, 3))], 1)
    M = rng.standard_normal((B, 6, 6))
    P = M @ M.transpose(0, 2, 1) * 0.01 + 0.01 * np.eye(6)
    u = rng.uniform(-1.0, 1.0, (B, 2))
    obs = x[:, :3] + 0.05 * rng.standard_normal((B, 3))
    obs[:, 2] += 2 * np.pi                     # exercised by the unwrap
    cfg_j, cfg_t = jekf.EkfConfig(), tekf.EkfConfig()
    ref = jax.vmap(lambda xx, pp, uu, oo: jekf.ekf_update(
        jekf.ekf_predict(jekf.EkfState(xx, pp), uu, 0.01, cfg_j), oo, cfg_j))(
        *map(jnp.asarray, (x, P, u, obs)))
    got = tekf.ekf_update(
        tekf.ekf_predict(tekf.EkfState(torch.as_tensor(x), torch.as_tensor(P)),
                         torch.as_tensor(u), 0.01, cfg_t),
        torch.as_tensor(obs), cfg_t)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got.P.numpy(), np.asarray(ref.P), rtol=0,
                               atol=1e-12)
    init_ref = jekf.ekf_init(jnp.asarray(x[0, :3]), jnp.asarray(ICR), cfg_j,
                              jnp.float64)
    init = tekf.ekf_init(torch.as_tensor(x[:1, :3]), ICR, cfg_t,
                         torch.float64)
    np.testing.assert_array_equal(init.x[0].numpy(), np.asarray(init_ref.x))
    np.testing.assert_array_equal(init.P[0].numpy(), np.asarray(init_ref.P))
