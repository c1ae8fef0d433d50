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
import pytest
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


# --- tracked-trajectory, plant and estimator extras (1e-12, f64) ------------

def test_astate_and_pad_tracked_traj():
    """`astate` against JAX, and a padded trajectory answers every query
    as the unpadded one does, with the end pose held past the duration
    (1e-12)."""
    tt_j, tt_np, tt_t = _tracked_pair()
    ts = np.linspace(-0.1, 1.2, 9)[None, :] * tt_np.duration[:, None]
    a_ref = jax.vmap(lambda tt, t: jax.vmap(lambda q: jtt.astate(tt, q))(t))(
        tt_j, jnp.asarray(ts))
    np.testing.assert_allclose(ttt.astate(tt_t, torch.as_tensor(ts)).numpy(),
                               np.asarray(a_ref), rtol=0, atol=1e-12)

    cap = 7
    pad_j = jax.vmap(lambda tt: jtt.pad_tracked_traj(tt, cap))(tt_j)
    pad_t = ttt.pad_tracked_traj(tt_t, cap)
    assert pad_t.traj.coeffs.shape == (B, cap, 6, 2)
    np.testing.assert_allclose(pad_t.traj.coeffs.numpy(),
                               np.asarray(pad_j.traj.coeffs), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(pad_t.traj.times.numpy(),
                                  np.asarray(pad_j.traj.times))
    tq = torch.as_tensor(ts)
    np.testing.assert_allclose(ttt.pstate(pad_t, tq).numpy(),
                               ttt.pstate(tt_t, tq).numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(ttt.vstate(pad_t, tq)[:, :-2].numpy(),
                               ttt.vstate(tt_t, tq)[:, :-2].numpy(), rtol=0,
                               atol=1e-12)
    # at and past the end the pad piece holds the pose with zero rates
    assert float(ttt.vstate(pad_t, tq)[:, -1].abs().max()) == 0.0
    assert ttt.pad_tracked_traj(tt_t, 2) is tt_t          # already larger


def test_ltv_ref_points():
    tt_j, tt_np, tt_t = _tracked_pair()
    yaw_est = np.array([0.1, 0.4 + 2 * np.pi, -0.2])
    t_cur = 0.7 * tt_np.duration          # the horizon runs past the end
    ref = jax.vmap(lambda tt, t, y: jtt.ltv_ref_points(tt, t, 20, 0.05, y))(
        tt_j, jnp.asarray(t_cur), jnp.asarray(yaw_est))
    got = ttt.ltv_ref_points(tt_t, torch.as_tensor(t_cur), 20, 0.05,
                             torch.as_tensor(yaw_est))
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-12)


def test_plant_mpc_tick_and_wheel_feedback():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 3))
    v, w = rng.standard_normal(B), rng.standard_normal(B)
    cmd_v = np.array([0.5, -0.01, 1.2])        # one below the decay step
    cmd_w = np.array([0.3, 0.0, -0.05])
    cfg_j, cfg_t = jpl.PlantConfig(), tpl.PlantConfig()
    z = np.zeros(B)
    st_t = tpl.PlantState(*(torch.as_tensor(a) for a in (x, v, w, z + 0.1,
                                                         z + 2.0)))
    ref = jax.vmap(lambda xx, vv, ww, cv, cw: jpl.plant_step_mpc_tick(
        jpl.PlantState(xx, vv, ww, 0.1 + 0 * vv, 2.0 + 0 * vv), cv, cw, cfg_j))(
            *map(jnp.asarray, (x, v, w, cmd_v, cmd_w)))
    got = tpl.plant_step_mpc_tick(st_t, torch.as_tensor(cmd_v),
                                  torch.as_tensor(cmd_w), cfg_t)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    fb_ref = jax.vmap(lambda vv, ww: jpl.plant_wheel_feedback(
        jpl.PlantState(jnp.zeros(3), vv, ww, 0 * vv, 0 * vv), JICR(*ICR)))(
            jnp.asarray(v), jnp.asarray(w))
    fb = tpl.plant_wheel_feedback(st_t, TICR(*ICR))
    np.testing.assert_allclose(fb.numpy(), np.asarray(fb_ref), rtol=0,
                               atol=1e-12)


def test_first_order_filter_recurrence():
    """y[k] = (1-a) u[k] + a y[k-1] with a = exp(-2 pi fc / fs), against
    the JAX filter on the same samples (1e-12)."""
    f_t = tekf.FirstOrderFilter.create(0.5, 100.0, torch.float64,
                                       device="cpu")
    f_j = jekf.FirstOrderFilter.create(0.5, 100.0, jnp.float64)
    np.testing.assert_allclose(float(f_t.a), float(f_j.a), rtol=0, atol=1e-15)
    us = np.random.default_rng(0).normal(size=(50, B))
    for u in us:
        f_t, y_t = f_t.step(torch.as_tensor(u))
        f_j, y_j = f_j.step(jnp.asarray(u))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                                   atol=1e-12)
    for _ in range(3000):
        f_t, y_t = f_t.step(torch.ones(B, dtype=torch.float64))
    assert float((y_t - 1.0).abs().max()) < 1e-3


def test_simple_icr_estimate_converges_and_gates():
    """Lanes with informative and with gated (|omega| <= 0.1) yaw rates:
    a steady turn recovers the true ICR within 0.02, as
    tests/test_ekf_aux.py asks, and a gated lane stays exactly 0."""
    st_t = tekf.SimpleIcrState.create(2.0, 100.0, torch.float64,
                                      device="cpu")
    yr, yl, xv = ICR
    rng = np.random.default_rng(1)
    vl = np.array([0.5, 1.0, 0.2])
    vr = np.array([1.5, 1.02, 1.1])            # lane 1: omega = 0.033, gated
    w = (vr - vl) / (yl - yr)
    vx = (vr * yl - vl * yr) / (yl - yr)
    for _ in range(800):
        n = 0.002 * rng.normal(size=(2, B))
        args = (vx + n[0], -xv * w + n[1], w, vx - yl * w, vx - yr * w)
        st_t, est_t = st_t.step(*(torch.as_tensor(a) for a in args))
    est = est_t.numpy()
    np.testing.assert_allclose(est[0], [yl, yr, xv], atol=0.02)
    np.testing.assert_allclose(est[2], [yl, yr, xv], atol=0.02)
    np.testing.assert_array_equal(est[1], 0.0)


def test_simple_icr_estimate_tick_for_tick():
    yr, yl, xv = ICR
    rng = np.random.default_rng(3)
    st_t = tekf.SimpleIcrState.create(0.5, 100.0, torch.float64,
                                      device="cpu")
    sts_j = [jekf.SimpleIcrState.create(0.5, 100.0, jnp.float64)
             for _ in range(B)]
    for _ in range(40):
        vx, vy, wl, wr = rng.normal(size=(4, B))
        w = np.array([0.5, 0.05, -0.8]) + 0.01 * rng.normal(size=B)
        st_t, est_t = st_t.step(*(torch.as_tensor(a)
                                  for a in (vx, vy, w, wl, wr)))
        for b in range(B):
            sts_j[b], est_j = sts_j[b].step(vx[b], vy[b], jnp.asarray(w[b]),
                                            wl[b], wr[b])
            np.testing.assert_allclose(est_t[b].numpy(), np.asarray(est_j),
                                       rtol=0, atol=1e-12)


def test_convergence_monitor_latch_and_reset():
    """The cases of tests/test_ekf_aux.py, per lane: the latch fires on the
    12th consecutive good tick, a violation resets the count and never
    un-latches; every field equals the JAX monitor's at every tick."""
    std = np.array(ICR)
    good, bad = std * 1.005, std * 1.05
    mon_t = tekf.ConvergenceMonitor.create((2,), device="cpu")
    mons_j = [jekf.ConvergenceMonitor.create() for _ in range(2)]
    # lane 0: 12 good ticks then a bad one; lane 1: 8 good, bad, 4 good
    seq0 = [good] * 12 + [bad]
    seq1 = [good] * 8 + [bad] + [good] * 4
    for k, (e0, e1) in enumerate(zip(seq0, seq1)):
        mon_t = mon_t.step(torch.as_tensor(np.stack([e0, e1])),
                           torch.as_tensor(std))
        for b, e in enumerate((e0, e1)):
            mons_j[b] = mons_j[b].step(jnp.asarray(e), std)
            for name in ("count", "converged", "latch_tick"):
                np.testing.assert_array_equal(
                    getattr(mon_t, name)[b].numpy(),
                    np.asarray(getattr(mons_j[b], name)), err_msg=f"{name}@{k}")
        assert int(mon_t.tick) == int(mons_j[0].tick)
        if k < 11:
            assert not bool(mon_t.converged.any())
    assert bool(mon_t.converged[0].all()) and not bool(mon_t.converged[1].any())
    assert (mon_t.latch_tick[0] == 11).all() and (mon_t.latch_tick[1] == -1).all()
    assert (mon_t.count[1] == 4).all() and (mon_t.count[0] == 0).all()


def test_estimator_factories_default_to_the_card(monkeypatch):
    """The factories take no tensor, so `device=None` means CUDA and
    raises without a card, as `run_mission` does; with a device named the
    whole state lies there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: tekf.FirstOrderFilter.create(0.5, 100.0, **kw),
                 lambda **kw: tekf.SimpleIcrState.create(**kw),
                 lambda **kw: tekf.ConvergenceMonitor.create((2,), **kw)):
        with pytest.raises(RuntimeError):
            make()
        state = make(device="cpu")
        leaves = [t for f in state
                  for t in (f if isinstance(f, tuple) else (f,))]
        assert all(t.device.type == "cpu" for t in leaves)


def test_covariance_report_and_monitor_on_ekf_run():
    """EKF + monitor on simulated wheel data, two lanes with different
    starting guesses, beside the JAX filter on lane 0 (1e-9 after 1500
    predict steps); the report is P's diagonal."""
    rng = np.random.default_rng(2)
    dt = 0.01
    std = np.array(ICR)
    guess = np.array([[-0.2, 0.2, 0.1], [-0.35, 0.25, 0.25]])
    st_t = tekf.ekf_init(torch.zeros(2, 3, dtype=torch.float64),
                         torch.as_tensor(guess), dtype=torch.float64)
    st_j = jekf.ekf_init(jnp.zeros(3), jnp.asarray(guess[0]),
                         dtype=jnp.float64)
    mon = tekf.ConvergenceMonitor.create((2,), device="cpu")
    # the JAX side compiled once: eager it re-traces its jacfwd 1500 times
    j_predict = jax.jit(lambda st, u: jekf.ekf_predict(st, u, dt))
    j_update = jax.jit(jekf.ekf_update)
    x_true = np.zeros(3)
    yr, yl, xv = ICR
    for k in range(1500):
        t = k * dt
        vl = 1.0 + 0.8 * np.sin(0.7 * t)
        vr = 1.0 - 0.8 * np.sin(0.9 * t + 1.0)
        w = (vr - vl) / (yl - yr)
        v = (vr * yl - vl * yr) / (yl - yr)
        c, s = np.cos(x_true[2]), np.sin(x_true[2])
        x_true = x_true + dt * np.array([v * c + w * xv * s,
                                         v * s - w * xv * c, w])
        u = np.array([vl, vr])
        st_t = tekf.ekf_predict(st_t, torch.as_tensor(np.stack([u, u])), dt)
        st_j = j_predict(st_j, jnp.asarray(u))
        if k % 5 == 0:
            obs = x_true + 0.001 * rng.normal(size=3)
            st_t = tekf.ekf_update(st_t, torch.as_tensor(np.stack([obs, obs])))
            st_j = j_update(st_j, jnp.asarray(obs))
        if k % 10 == 0:
            mon = mon.step(st_t.x[:, 3:6], torch.as_tensor(std))
    np.testing.assert_allclose(st_t.x[0].numpy(), np.asarray(st_j.x), rtol=0,
                               atol=1e-9)
    pose_var, icr_var = tekf.covariance_report(st_t)
    pv_j, iv_j = jekf.covariance_report(st_j)
    np.testing.assert_allclose(pose_var[0].numpy(), np.asarray(pv_j), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(icr_var[0].numpy(), np.asarray(iv_j), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(
        torch.cat([pose_var, icr_var], -1).numpy(),
        torch.diagonal(st_t.P, dim1=1, dim2=2).numpy())
    assert (icr_var > 0).all() and (icr_var < 0.05).all()
    assert int(mon.tick) == 150
