"""Port parity: the OSQP-style ADMM (`qp_admm_general`) and the LTV-MPC
(`control/ltv_mpc.py`).

* `qp_admm_general` against JAX on random QPs with equality, box and
  general inequality rows (numpy seed 0, 3 lanes, the JAX solver
  vmapped): 1e-10 at float64 (the same iteration; the two Cholesky
  solves round differently in the last bits, and 200 relaxed steps
  carry that along: 4.8e-13 seen) and 2e-3 at float32, on solutions of
  O(1): the float32 iteration itself moves the solution 4.0e-4 (JAX)
  and 4.7e-4 (port) from the float64 one, and the two sides 5.0e-4
  apart.  The analytic projection case of tests/test_ltv_mpc.py holds
  the port.
* `_rollout` and `_build_qp` against JAX at float64 on random rollouts
  (delay_num 0, 1, 2): the rollout to 1e-13 (libm's cos and sin against
  XLA's, summed over 30 steps), the QP matrices entry for entry --
  bit for bit where they depend on the config alone, to 1e-15 where
  they are built from the rollout (the same arithmetic on the same
  xbar, one libm call apart).
* `ltv_mpc_tick` against JAX at float64 (delay_num 0, 1, 2): command,
  planned sequence and delay buffer to 1e-8; at float32 to 1e-3.
* The five LTV goldens of the compiled reference (tests/golden/ltv)
  held to the port with tests/test_ltv_parity.py's own tolerances: QP
  assembly to 1e-12, the ADMM solution (4000 iterations) to 2e-5, the
  full tick at float64 (command 5e-5, sequence 2e-4, buffer 5e-5), and
  the float32 pair (command 5e-3).
* Closed-loop tracking of a line on the unicycle (tests/test_ltv_mpc.py's
  bounds), several lanes at once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.control import ltv_mpc as jl
from alore_legged_manipulator_tpu.ops.qp import qp_admm_general as j_admm
from alore_legged_manipulator_tpu_torch.control import ltv_mpc as tl
from alore_legged_manipulator_tpu_torch.ops.qp import qp_admm_general
from alore_legged_manipulator_tpu_torch.utils.angles import (
    smooth_yaw_sequence)
from tests.test_ltv_parity import SCENARIOS
from tests.test_ltv_parity import _load as load_golden

torch.set_num_threads(1)

TDT = {"f64": torch.float64, "f32": torch.float32}
JDT = {"f64": jnp.float64, "f32": jnp.float32}


def _random_qp(rng, B=3, n=12, m_eq=4, m_in=6):
    Ms = rng.standard_normal((B, n, n))
    H = np.einsum("bij,bkj->bik", Ms, Ms) / n + 0.1 * np.eye(n)
    g = rng.standard_normal((B, n))
    A = np.concatenate([rng.standard_normal((B, m_eq, n)),
                        np.broadcast_to(np.eye(n)[:m_in], (B, m_in, n)),
                        rng.standard_normal((B, 3, n))], axis=1)
    beq = rng.standard_normal((B, m_eq)) * 0.3
    lb = np.concatenate([beq, -np.full((B, m_in), 0.5),
                         -np.full((B, 3), 1.0)], axis=1)
    ub = np.concatenate([beq, np.full((B, m_in), 0.5),
                         rng.uniform(0.0, 1.0, (B, 3))], axis=1)
    return H, g, A, lb, ub


@pytest.mark.parametrize("prec,tol", [("f64", 1e-10), ("f32", 2e-3)])
def test_qp_admm_general_matches_jax(prec, tol):
    H, g, A, lb, ub = _random_qp(np.random.default_rng(0))
    jd, td = JDT[prec], TDT[prec]
    xj, yj = jax.vmap(lambda *a: j_admm(*a, iters=200))(
        *(jnp.asarray(v, jd) for v in (H, g, A, lb, ub)))
    xt, yt = qp_admm_general(*(torch.as_tensor(v, dtype=td)
                               for v in (H, g, A, lb, ub)), iters=200)
    assert xt.dtype == td
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=tol)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=10 * tol)
    # and it solved the problem: equality rows to the ADMM's accuracy
    r = np.einsum("bmn,bn->bm", A, xt.double().numpy())
    assert np.abs(r[:, :4] - lb[:, :4]).max() < 1e-3


def test_qp_admm_general_equality_and_bounds():
    """min ||x - c||^2 s.t. sum(x) = 1, 0 <= x <= 0.6: the projection of
    c, clip(c - 0.05, 0, 0.6) = (0.6, 0.05, 0, 0.35) (tests/test_ltv_mpc.py's
    analytic case)."""
    n = 4
    c = torch.tensor([[0.9, 0.1, -0.3, 0.4]], dtype=torch.float64)
    H = 2.0 * torch.eye(n, dtype=torch.float64)[None]
    A = torch.cat([torch.ones(1, n), torch.eye(n)]).double()[None]
    lb = torch.cat([torch.ones(1), torch.zeros(n)]).double()[None]
    ub = torch.cat([torch.ones(1), torch.full((n,), 0.6)]).double()[None]
    x, _ = qp_admm_general(H, -2.0 * c, A, lb, ub, iters=2000, rho=1.0)
    np.testing.assert_allclose(x[0].numpy(), [0.6, 0.05, 0.0, 0.35],
                               atol=1e-3)


def _problem(rng, cfg, B=2):
    T = cfg.horizon
    x0 = np.stack([rng.uniform(-1, 1, B), rng.uniform(-1, 1, B),
                   rng.uniform(-3, 3, B)], -1)
    output = np.stack([rng.uniform(-0.5, 2.0, (B, T)),
                       rng.uniform(-4.0, 4.0, (B, T))], 1)
    ts = 0.01 * np.arange(1, T + 1)
    xref = np.stack([x0[:, :1] + ts, x0[:, 1:2] + 0.3 * ts,
                     np.zeros((B, T)), x0[:, 2:3] + 0.5 * ts], 1)
    dref = np.stack([np.full((B, T), 1.0), np.full((B, T), 0.5)], 1)
    buff = rng.uniform(-1, 1, (B, max(cfg.delay_num, 1), 2))
    return x0, output, xref, dref, buff


def _jax_carry(output, buff, dtype):
    return jl.LtvMpcCarry(output=jnp.asarray(output, dtype),
                          delay_buff=jnp.asarray(buff, dtype))


def _port_carry(output, buff, dtype):
    return tl.LtvMpcCarry(output=torch.as_tensor(output, dtype=dtype),
                          delay_buff=torch.as_tensor(buff, dtype=dtype))


@pytest.mark.parametrize("delay", [0, 1, 2])
def test_rollout_and_qp_assembly_match_jax(delay):
    cfg = jl.LtvMpcConfig(delay_num=delay)
    tcfg = tl.LtvMpcConfig(delay_num=delay)
    x0, output, xref, dref, buff = _problem(np.random.default_rng(delay), cfg)
    B = x0.shape[0]
    xt = tl._rollout(torch.as_tensor(x0), torch.as_tensor(output), tcfg)
    for b in range(B):
        xj = jl._rollout(jnp.asarray(x0[b]), jnp.asarray(output[b]), cfg)
        np.testing.assert_allclose(xt[b].numpy(), np.asarray(xj), rtol=0,
                                   atol=1e-13)
        # the assembly on JAX's own rollout
        qj = jl._build_qp(xj, jnp.asarray(xref[b]), jnp.asarray(dref[b]),
                          _jax_carry(output[b], buff[b], jnp.float64), cfg)
        qt = tl._build_qp(torch.as_tensor(np.asarray(xj))[None],
                          torch.as_tensor(xref[b:b + 1]),
                          torch.as_tensor(dref[b:b + 1]),
                          _port_carry(output[b:b + 1], buff[b:b + 1],
                                      torch.float64), tcfg)
        for name, a, c in zip(("H", "g", "A", "lb", "ub"), qt, qj):
            c = np.asarray(c)
            assert a.shape[1:] == c.shape, name
            a = a[0].numpy()
            # the config-only entries bit for bit, the rest to 1e-15
            dep = np.zeros(c.shape, bool)
            if name == "A":
                lay = tl._qp_layout(tcfg, torch.float64, torch.device("cpu"))
                dep[lay.rows.numpy(), lay.cols.numpy()] = True
            elif name in ("lb", "ub"):
                n_st = cfg.horizon - delay
                dep[2 * n_st:5 * n_st] = True
            np.testing.assert_array_equal(a[~dep], c[~dep], err_msg=name)
            np.testing.assert_allclose(a[dep], c[dep], rtol=0, atol=1e-15,
                                       err_msg=name)


@pytest.mark.parametrize("prec,tol", [("f64", 1e-8), ("f32", 1e-3)])
@pytest.mark.parametrize("delay", [0, 1, 2])
def test_tick_matches_jax(delay, prec, tol):
    cfg = jl.LtvMpcConfig(delay_num=delay)
    tcfg = tl.LtvMpcConfig(delay_num=delay)
    x0, output, xref, dref, buff = _problem(np.random.default_rng(10 + delay),
                                            cfg)
    jd, td = JDT[prec], TDT[prec]
    cj, uj = jax.vmap(lambda c, x, xr, dr: jl.ltv_mpc_tick(c, x, xr, dr, cfg))(
        _jax_carry(output, buff, jd), jnp.asarray(x0, jd),
        jnp.asarray(xref, jd), jnp.asarray(dref, jd))
    ct, ut = tl.ltv_mpc_tick(_port_carry(output, buff, td),
                             torch.as_tensor(x0, dtype=td),
                             torch.as_tensor(xref, dtype=td),
                             torch.as_tensor(dref, dtype=td), tcfg)
    assert ut.dtype == td and ut.shape == (x0.shape[0], 2)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=tol)
    np.testing.assert_allclose(ct.output.numpy(), np.asarray(cj.output),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(ct.delay_buff.numpy(),
                               np.asarray(cj.delay_buff), rtol=0, atol=tol)


def _golden(name):
    cfg, state, xref, dref, output, buff, g = load_golden(name)
    tcfg = tl.LtvMpcConfig(**cfg._asdict())
    d = max(cfg.delay_num, 1)
    db = np.zeros((d, 2))
    db[:buff.shape[0]] = buff
    return tcfg, state, xref, dref, output, db, g


@pytest.mark.parametrize("name", SCENARIOS)
def test_golden_qp_assembly(name):
    cfg, state, xref, dref, output, db, g = _golden(name)
    carry = _port_carry(output[None], db[None], torch.float64)
    xbar = tl._rollout(torch.as_tensor(state[:3])[None], carry.output, cfg)
    H, grad, A, lb, ub = tl._build_qp(xbar, torch.as_tensor(xref)[None],
                                      torch.as_tensor(dref)[None], carry, cfg)
    for a, key in ((H, "P"), (grad, "q"), (A, "A"), (lb, "lb"), (ub, "ub")):
        np.testing.assert_allclose(a[0].numpy(), g[key], atol=1e-12,
                                   err_msg=key)


@pytest.mark.parametrize("name", SCENARIOS)
def test_golden_qp_solution(name):
    g = _golden(name)[-1]
    sol, _ = qp_admm_general(*(torch.as_tensor(g[k])[None]
                               for k in ("P", "q", "A", "lb", "ub")),
                             iters=4000, rho=0.4)
    np.testing.assert_allclose(sol[0].numpy(), g["sol0"], atol=2e-5, rtol=0)


def _golden_tick(name, dtype, admm_iters):
    cfg, state, xref, dref, output, db, g = _golden(name)
    cfg = cfg._replace(admm_iters=admm_iters)
    carry = _port_carry(output[None], db[None], dtype)

    def t(a):
        return torch.as_tensor(np.asarray(a)[None], dtype=dtype)
    new_carry, cmd = tl.ltv_mpc_tick(carry, t(state[:3]), t(xref), t(dref),
                                     cfg)
    return cfg, g, new_carry, cmd


@pytest.mark.parametrize("name", SCENARIOS)
def test_golden_full_tick_f64(name):
    cfg, g, new_carry, cmd = _golden_tick(name, torch.float64, 4000)
    np.testing.assert_allclose(cmd[0].numpy(), g["cmd"], atol=5e-5)
    np.testing.assert_allclose(new_carry.output[0].numpy(), g["out"],
                               atol=2e-4)
    if cfg.delay_num > 0:
        np.testing.assert_allclose(
            new_carry.delay_buff[0, -cfg.delay_num:].numpy(),
            g["buff_after"], atol=5e-5)


@pytest.mark.parametrize("name", ["curve_d1", "tightturn_d2", "yawwrap_d1"])
def test_golden_full_tick_f32(name):
    _, g, _, cmd = _golden_tick(name, torch.float32, 2000)
    np.testing.assert_allclose(cmd[0].numpy(), g["cmd"], atol=5e-3)


def test_golden_yaw_smoothing_is_the_ports():
    """The goldens' yaw references go through smooth_yaw before the tick;
    the port's smooth_yaw_sequence gives the JAX package's values."""
    from alore_legged_manipulator_tpu.utils.angles import (
        smooth_yaw_sequence as j_smooth)
    rng = np.random.default_rng(3)
    yaw = rng.uniform(-np.pi, np.pi, (4, 30))
    est = rng.uniform(-np.pi, np.pi, 4)
    ref = jax.vmap(j_smooth)(jnp.asarray(est), jnp.asarray(yaw))
    got = smooth_yaw_sequence(torch.as_tensor(est), torch.as_tensor(yaw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


def test_tracks_a_line():
    """Track a straight line at 1 m/s on the unicycle plant from three
    offsets at once (tests/test_ltv_mpc.py's bounds)."""
    cfg = tl.LtvMpcConfig()
    dt = torch.float64
    x = torch.tensor([[0.0, 0.05, 0.1], [0.0, -0.1, -0.2], [0.0, 0.0, 0.0]],
                     dtype=dt)
    B = x.shape[0]
    carry = tl.ltv_mpc_init(cfg, dt, batch=B, device="cpu")
    errs, cmds = [], []
    k_h = torch.arange(1, cfg.horizon + 1, dtype=dt)
    for k in range(250):
        ts = (k * cfg.dt + cfg.dt * k_h).expand(B, -1)
        xref = torch.stack([ts, torch.zeros_like(ts), torch.ones_like(ts),
                            torch.zeros_like(ts)], 1)
        dref = torch.stack([torch.ones_like(ts), torch.zeros_like(ts)], 1)
        carry, cmd = tl.ltv_mpc_tick(carry, x, xref, dref, cfg)
        v, w, th = cmd[:, 0], cmd[:, 1], x[:, 2]
        x = torch.stack([x[:, 0] + v * torch.cos(th) * cfg.dt,
                         x[:, 1] + v * torch.sin(th) * cfg.dt,
                         x[:, 2] + w * cfg.dt], 1)
        errs.append(torch.hypot(x[:, 0] - (k + 1) * cfg.dt, x[:, 1]))
        cmds.append(cmd)
    errs = torch.stack(errs).numpy()
    cmds = torch.stack(cmds).numpy()
    assert errs[-1].max() < 0.03, errs[-1]
    assert errs[200:].max() < 0.05
    assert np.abs(cmds[..., 0]).max() <= cfg.max_speed + 1e-6
    assert np.abs(cmds[..., 1]).max() <= cfg.max_omega + 1e-6
    dv = np.abs(np.diff(cmds[5:, :, 0], axis=0))
    assert dv.max() <= cfg.max_acc * cfg.dt * 3.0 + 1e-3


def test_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tl.ltv_mpc_init(tl.LtvMpcConfig())
