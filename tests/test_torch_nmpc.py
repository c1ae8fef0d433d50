"""Port parity: the NMPC RTI tick (every mode), the cold-start tick, the
ACADO golden trace and the box QPs.

Inputs are the flagship entry's (`__graft_entry__.entry`: B=64, N=50,
numpy seed 0).  The JAX tick is vmapped; the port's is batched.
Tolerances: 1e-9 in float64 (the same arithmetic; the QP's 4 x 15 CG
trips amplify summation-order differences of ~1e-15 a little) and 1e-4
in float32 (the same trips at float32 rounding, on commands of O(1)).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.control import nmpc as jn
from alore_legged_manipulator_tpu.core.dynamics import ICRParams as JICR
from alore_legged_manipulator_tpu.ops import qp as jqp
from alore_legged_manipulator_tpu.ops.qp import box_qp_pncg
from alore_legged_manipulator_tpu_torch.control import nmpc as tn
from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams as TICR
from alore_legged_manipulator_tpu_torch.core.dynamics import (
    wheel_speeds_from_flat)
from alore_legged_manipulator_tpu_torch.ops import qp as tqp
from alore_legged_manipulator_tpu_torch.ops.qp import box_qp_pncg_op

# one intra-op thread: these tests run beside other test workers, and
# their many small tensor ops only slow down when threads oversubscribe
torch.set_num_threads(1)

B = 64


def _entry_inputs(n=50):
    rng = np.random.default_rng(0)
    x_traj = rng.standard_normal((B, n + 1, 3)) * 0.1
    u_traj = rng.standard_normal((B, n, 2)) * 0.1
    x_est = rng.standard_normal((B, 3)) * 0.1
    ts = 0.01 * np.arange(1, n + 2)
    ref_x = np.broadcast_to(np.stack([ts, 0 * ts, 0 * ts]), (B, 3, n + 1))
    ref_u = np.ones((B, 2, n + 1))
    return x_traj, u_traj, x_est, np.ascontiguousarray(ref_x), ref_u


def _run_both(dtype_np, icr_j, icr_t, cfg_kw=None):
    cfg_j = jn.NmpcConfig(**(cfg_kw or {}))
    cfg_t = tn.NmpcConfig(**(cfg_kw or {}))
    args = [a.astype(dtype_np) for a in _entry_inputs(cfg_j.horizon)]
    in_axes = (0, 0, 0, 0, 0, 0 if isinstance(icr_j.yr, jnp.ndarray) else None)

    def one(xt, ut, xe, rx, ru, icr):
        c, u, xp, up = jn.nmpc_rti_step(jn.NmpcCarry(xt, ut), xe, rx, ru, icr,
                                        cfg_j)
        return c.x_traj, c.u_traj, u, xp, up

    ref = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, 0,
                                         JICR(*(in_axes[5],) * 3))))(
        *[jnp.asarray(a) for a in args], icr_j)
    t = [torch.as_tensor(a) for a in args]
    c, u, xp, up = tn.nmpc_rti_step(tn.NmpcCarry(t[0], t[1]), t[2], t[3],
                                    t[4], icr_t, cfg_t)
    return ref, (c.x_traj, c.u_traj, u, xp, up)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9),
                                       (np.float32, 1e-4)])
def test_rti_step_matches_entry(dtype, tol):
    ref, got = _run_both(dtype, JICR(-0.3, 0.3, 0.2), TICR(-0.3, 0.3, 0.2))
    for r, g in zip(ref, got):
        assert g.dtype == torch.float64 if dtype == np.float64 else torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=tol)


def test_rti_step_per_lane_icr():
    """The closed loop feeds each lane its own EKF ICR estimate."""
    rng = np.random.default_rng(3)
    yr = -0.3 + 0.05 * rng.standard_normal(B)
    yl = 0.3 + 0.05 * rng.standard_normal(B)
    xv = 0.2 + 0.05 * rng.standard_normal(B)
    ref, got = _run_both(np.float64,
                         JICR(jnp.asarray(yr), jnp.asarray(yl),
                              jnp.asarray(xv)),
                         TICR(torch.as_tensor(yr), torch.as_tensor(yl),
                              torch.as_tensor(xv)))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-9)


def test_box_qp_pncg_op_matches():
    """Dense SPD Hessians with active bounds; 8 Newton x 30 CG trips.
    Tolerance 1e-10 in float64 (same trips, summation order only)."""
    rng = np.random.default_rng(5)
    n, Bq = 24, 16
    M = rng.standard_normal((Bq, n, n))
    H = M @ M.transpose(0, 2, 1) / n + 0.5 * np.eye(n)
    g = rng.standard_normal((Bq, n)) * 3.0
    lb, ub = -np.ones((Bq, n)) * 0.7, np.ones((Bq, n)) * 0.9
    ref = jax.vmap(lambda h, gg, l, u: box_qp_pncg(h, gg, l, u, iters=8,
                                                   cg_iters=30))(
        *(jnp.asarray(a) for a in (H, g, lb, ub)))
    Ht = torch.as_tensor(H)

    def matvec(p):
        extra = p.dim() - 2
        Hb = Ht.reshape(Bq, *([1] * extra), n, n)
        return (Hb @ p[..., None])[..., 0]

    got = box_qp_pncg_op(matvec, torch.diagonal(Ht, dim1=1, dim2=2),
                         torch.as_tensor(g), torch.as_tensor(lb),
                         torch.as_tensor(ub), iters=8, cg_iters=30)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-10)
    # the bounds are really active
    assert (np.isclose(got.numpy(), lb) | np.isclose(got.numpy(), ub)).any()


def test_exact_step_and_prepare_tri():
    rng = np.random.default_rng(8)
    cfg_j, cfg_t = jn.NmpcConfig(), tn.NmpcConfig()
    x = rng.standard_normal((B, 51, 3))
    u = rng.standard_normal((B, 50, 2)) * 2.0
    u[:, ::7, 1] = u[:, ::7, 0]            # w == 0 stages (sinc limit)
    ref = jax.vmap(lambda a, b: jn.prepare_tri(jn.NmpcCarry(a, b),
                                               JICR(-0.3, 0.3, 0.2), cfg_j))(
        jnp.asarray(x), jnp.asarray(u))
    got = tn.prepare_tri(tn.NmpcCarry(torch.as_tensor(x), torch.as_tensor(u)),
                         TICR(-0.3, 0.3, 0.2), cfg_t)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-12)
    ex_ref = jn.exact_step(jnp.asarray(x[:, 0]), jnp.asarray(u[:, 0]),
                           JICR(-0.3, 0.3, 0.2), 0.01)
    ex = tn.exact_step(torch.as_tensor(x[:, 0]), torch.as_tensor(u[:, 0]),
                       TICR(-0.3, 0.3, 0.2), 0.01)
    np.testing.assert_allclose(ex.numpy(), np.asarray(ex_ref), rtol=0,
                               atol=1e-12)


def test_rti_step_rejects_other_modes():
    """Every documented mode runs (see test_rti_step_modes_match_jax); an
    unknown condensing mode raises KeyError, as in the JAX package."""
    t = [torch.as_tensor(a) for a in _entry_inputs()]
    for side, carry, args, icr, cfg in (
            (tn, tn.NmpcCarry(t[0], t[1]), t[2:], TICR(),
             tn.NmpcConfig(qp_mode="dense", condense_mode="banana")),
            (jn, jn.NmpcCarry(*(jnp.asarray(a[0].numpy()) for a in t[:2])),
             [jnp.asarray(a[0].numpy()) for a in t[2:]], JICR(),
             jn.NmpcConfig(qp_mode="dense", condense_mode="banana"))):
        with pytest.raises(KeyError):
            side.nmpc_rti_step(carry, *args, icr, cfg)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cpu_feedback_is_the_plain_path_bit_for_bit(dtype, monkeypatch):
    """On CPU tensors `feedback` never loads the card's kernel and returns
    `_feedback_matfree`'s tensors bit for bit (the matrix-free path the
    CPU ran before the kernel existed)."""
    from alore_legged_manipulator_tpu_torch.ops import (
        nmpc_feedback_cuda as nfc)

    def forbidden(*a, **k):
        raise AssertionError("the feedback kernel was reached on the CPU")

    monkeypatch.setattr(nfc, "_load", forbidden)
    monkeypatch.setattr(tn, "nmpc_feedback_cuda", forbidden)
    t = [torch.as_tensor(a.astype(dtype)) for a in _entry_inputs()]
    cfg, icr = tn.NmpcConfig(), TICR(-0.3, 0.3, 0.2)
    carry = tn.NmpcCarry(t[0], t[1])
    prep = tn._linearize(carry, icr, cfg)
    got = tn.feedback(carry, prep, t[2], t[3], t[4], icr, cfg)
    want = tn._feedback_matfree(carry, prep, t[2], t[3], t[4], cfg)
    for a, b in zip((*got[0], *got[1:]), (*want[0], *want[1:])):
        assert torch.equal(a, b)


MODES = [dict(qp_mode="dense", condense_mode="triangular"),
         dict(qp_mode="dense", condense_mode="assoc"),
         dict(qp_mode="dense", condense_mode="seq"),
         dict(qp_mode="matfree", condense_mode="assoc"),
         dict(qp_mode="matfree", condense_mode="triangular",
              integrator="rk4"),
         dict(qp_mode="dense", condense_mode="seq", integrator="rk4")]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(m.values()))
def test_rti_step_modes_match_jax(mode):
    """Each condenser / QP / integrator combination against the JAX tick
    on the entry inputs: 1e-9 in f64 (the same trips; the condensers sum
    in different orders, and the QP's CG trips amplify that a little)."""
    ref, got = _run_both(np.float64, JICR(-0.3, 0.3, 0.2),
                         TICR(-0.3, 0.3, 0.2), mode)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-9)


def test_rti_step_modes_agree_f32():
    """The dense modes against the fast path in f32: u_cmd within 1e-4."""
    t = [torch.as_tensor(a.astype(np.float32)) for a in _entry_inputs()]
    outs = {}
    for name, kw in [("fast", {})] + [("-".join(m.values()), m)
                                      for m in MODES[:3]]:
        outs[name] = tn.nmpc_rti_step(tn.NmpcCarry(t[0], t[1]), t[2], t[3],
                                      t[4], TICR(-0.3, 0.3, 0.2),
                                      tn.NmpcConfig(**kw))[1]
    for name, u in outs.items():
        assert u.dtype == torch.float32
        np.testing.assert_allclose(u.numpy(), outs["fast"].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_prep_icr_only_moves_the_linearization():
    """prep_icr is consumed by prepare alone; against JAX to 1e-9."""
    cfg_j, cfg_t = jn.NmpcConfig(), tn.NmpcConfig()
    args = _entry_inputs()

    def one(xt, ut, xe, rx, ru):
        c, u, xp, up = jn.nmpc_rti_step(
            jn.NmpcCarry(xt, ut), xe, rx, ru, JICR(-0.3, 0.3, 0.2), cfg_j,
            prep_icr=JICR(-0.25, 0.33, 0.1))
        return u, xp
    ref = jax.vmap(one)(*[jnp.asarray(a) for a in args])
    t = [torch.as_tensor(a) for a in args]
    _, u, xp, _ = tn.nmpc_rti_step(tn.NmpcCarry(t[0], t[1]), t[2], t[3], t[4],
                                   TICR(-0.3, 0.3, 0.2), cfg_t,
                                   prep_icr=TICR(-0.25, 0.33, 0.1))
    np.testing.assert_allclose(u.numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(xp.numpy(), np.asarray(ref[1]), rtol=0,
                               atol=1e-9)
    _, u_same, _, _ = tn.nmpc_rti_step(tn.NmpcCarry(t[0], t[1]), t[2], t[3],
                                       t[4], TICR(-0.3, 0.3, 0.2), cfg_t)
    assert float((u - u_same).abs().max()) > 1e-6


@pytest.mark.parametrize("integrator", ["exact", "rk4"])
def test_prepare_matches_jacfwd(integrator):
    """`prepare` against the JAX package's jacfwd linearization, 1e-10 in
    f64, with per-lane ICR estimates and w == 0 stages."""
    rng = np.random.default_rng(8)
    cfg_j = jn.NmpcConfig(integrator=integrator)
    cfg_t = tn.NmpcConfig(integrator=integrator)
    nb = 8
    x = rng.standard_normal((nb, 51, 3))
    u = rng.standard_normal((nb, 50, 2)) * 2.0
    u[:, ::7, 1] = u[:, ::7, 0]
    yr = -0.3 + 0.05 * rng.standard_normal(nb)
    yl = 0.3 + 0.05 * rng.standard_normal(nb)
    xv = 0.2 + 0.05 * rng.standard_normal(nb)
    ref = jax.vmap(lambda a, b, i: jn.prepare(jn.NmpcCarry(a, b), i, cfg_j))(
        jnp.asarray(x), jnp.asarray(u),
        JICR(jnp.asarray(yr), jnp.asarray(yl), jnp.asarray(xv)))
    got = tn.prepare(tn.NmpcCarry(torch.as_tensor(x), torch.as_tensor(u)),
                     TICR(torch.as_tensor(yr), torch.as_tensor(yl),
                          torch.as_tensor(xv)), cfg_t)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-10)
    # shared float ICR takes the same path
    ref = jax.vmap(lambda a, b: jn.prepare(jn.NmpcCarry(a, b),
                                           JICR(-0.3, 0.3, 0.2), cfg_j))(
        jnp.asarray(x), jnp.asarray(u))
    got = tn.prepare(tn.NmpcCarry(torch.as_tensor(x), torch.as_tensor(u)),
                     TICR(-0.3, 0.3, 0.2), cfg_t)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-10)


def test_rk4_step_matches():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, 3))
    u = rng.standard_normal((B, 2)) * 2.0
    ref = jn.rk4_step(jnp.asarray(x), jnp.asarray(u), JICR(-0.3, 0.3, 0.2),
                      0.01)
    got = tn.rk4_step(torch.as_tensor(x), torch.as_tensor(u),
                      TICR(-0.3, 0.3, 0.2), 0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-14)


@pytest.mark.parametrize("integrator", ["exact", "rk4"])
def test_condensers_match_jax_and_each_other(integrator):
    """seq / assoc / triangular: each against its JAX twin (1e-11) and
    all three against each other (1e-10), in f64."""
    rng = np.random.default_rng(10)
    nb, n = 6, 50
    cfg_j = jn.NmpcConfig(integrator=integrator)
    cfg_t = tn.NmpcConfig(integrator=integrator)
    x = rng.standard_normal((nb, n + 1, 3)) * 0.3
    u = rng.standard_normal((nb, n, 2))
    dx0 = rng.standard_normal((nb, 3)) * 0.1
    icr_j, icr_t = JICR(-0.3, 0.3, 0.2), TICR(-0.3, 0.3, 0.2)
    xt, ut, dt0 = (torch.as_tensor(a) for a in (x, u, dx0))
    prep_t = tn.prepare(tn.NmpcCarry(xt, ut), icr_t, cfg_t)
    outs = {}
    for name in ("_condense_seq", "_condense", "_condense_triangular"):
        def one(a, b, d0, fn=getattr(jn, name)):
            xi, A, Bm = jn.prepare(jn.NmpcCarry(a, b), icr_j, cfg_j)
            return fn(a, xi, A, Bm, d0, n)
        C_ref, e_ref = jax.vmap(one)(jnp.asarray(x), jnp.asarray(u),
                                     jnp.asarray(dx0))
        C, e = getattr(tn, name)(xt, *prep_t, dt0, n)
        assert C.shape == C_ref.shape == (nb, n + 1, 3, 2 * n)
        np.testing.assert_allclose(C.numpy(), np.asarray(C_ref), rtol=0,
                                   atol=1e-11)
        np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=0,
                                   atol=1e-11)
        outs[name] = (C, e)
    for name in ("_condense", "_condense_triangular"):
        for a, b in zip(outs[name], outs["_condense_seq"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-10)
    # the matrix-free operators apply the same map
    ops = tn._tri_ops(xt, *prep_t, dt0, n)
    p2 = torch.as_tensor(rng.standard_normal((nb, n, 2)))
    Cp = torch.matmul(outs["_condense_seq"][0],
                      p2.reshape(nb, 1, -1, 1))[..., 0]
    np.testing.assert_allclose(tn._tri_cmat(ops, p2).numpy(), Cp.numpy(),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("mode", [{}, MODES[0], MODES[2]],
                         ids=["fast", "dense-tri", "dense-seq"])
def test_cold_start_step_matches_jax(mode):
    """The constructor-prepared first tick (ICR hard-coded to (-0.2, 0.2,
    0.0), x_est added after the solve) against JAX, 1e-9 in f64."""
    cfg_j, cfg_t = jn.NmpcConfig(**mode), tn.NmpcConfig(**mode)
    _, _, x_est, ref_x, ref_u = _entry_inputs()
    x_est = x_est + np.array([0.4, -0.2, 0.1])
    ref = jax.vmap(lambda xe, rx, ru: jn.nmpc_cold_start_step(
        xe, rx, ru, cfg_j, jnp.float64))(
            *(jnp.asarray(a) for a in (x_est, ref_x, ref_u)))
    got = tn.nmpc_cold_start_step(*(torch.as_tensor(a)
                                    for a in (x_est, ref_x, ref_u)),
                                  cfg_t, torch.float64)
    for r, g in zip(jax.tree.leaves(ref), [*got[0], *got[1:]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-9)
    # the carry's states sit on x_est, its first row exactly
    np.testing.assert_array_equal(got[0].x_traj[:, 0].numpy(), x_est)


def test_dense_qps_match_jax():
    """box_qp_pncg (1e-10), box_qp_projected_newton (1e-7: an LU solve
    per trip by two different libraries, and the 8-halvings search may
    pick another candidate on a tie in the last bits; both sides are
    then held to a KKT residual below 1e-8), box_qp_admm (1e-9: 100
    Cholesky solves) and the KKT
    residual (1e-10) on SPD Hessians with active bounds, f64."""
    rng = np.random.default_rng(5)
    n, Bq = 24, 16
    M = rng.standard_normal((Bq, n, n))
    H = M @ M.transpose(0, 2, 1) / n + 0.5 * np.eye(n)
    g = rng.standard_normal((Bq, n)) * 3.0
    lb, ub = -np.ones((Bq, n)) * 0.7, np.ones((Bq, n)) * 0.9
    ja = [jnp.asarray(a) for a in (H, g, lb, ub)]
    ta = [torch.as_tensor(a) for a in (H, g, lb, ub)]
    for name, kw, tol in (("box_qp_pncg", dict(iters=8, cg_iters=30), 1e-10),
                          ("box_qp_projected_newton", dict(iters=12), 1e-7),
                          ("box_qp_admm", dict(iters=100), 1e-9)):
        ref = jax.vmap(lambda h, gg, l, u: getattr(jqp, name)(h, gg, l, u,
                                                              **kw))(*ja)
        got = getattr(tqp, name)(*ta, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=tol, err_msg=name)
    z = tqp.box_qp_projected_newton(*ta)
    res_ref = jax.vmap(jqp.box_qp_kkt_residual)(*ja, jnp.asarray(z.numpy()))
    res = tqp.box_qp_kkt_residual(*ta, z)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_ref), rtol=0,
                               atol=1e-10)
    assert float(res.max()) < 1e-8          # solved
    zw = tqp.box_qp_pncg(*ta, z0=z, iters=1, cg_iters=5)      # warm start
    np.testing.assert_allclose(zw.numpy(), z.numpy(), rtol=0, atol=1e-6)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "acado_nmpc_circle.txt")


def _run_port_closed_loop(n_ticks, dtype, mode=None):
    """The golden trace's loop on the port: circle reference (R = 2 m,
    v = 1 m/s), RK4 plant at dt = 0.01 driven by the tick's command."""
    icr = TICR(yr=-0.3, yl=0.3, xv=0.2)
    cfg = tn.NmpcConfig(delay_num=0, **(mode or {}))
    x = torch.tensor([[0.05, -0.10, 0.30]], dtype=dtype)
    carry = tn.nmpc_init(cfg, x, dtype)
    w, v = 0.5, 1.0
    vl, vr = wheel_speeds_from_flat(w, v, icr)
    xs, us = [], []
    for k in range(n_ticks):
        ts = (k + torch.arange(1, cfg.horizon + 2, dtype=dtype)) * cfg.dt
        yaw = w * ts
        rx = v / w * torch.sin(yaw) - icr.xv * (torch.cos(yaw) - 1.0)
        ry = -v / w * (torch.cos(yaw) - 1.0) - icr.xv * torch.sin(yaw)
        ref_x = torch.stack([rx, ry, yaw])[None]
        ref_u = torch.stack([torch.full_like(ts, vr),
                             torch.full_like(ts, vl)])[None]
        carry, u_cmd, _, _ = tn.nmpc_rti_step(carry, x, ref_x, ref_u, icr,
                                              cfg)
        xs.append(x[0].numpy())
        us.append(u_cmd[0].numpy())
        x = tn.rk4_step(x, u_cmd, icr, cfg.dt)
    return np.stack(xs), np.stack(us)


@pytest.mark.parametrize("dtype,tol,mode", [
    (torch.float64, 1e-3, None),
    (torch.float32, 2e-3, None),
    (torch.float64, 1e-3, dict(qp_mode="dense", condense_mode="assoc",
                               integrator="rk4"))],
    ids=["f64", "f32", "f64-dense-assoc-rk4"])
def test_closed_loop_parity_with_acado_reference(dtype, tol, mode):
    """The reference C++ NMPC's 120-tick golden trace against the port,
    with the tolerances of tests/test_nmpc_parity.py: trajectory and
    steady-state (tick >= 40) controls within 1e-3 in f64 and 2e-3 in
    f32, transient commands within 0.6, wheel bounds respected."""
    golden = np.loadtxt(GOLDEN)
    xs_ref, us_ref = golden[:, 1:4], golden[:, 4:6]
    xs, us = _run_port_closed_loop(golden.shape[0], dtype, mode)
    assert np.linalg.norm(xs[:, :2] - xs_ref[:, :2], axis=1).max() < tol
    assert np.abs(xs[:, 2] - xs_ref[:, 2]).max() < tol
    assert np.abs(us[40:] - us_ref[40:]).max() < tol
    assert np.abs(us - us_ref).max() < 0.6
    assert np.abs(us).max() <= 3.0 + 1e-6
