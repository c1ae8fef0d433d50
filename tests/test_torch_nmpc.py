"""Port parity: the NMPC RTI tick (fast path) and the box QP.

Inputs are the flagship entry's (`__graft_entry__.entry`: B=64, N=50,
numpy seed 0).  The JAX tick is vmapped; the port's is batched.
Tolerances: 1e-9 in float64 (the same arithmetic; the QP's 4 x 15 CG
trips amplify summation-order differences of ~1e-15 a little) and 1e-4
in float32 (the same trips at float32 rounding, on commands of O(1)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.control import nmpc as jn
from alore_legged_manipulator_tpu.core.dynamics import ICRParams as JICR
from alore_legged_manipulator_tpu.ops.qp import box_qp_pncg
from alore_legged_manipulator_tpu_torch.control import nmpc as tn
from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams as TICR
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
    t = [torch.as_tensor(a) for a in _entry_inputs()]
    with pytest.raises(NotImplementedError):
        tn.nmpc_rti_step(tn.NmpcCarry(t[0], t[1]), t[2], t[3], t[4],
                         TICR(), tn.NmpcConfig(qp_mode="dense"))
