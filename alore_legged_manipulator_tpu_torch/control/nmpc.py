"""NMPC trajectory-tracking controller, real-time iteration (port of
control/nmpc.py, fast path: exact integrator, triangular condensing,
matrix-free QP).

Problem (UAV_CAR_model.cpp:38-56, 97-103): state (x, y, psi), control
(vr, vl), OnlineData = ICR; horizon N = 50, dt = 0.01 s; wheel bounds
+-3 m/s; LSQ cost with diagonal Q, R; Gauss-Newton Hessian, multiple
shooting.  The exact step's Jacobians are unit upper triangular, so the
condensing map C and the QP Hessian C'QC + R are applied through prefix
/ suffix sums of per-stage scalars and never materialized.  Every
tensor has a leading lane axis; ICR fields may be floats or (B,)
tensors (the per-lane EKF estimates).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.dynamics import ICRParams
from ..ops.qp import box_qp_pncg_op

NX = 3
NU = 2


class NmpcConfig(NamedTuple):
    horizon: int = 50
    dt: float = 0.01
    q_diag: tuple = (10.0, 10.0, 0.5)
    r_diag: tuple = (0.1, 0.1)
    u_min: float = -3.0
    u_max: float = 3.0
    state_cost_scaling: float = 0.0
    input_cost_scaling: float = 0.0
    qp_iters: int = 4
    cg_iters: int = 15
    delay_num: int = 1
    condense_mode: str = "triangular"
    qp_mode: str = "matfree"
    integrator: str = "exact"


class NmpcCarry(NamedTuple):
    """RTI trajectory guess: x_traj (B, N+1, 3), u_traj (B, N, 2)."""

    x_traj: torch.Tensor
    u_traj: torch.Tensor


def _icr_col(v, like):
    """ICR field as a (B, 1) column against (B, N) stage tensors."""
    if torch.is_tensor(v) and v.dim() == 1:
        return v[:, None]
    return v


def stage_weights(cfg: NmpcConfig, dtype=torch.float32, device=None):
    """Per-stage diagonal weights with exponential decay
    (mpc_wrapper.cpp:115-140): qs (N, 3), rs (N, 2), qn (3,)."""
    n = cfg.horizon
    i = torch.arange(n, dtype=dtype, device=device)
    ss = torch.exp(-i / n * cfg.state_cost_scaling)
    us = torch.exp(-i / n * cfg.input_cost_scaling)
    q = torch.tensor(cfg.q_diag, dtype=dtype, device=device)
    r = torch.tensor(cfg.r_diag, dtype=dtype, device=device)
    return q * ss[:, None], r * us[:, None], q * ss[-1]


def exact_step(x, u, icr: ICRParams, dt):
    """Exact discrete ICR step for piecewise-constant wheels; x (..., 3),
    u (..., 2).  The w -> 0 limit uses the half-angle sinc form."""
    psi = x[..., 2]
    vr, vl = u[..., 0], u[..., 1]
    yr, yl, xv = (_icr_col(v, psi) for v in icr)
    track = yl - yr
    v = (vr * yl - vl * yr) / track
    w = (vr - vl) / track
    h = w * dt
    half = 0.5 * h
    s = torch.sinc(half / np.pi)      # normalized sinc: sin(half)/half
    int_cos = dt * s * torch.cos(psi + half)
    int_sin = dt * s * torch.sin(psi + half)
    x_new = x[..., 0] + v * int_cos + w * xv * int_sin
    y_new = x[..., 1] + v * int_sin - w * xv * int_cos
    return torch.stack([x_new, y_new, psi + h], dim=-1)


def nmpc_init(cfg: NmpcConfig, x0, dtype=torch.float32) -> NmpcCarry:
    """Cold start: hold the current pose (B, 3), zero wheels."""
    x0 = x0.to(dtype)
    B = x0.shape[0]
    return NmpcCarry(
        x_traj=x0[:, None, :].expand(B, cfg.horizon + 1, NX).clone(),
        u_traj=torch.zeros((B, cfg.horizon, NU), dtype=dtype,
                           device=x0.device))


def prepare_tri(carry: NmpcCarry, icr: ICRParams, cfg: NmpcConfig):
    """Closed-form linearization of exact_step, one elementwise pass.

    Returns (x_int (B, N, 3), a02, a12 (B, N), B0, B1, B2 (B, N, 2))."""
    dt = cfg.dt
    x = carry.x_traj[:, :-1]
    u = carry.u_traj
    psi = x[..., 2]
    vr, vl = u[..., 0], u[..., 1]
    yr, yl, xv = (_icr_col(v, psi) for v in icr)
    track = yl - yr
    v = (vr * yl - vl * yr) / track
    w = (vr - vl) / track
    h = w * dt
    half = 0.5 * h
    sc = torch.sinc(half / np.pi)
    I_c = dt * sc * torch.cos(psi + half)
    I_s = dt * sc * torch.sin(psi + half)
    x_int = torch.stack([x[..., 0] + v * I_c + w * xv * I_s,
                         x[..., 1] + v * I_s - w * xv * I_c,
                         psi + h], dim=-1)
    a02 = -v * I_s + w * xv * I_c
    a12 = v * I_c + w * xv * I_s

    h2 = h * h
    small = torch.abs(h) < 0.1
    safe_h2 = torch.where(small, torch.ones_like(h2), h2)
    A_ex = (torch.cos(h) + h * torch.sin(h) - 1.0) / safe_h2
    B_ex = (torch.sin(h) - h * torch.cos(h)) / safe_h2
    A_se = 0.5 - h2 / 8.0 + h2 * h2 / 144.0
    B_se = h * (1.0 / 3.0 - h2 / 30.0 + h2 * h2 / 840.0)
    Af = torch.where(small, A_se, A_ex)
    Bf = torch.where(small, B_se, B_ex)
    cpsi = torch.cos(psi)
    spsi = torch.sin(psi)
    J_c = dt * dt * (cpsi * Af - spsi * Bf)
    J_s = dt * dt * (spsi * Af + cpsi * Bf)

    pv_r = yl / track
    pv_l = -yr / track
    pw = 1.0 / track
    dXdw = -v * J_s + xv * I_s + w * xv * J_c
    dYdw = v * J_c - xv * I_c + w * xv * J_s
    B0 = torch.stack([pv_r * I_c + pw * dXdw, pv_l * I_c - pw * dXdw], -1)
    B1 = torch.stack([pv_r * I_s + pw * dYdw, pv_l * I_s - pw * dYdw], -1)
    b20 = (dt * pw) * torch.ones_like(h)
    B2 = torch.stack([b20, -b20], -1)
    return x_int, a02, a12, B0, B1, B2


class _TriOps(NamedTuple):
    """Separable factors of the condensing map C (see the JAX module)."""

    B0: torch.Tensor      # (B, N, NU)
    B1: torch.Tensor
    B2: torch.Tensor
    alpha: torch.Tensor   # (B, N+1)
    beta: torch.Tensor    # (B, N+1)
    a_off: torch.Tensor   # (B, N+1, NX)


def _prefix_excl(x):
    """(..., N) -> (..., N+1) with out[i] = sum_{j < i} x_j."""
    return torch.cat([torch.zeros_like(x[..., :1]), torch.cumsum(x, -1)], -1)


def _suffix_excl(x):
    """(..., N+1) -> (..., N) with out[j] = sum_{i > j} x_i."""
    cs = torch.cumsum(x, -1)
    return cs[..., -1:] - cs[..., :-1]


def _tri_ops_factors(x_traj, x_int, a02, a12, B0, B1, B2, dx0) -> _TriOps:
    d = x_int - x_traj[:, 1:]
    alpha = _prefix_excl(a02)
    beta = _prefix_excl(a12)
    epsi = dx0[:, 2:3] + _prefix_excl(d[..., 2])
    ex = dx0[:, 0:1] + _prefix_excl(d[..., 0] + a02 * epsi[:, :-1])
    ey = dx0[:, 1:2] + _prefix_excl(d[..., 1] + a12 * epsi[:, :-1])
    return _TriOps(B0=B0, B1=B1, B2=B2, alpha=alpha, beta=beta,
                   a_off=torch.stack([ex, ey, epsi], dim=-1))


@functools.lru_cache(maxsize=None)
def _prefix_mats(n: int, dtype, device):
    """P[i, j] = 1[j < i] ((N+1, N), prefix); S = strict upper ((N, N+1)).
    Cached per device, so the QP's matvecs copy nothing to the card."""
    P = (np.arange(n)[None, :] < np.arange(n + 1)[:, None])
    S = (np.arange(n + 1)[None, :] > np.arange(n)[:, None])
    return (torch.as_tensor(P, dtype=dtype, device=device),
            torch.as_tensor(S, dtype=dtype, device=device))


def _tri_cmat(ops: _TriOps, p2):
    """C @ p: p2 (B, ..., N, NU) -> (B, ..., N+1, NX); the five exclusive
    prefix sums as one triangular matmul."""
    n = p2.shape[-2]
    u = torch.sum(ops.B0 * p2, -1)
    v = torch.sum(ops.B1 * p2, -1)
    w = torch.sum(ops.B2 * p2, -1)
    cols = torch.stack([u, v, w, ops.alpha[..., 1:] * w,
                        ops.beta[..., 1:] * w], -1)           # (.., N, 5)
    P, _ = _prefix_mats(n, p2.dtype, p2.device)
    pref = torch.matmul(P, cols)                               # (.., N+1, 5)
    pu, pv, pw, paw, pbw = pref.unbind(-1)
    row0 = pu + ops.alpha * pw - paw
    row1 = pv + ops.beta * pw - pbw
    return torch.stack([row0, row1, pw], -1)


def _tri_ctmat(ops: _TriOps, y):
    """C^T @ y: y (B, ..., N+1, NX) -> (B, ..., N, NU)."""
    n = y.shape[-2] - 1
    cols = torch.stack([y[..., 0], y[..., 1], y[..., 2],
                        ops.alpha * y[..., 0], ops.beta * y[..., 1]], -1)
    _, S = _prefix_mats(n, y.dtype, y.device)
    suf = torch.matmul(S, cols)                                # (.., N, 5)
    S0, S1, S2, Sa0, Sb1 = suf.unbind(-1)
    T = Sa0 + Sb1 + S2 - ops.alpha[..., 1:] * S0 - ops.beta[..., 1:] * S1
    return (ops.B0 * S0[..., None] + ops.B1 * S1[..., None]
            + ops.B2 * T[..., None])


def _tri_diag_h(ops: _TriOps, q, r_diag):
    """diag(C^T Q C + R), (B, N*NU): q (N+1, NX), r_diag (N, NU)."""
    al, be = ops.alpha, ops.beta
    s0 = _suffix_excl(q[:, 0] * torch.ones_like(al))
    s0a = _suffix_excl(q[:, 0] * al)
    s0a2 = _suffix_excl(q[:, 0] * al * al)
    s1 = _suffix_excl(q[:, 1] * torch.ones_like(be))
    s1b = _suffix_excl(q[:, 1] * be)
    s1b2 = _suffix_excl(q[:, 1] * be * be)
    s2 = _suffix_excl(q[:, 2] * torch.ones_like(al))
    ac = al[:, 1:]
    bc = be[:, 1:]
    c0x = s0a - ac * s0
    c0xx = s0a2 - 2.0 * ac * s0a + ac * ac * s0
    c1x = s1b - bc * s1
    c1xx = s1b2 - 2.0 * bc * s1b + bc * bc * s1
    d = (ops.B0 * ops.B0 * s0[..., None]
         + 2.0 * ops.B0 * ops.B2 * c0x[..., None]
         + ops.B1 * ops.B1 * s1[..., None]
         + 2.0 * ops.B1 * ops.B2 * c1x[..., None]
         + ops.B2 * ops.B2 * (c0xx + c1xx + s2)[..., None])
    return (d + r_diag).reshape(d.shape[0], -1)


def _unsqueeze_ops(ops: _TriOps) -> _TriOps:
    return _TriOps(*(t.unsqueeze(1) for t in ops))


def _feedback_matfree(carry: NmpcCarry, prep, x_est, ref_x, ref_u,
                      cfg: NmpcConfig):
    """Condense + box QP + expand without materializing C or H."""
    n = cfg.horizon
    dtype, dev = carry.x_traj.dtype, carry.x_traj.device
    B = carry.x_traj.shape[0]
    dx0 = x_est - carry.x_traj[:, 0]
    x_int, a02, a12, B0, B1, B2 = prep
    ops = _tri_ops_factors(carry.x_traj, x_int, a02, a12, B0, B1, B2, dx0)
    ops4 = _unsqueeze_ops(ops)      # for the line search's (B, 4, n) batch

    qs, rs, qn = stage_weights(cfg, dtype, dev)
    xr = ref_x.transpose(1, 2)
    ur = ref_u.transpose(1, 2)[:, :n]
    rx = carry.x_traj + ops.a_off - xr
    ru = carry.u_traj - ur
    q = torch.cat([torch.zeros((1, NX), dtype=dtype, device=dev), qs[1:],
                   qn[None]], dim=0)                        # (N+1, NX)

    def matvec(p_flat):
        lead = p_flat.shape[:-1]
        p2 = p_flat.reshape(*lead, n, NU)
        o = ops if p2.dim() == 3 else ops4
        hp = _tri_ctmat(o, q * _tri_cmat(o, p2)) + rs * p2
        return hp.reshape(*lead, n * NU)

    diag_h = _tri_diag_h(ops, q, rs)
    g = (_tri_ctmat(ops, q * rx) + rs * ru).reshape(B, -1)
    u_flat = carry.u_traj.reshape(B, -1)
    lb = cfg.u_min - u_flat
    ub = cfg.u_max - u_flat
    du = box_qp_pncg_op(matvec, diag_h, g, lb, ub, iters=cfg.qp_iters,
                        cg_iters=cfg.cg_iters)
    u_new = carry.u_traj + du.reshape(B, n, NU)
    x_new = carry.x_traj + _tri_cmat(ops, du.reshape(B, n, NU)) + ops.a_off
    return NmpcCarry(x_traj=x_new, u_traj=u_new), x_new, u_new


def nmpc_rti_step(carry: NmpcCarry, x_est, ref_x, ref_u, icr: ICRParams,
                  cfg: NmpcConfig, prep_icr: ICRParams = None):
    """One RTI tick: prepare + feedback.  x_est (B, 3); ref_x (B, 3, N+1);
    ref_u (B, 2, N+1).  prep_icr: optional ICR for the linearization only
    (see the JAX module).  Returns (new_carry, u_cmd (B, 2), x_pred,
    u_pred)."""
    if not (cfg.qp_mode == "matfree" and cfg.condense_mode == "triangular"
            and cfg.integrator == "exact"):
        raise NotImplementedError(
            "only the fast NMPC path (integrator='exact', condense_mode="
            "'triangular', qp_mode='matfree') is ported")
    lin_icr = icr if prep_icr is None else prep_icr
    prep = prepare_tri(carry, lin_icr, cfg)
    new_carry, x_pred, u_pred = _feedback_matfree(carry, prep, x_est, ref_x,
                                                  ref_u, cfg)
    return new_carry, u_pred[:, cfg.delay_num], x_pred, u_pred
