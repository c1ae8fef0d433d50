"""LTV-MPC for the standard diff-drive, (v, omega) inputs (port of
control/ltv_mpc.py).

Rebuild of the reference mpc_controller (mpc_controller/src/mpc.cpp):
SQP-flavoured linear time-varying MPC -- roll the unicycle model out along
the current control sequence, linearize about that rollout
(getLinearModel :217-232), assemble a QP over stacked states and inputs
with

  * cost      Q[0,1] on (x, y), Q[3] on yaw, Q[2] on (v - v_ref),
              R on (v, omega), Rd on input rates (:317-368)
  * equality  linearized dynamics (:370-432)
  * bounds    |v| <= max_speed, |omega| <= max_omega, rate limits
              |dv| <= max_acc*dt, |domega| <= max_domega*dt (:435-493)
  * input-delay compensation: the first delay_num inputs are frozen to
    the already-sent commands (:524-536, :613-616)

and solve it with the OSQP-style ADMM (ops/qp.qp_admm_general), iterating
rollout -> QP `sqp_iters` times (getCmd :569-593).

Every tensor has a leading lane axis.  The QP keeps the reference's
sparse (x, u) variable layout, assembled densely: the Hessian, the box
and rate rows and the constant entries of the dynamics rows depend on
the config only and are built once (`_qp_layout`); a pass writes only
the linearization's entries.  Defaults are the mpc3ms.yaml profile.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops.qp import qp_admm_general
from ..ops.qp_admm_cuda import AdmmPattern, admm_pattern
from ..utils.precision import resolve_device
from ..utils.profiling import span

NX = 3  # x, y, theta
NU = 2  # v, omega


class LtvMpcConfig(NamedTuple):
    horizon: int = 30                  # predict_steps
    dt: float = 0.01
    q_diag: tuple = (15.0, 15.0, 0.0, 1.0)   # x, y, (v), yaw
    r_diag: tuple = (0.0, 0.0)
    rd_diag: tuple = (1.0, 0.05)
    max_speed: float = 3.0
    min_speed: float = 0.0
    max_omega: float = 3.0
    max_acc: float = 2.0
    max_domega: float = 4.0
    delay_num: int = 1
    sqp_iters: int = 3                 # rollout->QP passes per tick
    admm_iters: int = 150
    admm_rho: float = 0.4


class LtvMpcCarry(NamedTuple):
    output: torch.Tensor       # (B, 2, T) planned (v, omega) sequence
    delay_buff: torch.Tensor   # (B, delay_num, 2) already-sent commands


def ltv_mpc_init(cfg: LtvMpcConfig, dtype=torch.float32, batch: int = 1,
                 device=None) -> LtvMpcCarry:
    """Zero carry for `batch` lanes on `device` (None means the card)."""
    dev = resolve_device(device)
    return LtvMpcCarry(
        output=torch.zeros((batch, 2, cfg.horizon), dtype=dtype, device=dev),
        delay_buff=torch.zeros((batch, max(cfg.delay_num, 1), 2),
                               dtype=dtype, device=dev))


def _rollout(x0, output, cfg: LtvMpcConfig):
    """predictMotion (:259-268): unicycle rollout with clipped inputs.
    x0 (B, 3), output (B, 2, T).  Returns xbar (B, T+1, 4): (x, y, theta,
    v).  The position advances with the *commanded* (unclipped) v at the
    old heading, then the heading integrates the clipped omega
    (stateTrans :233-256)."""
    u0 = output[:, 0]                                           # (B, T)
    w = torch.clamp(output[:, 1], -cfg.max_omega, cfg.max_omega)
    # the sums run in the scan's order: one add per step
    ths = [x0[:, 2]]
    for k in range(cfg.horizon):
        ths.append(ths[-1] + w[:, k] * cfg.dt)
    th = torch.stack(ths, dim=1)                                # (B, T+1)
    dxy = torch.stack([u0 * torch.cos(th[:, :-1]) * cfg.dt,
                       u0 * torch.sin(th[:, :-1]) * cfg.dt], dim=-1)
    xys = [x0[:, :2]]
    for k in range(cfg.horizon):
        xys.append(xys[-1] + dxy[:, k])
    xy = torch.stack(xys, dim=1)                                # (B, T+1, 2)
    v = torch.cat([torch.zeros_like(u0[:, :1]), u0], dim=1)
    return torch.cat([xy, th[..., None], v[..., None]], dim=-1)


class _Layout(NamedTuple):
    Q: torch.Tensor          # (4,) cfg.q_diag
    H: torch.Tensor          # (nx, nx)
    A: torch.Tensor          # (m, nx) with the linearization entries 0
    lb: torch.Tensor         # (m,) box and rate rows; 0 on equality rows
    ub: torch.Tensor
    rows: torch.Tensor       # (4 n_st - 2,) linearization entries
    cols: torch.Tensor
    pattern: AdmmPattern     # where A and the KKT factor may be nonzero


@functools.lru_cache(maxsize=16)
def _qp_layout(cfg: LtvMpcConfig, dtype, device) -> _Layout:
    """What solveMPCV (:304-493) assembles from the config alone: the
    Hessian with its Rd rate cross terms, the box, rate and constant
    dynamics entries of A, their bounds, where the linearization's
    entries go, and the QP's pattern for the ADMM kernel (A's constant
    nonzeros and the linearization's entries, the envelope of the KKT
    matrix's factor from H's and A's), read once on the host here.
    Every value is computed in `dtype`, in the JAX package's
    order."""
    T, d = cfg.horizon, cfg.delay_num
    n_st = T - d
    dimx, dimu = NX * n_st, NU * n_st
    nx = dimx + dimu
    kw = dict(dtype=dtype, device=device)
    Q = torch.tensor(cfg.q_diag, **kw)
    R = torch.tensor(cfg.r_diag, **kw)
    Rd = torch.tensor(cfg.rd_diag, **kw)
    ar = functools.partial(torch.arange, device=device)

    H = torch.zeros((nx, nx), **kw)
    ix = ar(n_st) * NX
    H[ix, ix] = 2.0 * Q[0]
    H[ix + 1, ix + 1] = 2.0 * Q[1]
    H[ix + 2, ix + 2] = 2.0 * Q[3]
    iu = dimx + ar(n_st) * NU
    mid = iu[1:n_st - 1]
    # interior inputs get 2*Rd from both neighbouring rate terms
    end_v, end_w = 2.0 * (R[0] + Rd[0] + Q[2]), 2.0 * (R[1] + Rd[1])
    H[iu[0], iu[0]] = end_v
    H[iu[0] + 1, iu[0] + 1] = end_w
    H[iu[-1], iu[-1]] = end_v
    H[iu[-1] + 1, iu[-1] + 1] = end_w
    H[mid, mid] = 2.0 * (R[0] + 2.0 * Rd[0] + Q[2])
    H[mid + 1, mid + 1] = 2.0 * (R[1] + 2.0 * Rd[1])
    j = iu[:n_st - 1]
    H[j + NU, j] = -2.0 * Rd[0]
    H[j, j + NU] = -2.0 * Rd[0]
    H[j + NU + 1, j + 1] = -2.0 * Rd[1]
    H[j + 1, j + NU + 1] = -2.0 * Rd[1]

    # rows: [box (dimu), dynamics equalities (dimx), rates (2 (n_st-1))]
    n_rate = n_st - 1
    A = torch.zeros((dimu + dimx + NU * n_rate, nx), **kw)
    bi = ar(dimu)
    A[bi, dimx + bi] = 1.0
    r = dimu + ar(n_st) * NX
    A[r, r - dimu] = 1.0
    A[r + 1, r + 1 - dimu] = 1.0
    A[r + 2, r + 2 - dimu] = 1.0
    A[r + 2, iu + 1] = -cfg.dt
    rk = r[1:]
    c = rk - dimu
    A[rk, c - NX] = -1.0
    A[rk + 1, c + 1 - NX] = -1.0
    A[rk + 2, c + 2 - NX] = -1.0
    rr = dimu + dimx + ar(n_rate) * NU
    A[rr, iu[:n_rate]] = -1.0
    A[rr, iu[:n_rate] + NU] = 1.0
    A[rr + 1, iu[:n_rate] + 1] = -1.0
    A[rr + 1, iu[:n_rate] + 1 + NU] = 1.0

    lb_box = torch.tensor([-cfg.max_speed, -cfg.max_omega], **kw).repeat(n_st)
    lb_rate = torch.tensor([-(cfg.max_acc * cfg.dt),
                            -(cfg.max_domega * cfg.dt)], **kw).repeat(n_rate)
    zeros = torch.zeros(dimx, **kw)
    lb = torch.cat([lb_box, zeros, lb_rate])
    ub = torch.cat([-lb_box, zeros, -lb_rate])
    # the linearization's entries, in the order _build_qp writes values:
    # -B (x, y rows on v), then -A's theta columns for stages k >= 1
    rows = torch.cat([r, r + 1, rk, rk + 1])
    cols = torch.cat([iu, iu, c - 1, c - 1])
    mask = A != 0
    mask[rows, cols] = True
    return _Layout(Q, H, A, lb, ub, rows, cols, admm_pattern(mask, H != 0))


def _build_qp(xbar, xref, dref, carry: LtvMpcCarry, cfg: LtvMpcConfig):
    """Assemble the dense (x, u) QP exactly as solveMPCV (:304-532).
    xbar (B, T+1, 4), xref (B, 4, T), dref (B, 2, T).  Returns H (B, n,
    n), g (B, n), A (B, m, n), lb, ub (B, m)."""
    B = xbar.shape[0]
    T, d = cfg.horizon, cfg.delay_num
    n_st = T - d
    dtype = xbar.dtype
    lay = _qp_layout(cfg, dtype, xbar.device)
    Q = lay.Q

    # ---- gradient ----
    zero = torch.zeros_like(dref[:, 0, d:])
    gx = torch.stack([(-2.0 * Q[0]) * xref[:, 0, d:],
                      (-2.0 * Q[1]) * xref[:, 1, d:],
                      (-2.0 * Q[3]) * xref[:, 3, d:]], dim=-1)
    gu = torch.stack([(-2.0 * Q[2]) * dref[:, 0, d:], zero], dim=-1)
    g = torch.cat([gx.reshape(B, -1), gu.reshape(B, -1)], dim=1)

    # ---- linearized dynamics: stage k relates state var k to state var
    # k-1 and input var k, linearized at xbar[d + k] ----
    th = xbar[:, d:d + n_st, 2]
    v = xbar[:, d:d + n_st, 3]
    sB00 = torch.cos(th) * cfg.dt
    sB10 = torch.sin(th) * cfg.dt
    sA02 = -sB10 * v
    sA12 = sB00 * v
    sC0 = -sA02 * th
    sC1 = -sA12 * th
    A = lay.A.expand(B, -1, -1).clone()
    A[:, lay.rows, lay.cols] = torch.cat([-sB00, -sB10, -sA02[:, 1:],
                                          -sA12[:, 1:]], dim=1)
    # k = 0 rows absorb the known previous state xbar[d]
    xp = xbar[:, d, :3]
    b0 = torch.stack([xp[:, 0] + sA02[:, 0] * xp[:, 2] + sC0[:, 0],
                      xp[:, 1] + sA12[:, 0] * xp[:, 2] + sC1[:, 0],
                      xp[:, 2]], dim=1)
    bk = torch.stack([sC0[:, 1:], sC1[:, 1:], torch.zeros_like(sC0[:, 1:])],
                     dim=-1).reshape(B, -1)
    beq = torch.cat([b0, bk], dim=1)
    dimu = NU * n_st
    lb = lay.lb.expand(B, -1).clone()
    ub = lay.ub.expand(B, -1).clone()
    lb[:, dimu:dimu + NX * n_st] = beq
    ub[:, dimu:dimu + NX * n_st] = beq
    return lay.H.expand(B, -1, -1), g, A, lb, ub


def ltv_mpc_tick(carry: LtvMpcCarry, x_est, xref, dref, cfg: LtvMpcConfig):
    """One 100 Hz control tick.

    x_est (B, 3); xref (B, 4, T) reference (x, y, v_unused, yaw); dref
    (B, 2, T) reference (v, omega).  Returns (new_carry, cmd (B, 2)).
    Each pass's rollout and assembly run in span `ltv.linearize`; its QP
    goes to `qp_admm_general` with the layout's pattern.
    """
    B = x_est.shape[0]
    d = cfg.delay_num
    n_st = cfg.horizon - d
    dimx = NX * n_st
    output = carry.output
    pattern = _qp_layout(cfg, x_est.dtype, x_est.device).pattern
    for _ in range(cfg.sqp_iters):
        with span("ltv.linearize"):
            xbar = _rollout(x_est, output, cfg)
            H, g, A, lb, ub = _build_qp(xbar, xref, dref, carry, cfg)
        sol, _ = qp_admm_general(H, g, A, lb, ub, iters=cfg.admm_iters,
                                 rho=cfg.admm_rho, pattern=pattern)
        u = sol[:, dimx:].reshape(B, n_st, NU).transpose(1, 2)
        output = torch.cat([carry.delay_buff[:, :d].transpose(1, 2), u],
                           dim=2) if d > 0 else u
    cmd = output[:, :, d]
    if d > 0:
        delay_buff = torch.cat([carry.delay_buff[:, 1:], cmd[:, None]], dim=1)
    else:
        delay_buff = carry.delay_buff
    return LtvMpcCarry(output=output, delay_buff=delay_buff), cmd
