"""Simpson integration of the ICR flow: flat traj (yaw, s) -> world XY
(port of core/flow.py).

    xdot(t) = sdot*cos(yaw) + yawdot*xv*sin(yaw)
    ydot(t) = sdot*sin(yaw) - yawdot*xv*cos(yaw)

integrated with a composite Simpson rule, 2*R sub-samples per piece
(optimizer.cpp:751-826, traj_anal.hpp:55-95).  Batched over a leading
lane axis; gradients come from torch.autograd.
"""
from __future__ import annotations

import torch

from .poly import NCOEF, PolyTraj, _falling, eval_traj


def _as_col(v, like):
    """A per-lane (B,) tensor becomes (B, 1, ..., 1) to broadcast against
    `like`; floats and 0-d tensors pass through."""
    if torch.is_tensor(v) and v.dim() == 1:
        return v.reshape(v.shape[0], *([1] * (like.dim() - 1)))
    return v


def flow_velocity(sigma, dsigma, xv):
    """World-frame (xdot, ydot) from flat state; optimizer.cpp:807-812."""
    yaw = sigma[..., 0]
    dyaw = dsigma[..., 0]
    ds = dsigma[..., 1]
    xv = _as_col(xv, yaw)
    c, s = torch.cos(yaw), torch.sin(yaw)
    gx = ds * c + dyaw * xv * s
    gy = ds * s - dyaw * xv * c
    return gx, gy


def piece_samples(coeffs, times, n_sub: int):
    """Sample every piece at its 2*n_sub+1 Simpson nodes.

    coeffs (B, N, 6, 2), times (B, N).  Returns (sigma, dsigma, ddsigma,
    dddsigma) each (B, N, 2*n_sub+1, 2) plus the local node times.
    """
    nn = 2 * n_sub + 1
    frac = torch.arange(nn, dtype=times.dtype, device=times.device) \
        / (2.0 * n_sub)
    local = times[..., None] * frac                  # (B, N, nn)
    pw = [torch.ones_like(local)]
    for _ in range(NCOEF - 1):
        pw.append(pw[-1] * local)
    zero = torch.zeros_like(local)
    rows = []
    for order in range(4):
        cols = [zero] * order + [_falling(k, order) * pw[k - order]
                                 for k in range(order, NCOEF)]
        rows.append(torch.stack(cols, dim=-1))      # (B, N, nn, 6)
    basis = torch.cat(rows, dim=-2)                  # (B, N, 4nn, 6)
    vals = torch.matmul(basis, coeffs)               # (B, N, 4nn, 2)
    sig, dsig, ddsig, dddsig = torch.split(vals, nn, dim=-2)
    return sig, dsig, ddsig, dddsig, local


def simpson_increments(gx, gy, times, n_sub: int):
    """Per-sub-interval Simpson increments, (B, N, n_sub) each."""
    coeff = (times / (6.0 * n_sub))[..., None]
    incx = coeff * (gx[..., 0:-1:2] + 4.0 * gx[..., 1::2] + gx[..., 2::2])
    incy = coeff * (gy[..., 0:-1:2] + 4.0 * gy[..., 1::2] + gy[..., 2::2])
    return incx, incy


def simpson_flow_positions(coeffs, times, ini_xy, xv, n_sub: int):
    """Integrate the flow over all pieces with composite Simpson.

    Returns node_xy (B, N, n_sub+1, 2) at the even Simpson nodes,
    final_xy (B, 2) and the (sigma, dsigma, ddsigma, dddsigma) samples.
    """
    sig, dsig, ddsig, dddsig, _ = piece_samples(coeffs, times, n_sub)
    gx, gy = flow_velocity(sig, dsig, xv)
    incx, incy = simpson_increments(gx, gy, times, n_sub)
    B, N = times.shape
    inc = torch.stack([incx, incy], dim=-1).reshape(B, N * n_sub, 2)
    cum = torch.cumsum(inc, dim=1)
    cum = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)
    node_xy = ini_xy[:, None, :] + cum               # (B, N*n_sub + 1, 2)
    idx = (torch.arange(N, device=times.device)[:, None] * n_sub
           + torch.arange(n_sub + 1, device=times.device)[None, :])
    per_piece = node_xy[:, idx]
    return per_piece, node_xy[:, -1], (sig, dsig, ddsig, dddsig)


def flow_state_sequence(traj: PolyTraj, ini_state, xv, n_steps: int):
    """Dense cumulative flow integration on a uniform time grid
    (TrajAnal::getSeq, traj_anal.hpp:55-95).  ini_state (B, 3).
    Returns ((B, n_steps+1, 3) states, (B,) grid spacing)."""
    total = traj.total_time
    dt = total / n_steps
    k = torch.arange(n_steps, dtype=total.dtype, device=total.device)
    t0 = k * dt[:, None]
    tm = t0 + (dt / 2.0)[:, None]
    t1 = t0 + dt[:, None]
    ts = torch.cat([t0, tm, t1], dim=1)
    p = eval_traj(traj, ts, 0)
    v = eval_traj(traj, ts, 1)
    gx, gy = flow_velocity(p, v, xv)
    gx0, gxm, gx1 = torch.split(gx, n_steps, dim=1)
    gy0, gym, gy1 = torch.split(gy, n_steps, dim=1)
    incx = (dt / 6.0)[:, None] * (gx0 + 4.0 * gxm + gx1)
    incy = (dt / 6.0)[:, None] * (gy0 + 4.0 * gym + gy1)
    zero = torch.zeros_like(incx[:, :1])
    x = ini_state[:, 0:1] + torch.cat([zero, torch.cumsum(incx, 1)], 1)
    y = ini_state[:, 1:2] + torch.cat([zero, torch.cumsum(incy, 1)], 1)
    yaw = torch.cat([ini_state[:, 2:3].to(x.dtype), p[:, 2 * n_steps:, 0]], 1)
    return torch.stack([x, y, yaw], dim=-1), dt
