"""Controller-side trajectory analysis (port of control/tracked_traj.py).

The controller rebuilds the MINCO spline from a Polynome, pre-integrates
the world-position flow once on a dense uniform grid, and answers pose
queries with a cached prefix + local Simpson correction
(traj_anal.hpp:11-139).  Batched over a leading lane axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import poly
from ..core.dynamics import ICRParams
from ..core.flow import flow_state_sequence, flow_velocity
from ..core.poly import PolyTraj
from ..planner.flat_traj import Polynome
from ..solvers.minco import minco_coeffs
from ..utils.angles import normalize_angle, smooth_yaw_sequence


class TrackedTraj(NamedTuple):
    traj: PolyTraj
    seq: torch.Tensor        # (B, K+1, 3) world states on the uniform grid
    seq_dt: torch.Tensor     # (B,) grid spacing = total/K
    icr: ICRParams           # fields (B,)
    duration: torch.Tensor   # (B,)


def build_tracked_traj(msg: Polynome, n_grid: int = 2048) -> TrackedTraj:
    coeffs = minco_coeffs(msg.init_state, msg.tail_state, msg.inner_points,
                          msg.piece_times)
    traj = PolyTraj(coeffs=coeffs, times=msg.piece_times)
    icr = ICRParams(yr=msg.icr[:, 0], yl=msg.icr[:, 1], xv=msg.icr[:, 2])
    seq, dt = flow_state_sequence(traj, msg.start_position, icr.xv, n_grid)
    return TrackedTraj(traj=traj, seq=seq, seq_dt=dt, icr=icr,
                       duration=traj.total_time)


def pad_tracked_traj(tt: TrackedTraj, capacity: int) -> TrackedTraj:
    """Pad the piece dimension to a fixed capacity, so that lanes or
    plans of different piece counts share one shape.

    Pad pieces have zero duration and constant coefficients equal to the
    trajectory's end flat state: `locate` maps t = duration into the
    first pad piece at local time 0, which evaluates to the exact end
    pose with zero derivatives, the pose-hold the reference controller
    samples past the trajectory end.  Interior t are unaffected
    (zero-length pieces are never selected for t < duration).
    """
    B, n = tt.traj.times.shape
    if n >= capacity:
        return tt
    end_state = poly.eval_traj(tt.traj, tt.duration[:, None], 0)   # (B, 1, 2)
    pad = tt.traj.coeffs.new_zeros((B, capacity - n, poly.NCOEF, 2))
    pad[:, :, 0, :] = end_state
    coeffs = torch.cat([tt.traj.coeffs, pad], dim=1)
    times = torch.cat([tt.traj.times,
                       tt.traj.times.new_zeros((B, capacity - n))], dim=1)
    return tt._replace(traj=PolyTraj(coeffs=coeffs, times=times))


def pstate(tt: TrackedTraj, t):
    """World pose (x, y, yaw) at times t (B, M) -> (B, M, 3)
    (traj_anal.hpp:105-130)."""
    dur = tt.duration[:, None]
    t = torch.minimum(torch.clamp(t, min=0.0), dur)
    K1 = tt.seq.shape[1]
    dt = tt.seq_dt[:, None]
    idx = torch.clamp(torch.floor(t / dt).to(torch.int64), 0, K1 - 1)
    t0 = idx.to(t.dtype) * dt
    dtloc = t - t0
    base = torch.gather(tt.seq, 1, idx[..., None].expand(*idx.shape, 3))
    M = t.shape[1]
    ts = torch.cat([t0, t0 + dtloc / 2.0, t], dim=1)          # (B, 3M)
    p = poly.eval_traj(tt.traj, ts, 0)
    v = poly.eval_traj(tt.traj, ts, 1)
    gx, gy = flow_velocity(p, v, tt.icr.xv)
    gx0, gxm, gx1 = torch.split(gx, M, dim=1)
    gy0, gym, gy1 = torch.split(gy, M, dim=1)
    x = base[..., 0] + dtloc / 6.0 * (gx0 + 4.0 * gxm + gx1)
    y = base[..., 1] + dtloc / 6.0 * (gy0 + 4.0 * gym + gy1)
    return torch.stack([x, y, p[:, 2 * M:, 0]], dim=-1)


def vstate(tt: TrackedTraj, t):
    """(yawdot, sdot) at times t (B, M)."""
    t = torch.minimum(torch.clamp(t, min=0.0), tt.duration[:, None])
    return poly.eval_traj(tt.traj, t, 1)


def astate(tt: TrackedTraj, t):
    """(yaw acceleration, s acceleration) at times t (B, M)."""
    t = torch.minimum(torch.clamp(t, min=0.0), tt.duration[:, None])
    return poly.eval_traj(tt.traj, t, 2)


def ref_points(tt: TrackedTraj, t_now, n_samples: int, dt, yaw_est,
               wheel_icr: ICRParams = None):
    """Reference states (B, 3, N+1) and inputs (B, 2, N+1) for one NMPC
    tick (getRefPoints, mpc.cpp:432-461).  t_now: float or (B,);
    yaw_est: (B,)."""
    icr_w = tt.icr if wheel_icr is None else wheel_icr
    B = tt.seq.shape[0]
    k = torch.arange(1, n_samples + 2, dtype=tt.seq.dtype,
                     device=tt.seq.device)
    t_now = torch.as_tensor(t_now, dtype=tt.seq.dtype, device=tt.seq.device)
    ts = t_now.reshape(-1, 1) + dt * k                       # (B, N+1)
    ts = ts.expand(B, n_samples + 1)
    inside = ts <= tt.duration[:, None]
    tq = torch.minimum(torch.clamp(ts, min=0.0), tt.duration[:, None])
    states = pstate(tt, tq)
    vels = vstate(tt, tq)

    def col(v):
        return v[:, None] if torch.is_tensor(v) and v.dim() == 1 else v

    vl = vels[..., 1] - vels[..., 0] * col(icr_w.yl)
    vr = vels[..., 1] - vels[..., 0] * col(icr_w.yr)
    vl = torch.where(inside, vl, torch.zeros_like(vl))
    vr = torch.where(inside, vr, torch.zeros_like(vr))
    yaw = smooth_yaw_sequence(yaw_est, normalize_angle(states[..., 2]))
    ref_x = torch.stack([states[..., 0], states[..., 1], yaw], dim=1)
    ref_u = torch.stack([vr, vl], dim=1)
    return ref_x, ref_u


def ltv_ref_points(tt: TrackedTraj, t_cur, horizon: int, dt, yaw_est):
    """Reference rows for one LTV-MPC tick (mpc_controller getRefPoints,
    mpc_controller/src/mpc.cpp:634-691): samples t_cur+dt ... t_cur+T*dt
    clamped at the trajectory end (pose-hold with the END state's
    velocities: the reference samples curV at traj_duration, not zero),
    yaw normalized per sample and then unwrapped against the odom yaw
    (:538-567).  t_cur: float or (B,); yaw_est: (B,).

    Returns xref (B, 4, T) rows (x, y, v-slot, yaw) and dref (B, 2, T)
    rows (v, omega).
    """
    B = tt.seq.shape[0]
    k = torch.arange(1, horizon + 1, dtype=tt.seq.dtype,
                     device=tt.seq.device)
    t_cur = torch.as_tensor(t_cur, dtype=tt.seq.dtype, device=tt.seq.device)
    ts = (t_cur.reshape(-1, 1) + dt * k).expand(B, horizon)
    tq = torch.minimum(ts, tt.duration[:, None])
    states = pstate(tt, tq)
    vels = vstate(tt, tq)
    yaw = smooth_yaw_sequence(yaw_est, normalize_angle(states[..., 2]))
    xref = torch.stack([states[..., 0], states[..., 1],
                        torch.zeros_like(yaw), yaw], dim=1)
    dref = torch.stack([vels[..., 1], vels[..., 0]], dim=1)
    return xref, dref
