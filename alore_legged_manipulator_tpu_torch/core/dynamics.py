"""ICR (instantaneous-center-of-rotation) diff-drive dynamics
(port of core/dynamics.py).

    xdot   = (vr*yl - vl*yr)/(yl - yr) * cos(psi) + (vr - vl)*xv/(yl - yr) * sin(psi)
    ydot   = (vr*yl - vl*yr)/(yl - yr) * sin(psi) - (vr - vl)*xv/(yl - yr) * cos(psi)
    psidot = (vr - vl)/(yl - yr)

ICR fields may be floats or tensors broadcastable against the state's
batch shape (e.g. (B,) per-lane EKF estimates against (B,) states).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ICRParams(NamedTuple):
    """ICR geometry; reference defaults from planner_sim.launch:204-206."""

    yr: torch.Tensor | float = -0.3
    yl: torch.Tensor | float = 0.3
    xv: torch.Tensor | float = 0.2


def icr_dynamics(state, u, icr: ICRParams):
    """Continuous-time xdot for state (..., 3) and wheels u = (vr, vl)."""
    psi = state[..., 2]
    vr, vl = u[..., 0], u[..., 1]
    yr, yl, xv = icr.yr, icr.yl, icr.xv
    track = yl - yr
    v = (vr * yl - vl * yr) / track
    w = (vr - vl) / track
    c, s = torch.cos(psi), torch.sin(psi)
    return torch.stack([v * c + w * xv * s, v * s - w * xv * c, w], dim=-1)


def wheel_speeds_from_flat(omega, v, icr: ICRParams):
    """(v_l, v_r) from body (omega, v); mpc.cpp:442-443."""
    return v - omega * icr.yl, v - omega * icr.yr


def body_vel_from_wheels(vl, vr, icr: ICRParams):
    """(v, omega, vy) from wheel speeds; simulator.h:238-241."""
    track = icr.yl - icr.yr
    w = (vr - vl) / track
    v = (vl + vr) / 2.0 - w * (icr.yl + icr.yr) / 2.0
    vy = -w * icr.xv
    return v, w, vy
