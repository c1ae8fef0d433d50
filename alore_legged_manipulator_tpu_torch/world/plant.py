"""Closed-loop diff-drive plant with ICR slip, rate limits and noise
(port of world/plant.py).

Rebuild of the reference 2-D simulator node (simulator.h:103-360):
wheel command -> desired (v, omega, vy) through the true ICR,
rate-limited first-order tracking, pose integration with the lateral vy
term, optional multiplicative Gaussian noise on the command setpoint.
Noise comes from a torch.Generator, or is passed in pre-drawn so that a
test can feed the same numbers to both implementations.  Batched: every
field has a leading lane axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.dynamics import ICRParams, body_vel_from_wheels


class PlantConfig(NamedTuple):
    max_acc: float = 2.0
    max_domega: float = 4.0
    rate_limit_dt: float = 0.01
    noise_stddev: float = 0.01
    add_noise: bool = True


class PlantState(NamedTuple):
    xytheta: torch.Tensor  # (B, 3)
    v: torch.Tensor        # (B,)
    omega: torch.Tensor    # (B,)
    vy: torch.Tensor       # (B,)
    s: torch.Tensor        # (B,)


def plant_init(xytheta, dtype=torch.float32) -> PlantState:
    xy = torch.as_tensor(xytheta).to(dtype)
    z = torch.zeros(xy.shape[0], dtype=dtype, device=xy.device)
    return PlantState(xytheta=xy, v=z, omega=z, vy=z, s=z)


def plant_step(st: PlantState, wheel_cmd, icr: ICRParams, dt,
               cfg: PlantConfig, generator: torch.Generator | None = None,
               noise=None) -> PlantState:
    """Advance one dt with a (vl, vr) wheel command (B, 2).

    Noise (when cfg.add_noise): `noise` (B, 2) standard normals for
    (v, omega) if given, else drawn from `generator`; with neither, the
    step is noise-free (the JAX package's key=None)."""
    vl, vr = wheel_cmd[:, 0], wheel_cmd[:, 1]
    des_v, des_w, vy = body_vel_from_wheels(vl, vr, icr)
    if cfg.add_noise and (noise is not None or generator is not None):
        if noise is None:
            noise = torch.randn(des_v.shape + (2,), generator=generator,
                                dtype=des_v.dtype, device=des_v.device)
        des_v = des_v * (1.0 + cfg.noise_stddev * noise[:, 0])
        des_w = des_w * (1.0 + cfg.noise_stddev * noise[:, 1])

    lim_dt = dt if cfg.rate_limit_dt is None else cfg.rate_limit_dt
    dv = torch.clamp(des_v - st.v, -cfg.max_acc * lim_dt, cfg.max_acc * lim_dt)
    dw = torch.clamp(des_w - st.omega, -cfg.max_domega * lim_dt,
                     cfg.max_domega * lim_dt)
    v = st.v + dv
    w = st.omega + dw

    x, y, th = st.xytheta.unbind(-1)
    # reference integration order (simulator.h:265-270)
    x = x + v * dt * torch.cos(th)
    y = y + v * dt * torch.sin(th)
    th = th + w * dt
    x = x - vy * dt * torch.sin(th)
    y = y + vy * dt * torch.cos(th)
    return PlantState(xytheta=torch.stack([x, y, th], dim=-1), v=v, omega=w,
                      vy=vy, s=st.s + v * dt)


def plant_wheel_feedback(st: PlantState, icr: ICRParams):
    """Wheel odometry the plant publishes (simulator.h:345-346), (B, 2)
    columns (vl, vr)."""
    vl = st.v - st.omega * icr.yl
    vr = st.v - st.omega * icr.yr
    return torch.stack([vl, vr], dim=-1)


def plant_step_mpc_tick(st: PlantState, cmd_v, cmd_w, cfg: PlantConfig,
                        substeps: int = 5, dt: float = 0.002) -> PlantState:
    """One 100 Hz control period of the plant under the (v, omega)
    CarState command path, the composition planner_sim.launch wires
    (LTV MPC cmd -> /simulation/PoseSub).

    PoseSubCallback (simulator.h:203-231) adopts the commanded (v, omega)
    INSTANTLY; desired_(v, omega) are only written by ControlSubCallback,
    which this launch never feeds, so every 500 Hz StatePropaCallback
    between command receipts rate-limits the velocity toward ZERO by
    max_acc * Pose_pub_rate_ (the publish-interval quirk, :246-262).
    Net effect per 10 ms tick: v := cmd, then 5 x (decay by 0.02 / 0.04,
    integrate 2 ms).  cmd_v, cmd_w: (B,) or floats.
    """
    dtype, dev = st.xytheta.dtype, st.xytheta.device
    v = torch.as_tensor(cmd_v, dtype=dtype, device=dev).expand(st.v.shape)
    w = torch.as_tensor(cmd_w, dtype=dtype, device=dev).expand(st.v.shape)
    lim_dt = dt if cfg.rate_limit_dt is None else cfg.rate_limit_dt
    dv = cfg.max_acc * lim_dt
    dw = cfg.max_domega * lim_dt
    x, y, th = st.xytheta.unbind(-1)
    s = st.s
    for _ in range(substeps):
        # StatePropa toward desired = 0 (:246-262)
        v = torch.where(torch.abs(v) >= dv, v - dv * torch.sign(v),
                        torch.zeros_like(v))
        w = torch.where(torch.abs(w) >= dw, w - dw * torch.sign(w),
                        torch.zeros_like(w))
        x = x + v * dt * torch.cos(th)
        y = y + v * dt * torch.sin(th)
        th = th + w * dt
        s = s + v * dt
    return PlantState(xytheta=torch.stack([x, y, th], dim=-1), v=v, omega=w,
                      vy=st.vy, s=s)
