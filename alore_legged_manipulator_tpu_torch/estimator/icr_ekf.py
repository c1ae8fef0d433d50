"""ICR-EKF: joint pose + ICR-parameter estimation (port of
estimator/icr_ekf.py: ekf_init, ekf_predict, ekf_update).

State x = [x, y, psi, yr, yl, xv] (icrekf.h).  Predict on each wheel
command (vl, vr) with the exact ICR step and its Jacobian (icrekf.cpp:
99-207, textbook J P J' -- the reference's F'PF with its transposed
storage); update on pose observations with H = [I3 0] and yaw unwrapped
toward the estimate (:68-69, :210-222).  Batched: x (B, 6), P (B, 6, 6).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.angles import unwrap_to


class EkfConfig(NamedTuple):
    q_diag: tuple = (0.1, 0.1, 0.1, 0.001, 0.001, 0.001)
    r_diag: tuple = (0.001, 0.001, 0.001)
    p0_diag: tuple = (1.0, 1.0, 1.0, 0.01, 0.01, 0.01)


class EkfState(NamedTuple):
    x: torch.Tensor   # (B, 6)
    P: torch.Tensor   # (B, 6, 6)


def ekf_init(pose, icr_guess, cfg: EkfConfig = EkfConfig(),
             dtype=torch.float32) -> EkfState:
    """pose (B, 3); icr_guess (3,) or (B, 3)."""
    pose = torch.as_tensor(pose).to(dtype)
    B = pose.shape[0]
    icr = torch.as_tensor(icr_guess, dtype=dtype, device=pose.device)
    x = torch.cat([pose, icr.expand(B, 3)], dim=1)
    P = torch.diag(torch.tensor(cfg.p0_diag, dtype=dtype,
                                device=pose.device)).expand(B, 6, 6).clone()
    return EkfState(x=x, P=P)


def _dynamics_and_jacobian(x6, u, dt):
    """Exact discrete ICR step for the 6-state (icrekf.cpp:114-116) and
    its Jacobian in closed form (the JAX package takes jacfwd)."""
    x, y, psi, yr, yl, xv = x6.unbind(-1)
    vl, vr = u[..., 0], u[..., 1]
    track = yl - yr
    v = (vr * yl - vl * yr) / track
    w = (vr - vl) / track
    c, s = torch.cos(psi), torch.sin(psi)
    x_new = torch.stack([x + dt * (v * c + w * xv * s),
                         y + dt * (v * s - w * xv * c),
                         psi + dt * w, yr, yl, xv], dim=-1)
    dv_dyr = (v - vl) / track
    dv_dyl = (vr - v) / track
    dw_dyr = w / track
    dw_dyl = -w / track
    B = x6.shape[0]
    F = torch.eye(6, dtype=x6.dtype, device=x6.device).expand(B, 6, 6).clone()
    F[:, 0, 2] = dt * (-v * s + w * xv * c)
    F[:, 0, 3] = dt * (dv_dyr * c + dw_dyr * xv * s)
    F[:, 0, 4] = dt * (dv_dyl * c + dw_dyl * xv * s)
    F[:, 0, 5] = dt * (w * s)
    F[:, 1, 2] = dt * (v * c + w * xv * s)
    F[:, 1, 3] = dt * (dv_dyr * s - dw_dyr * xv * c)
    F[:, 1, 4] = dt * (dv_dyl * s - dw_dyl * xv * c)
    F[:, 1, 5] = dt * (-w * c)
    F[:, 2, 3] = dt * dw_dyr
    F[:, 2, 4] = dt * dw_dyl
    return x_new, F


def ekf_predict(st: EkfState, u, dt, cfg: EkfConfig = EkfConfig()) -> EkfState:
    """Predict on a wheel command u = (vl, vr) (B, 2) held for dt."""
    x_new, F = _dynamics_and_jacobian(st.x, u, dt)
    Q = torch.tensor(cfg.q_diag, dtype=st.x.dtype, device=st.x.device)
    P_new = F @ st.P @ F.transpose(1, 2) + torch.diag((dt * dt) * Q)
    return EkfState(x=x_new, P=P_new)


def ekf_update(st: EkfState, pose_obs, cfg: EkfConfig = EkfConfig()) -> EkfState:
    """Pose-measurement update; H = [I3 0]; yaw unwrapped to the estimate."""
    dtype = st.x.dtype
    obs = pose_obs.to(dtype)
    obs = torch.cat([obs[:, :2], unwrap_to(st.x[:, 2], obs[:, 2])[:, None]],
                    dim=1)
    R = torch.diag(torch.tensor(cfg.r_diag, dtype=dtype, device=st.x.device))
    PHt = st.P[:, :, :3]                                 # P H^T
    S = PHt[:, :3, :] + R                                # H P H^T + R
    K = torch.linalg.solve_ex(S.transpose(1, 2),
                              PHt.transpose(1, 2))[0].transpose(1, 2)
    innov = obs - st.x[:, :3]
    x_new = st.x + (K @ innov[..., None])[..., 0]
    KH = torch.cat([K, torch.zeros_like(K)], dim=2)      # K H, (B, 6, 6)
    eye = torch.eye(6, dtype=dtype, device=st.x.device)
    return EkfState(x=x_new, P=(eye - KH) @ st.P)
