"""ICR-EKF: joint pose + ICR-parameter estimation (port of
estimator/icr_ekf.py), with the auxiliary publisher-tick estimator and
convergence monitor (icrekf.cpp:225-332).

State x = [x, y, psi, yr, yl, xv] (icrekf.h).  Predict on each wheel
command (vl, vr) with the exact ICR step and its Jacobian (icrekf.cpp:
99-207, textbook J P J' -- the reference's F'PF with its transposed
storage); update on pose observations with H = [I3 0] and yaw unwrapped
toward the estimate (:68-69, :210-222).  Batched: x (B, 6), P (B, 6, 6).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.angles import unwrap_to
from ..utils.precision import resolve_device


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


# ---------------------------------------------------------------------------
# auxiliary runtime estimator + convergence monitor (icrekf.cpp:225-332)
# ---------------------------------------------------------------------------

class FirstOrderFilter(NamedTuple):
    """Discrete first-order low-pass (icrekf.h:27-50).

    y[k] = b * u[k] + a * y[k-1],  a = exp(-2 pi fc / fs),  b = 1 - a.
    Functional: carry the previous output, step returns (new_state, y).
    The output takes the shape of the samples, so one filter serves any
    number of lanes.
    """

    a: torch.Tensor
    y: torch.Tensor

    @staticmethod
    def create(cutoff_hz, sampling_hz, dtype=torch.float32, device=None):
        """The state lies on the card unless `device` says otherwise
        (device=None means CUDA and raises when it is missing)."""
        device = resolve_device(device)
        a = torch.exp(torch.tensor(-2.0 * math.pi * cutoff_hz / sampling_hz,
                                   dtype=dtype, device=device))
        return FirstOrderFilter(a=a, y=torch.zeros((), dtype=dtype,
                                                   device=device))

    def step(self, u):
        y = (1.0 - self.a) * u + self.a * self.y
        return self._replace(y=y), y


class SimpleIcrState(NamedTuple):
    """Low-passed algebraic ICR estimate (icrekf.cpp:305-330).

    When |omega| is informative (> 0.1 rad/s) the ICR parameters follow
    directly from body velocities and wheel speeds:
        yl = (vx - v_l) / omega     (v_l = vx - yl * omega)
        yr = (vx - v_r) / omega
        xv = -vy / omega            (vy = -xv * omega)
    each pushed through a first-order low-pass; otherwise the sample fed
    to the filters is 0 (the reference publishes 0 for yl/yr/xv when
    |omega| <= 0.1, :306-325).
    """

    f_yl: FirstOrderFilter
    f_yr: FirstOrderFilter
    f_xv: FirstOrderFilter

    @staticmethod
    def create(cutoff_hz=0.5, sampling_hz=100.0, dtype=torch.float32,
               device=None):
        """device=None means CUDA, as in `FirstOrderFilter.create`."""
        device = resolve_device(device)

        def mk():
            return FirstOrderFilter.create(cutoff_hz, sampling_hz, dtype,
                                           device)
        return SimpleIcrState(mk(), mk(), mk())

    def step(self, vx, vy, omega, wheel_l, wheel_r, omega_eps=0.1):
        """One publisher tick on scalars or (B,) lanes.  Returns
        (new_state, (..., 3) [yl, yr, xv])."""
        ok = torch.abs(omega) > omega_eps
        w_safe = torch.where(ok, omega, torch.ones_like(omega))
        zero = torch.zeros_like(omega)
        raw_yl = torch.where(ok, (vx - wheel_l) / w_safe, zero)
        raw_yr = torch.where(ok, (vx - wheel_r) / w_safe, zero)
        raw_xv = torch.where(ok, -vy / w_safe, zero)
        f_yl, yl = self.f_yl.step(raw_yl)
        f_yr, yr = self.f_yr.step(raw_yr)
        f_xv, xv = self.f_xv.step(raw_xv)
        return SimpleIcrState(f_yl, f_yr, f_xv), torch.stack([yl, yr, xv], -1)


class ConvergenceMonitor(NamedTuple):
    """Per-parameter ICR convergence detector (icrekf.cpp:272-303).

    A parameter is declared converged (latched) once its relative error
    vs the ground-truth standard stays below 1% for more than 10
    consecutive publisher ticks; the tick count at latch time is
    recorded.  Mirrors the reference's `index_*_standard_ ++ > 10` /
    reset-on-violation logic exactly.
    """

    count: torch.Tensor       # (..., 3) consecutive in-tolerance ticks
    converged: torch.Tensor   # (..., 3) bool, latched
    latch_tick: torch.Tensor  # (..., 3) tick index at convergence (-1 = not yet)
    tick: torch.Tensor        # () running tick counter

    @staticmethod
    def create(batch_shape=(), device=None):
        """The counters lie on the card unless `device` says otherwise
        (device=None means CUDA and raises when it is missing); `step`
        takes estimates on the same device."""
        device = resolve_device(device)
        shape = (*batch_shape, 3)
        return ConvergenceMonitor(
            count=torch.zeros(shape, dtype=torch.int32, device=device),
            converged=torch.zeros(shape, dtype=torch.bool, device=device),
            latch_tick=torch.full(shape, -1, dtype=torch.int32,
                                  device=device),
            tick=torch.zeros((), dtype=torch.int32, device=device))

    def step(self, icr_est, icr_standard, rel_tol=0.01, hold_ticks=10):
        """icr_est, icr_standard: (..., 3) [yr, yl, xv] (state order
        x[3:6])."""
        std = torch.as_tensor(icr_standard, dtype=icr_est.dtype,
                              device=icr_est.device)
        ok = torch.abs(icr_est - std) / torch.abs(std) < rel_tol
        # the reference increments then compares (index++ > 10): the
        # latch fires on the (hold_ticks + 2)-th consecutive in-tolerance
        # tick
        count = torch.where(ok, self.count + 1, torch.zeros_like(self.count))
        fire = ~self.converged & (count > hold_ticks + 1)
        latch = torch.where(fire, self.tick, self.latch_tick)
        return ConvergenceMonitor(count=count,
                                  converged=self.converged | fire,
                                  latch_tick=latch, tick=self.tick + 1)


def covariance_report(st: EkfState):
    """Publisher-tick covariance diagnostics (icrekf.cpp:262-270):
    (pose_var (B, 3), icr_var (B, 3)), the diagonal blocks of P in state
    order (yr, yl, xv for the ICR block)."""
    d = torch.diagonal(st.P, dim1=-2, dim2=-1)
    return d[..., :3], d[..., 3:6]
