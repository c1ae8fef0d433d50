"""Stepped closed-loop runtime: plant + ICR-EKF + NMPC at reference
rates (port of runtime/closed_loop.py::simulate_tracking).

Ground-truth plant at 500 Hz (5 substeps), EKF predict per wheel
command, EKF pose update per tick, NMPC at 100 Hz, input applied with
one tick of latency (planner_sim.launch:91-214).  Batched over a
leading lane axis; the JAX lax.scan becomes a Python loop over ticks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..control.nmpc import NmpcConfig, nmpc_init, nmpc_rti_step
from ..control.tracked_traj import TrackedTraj, pstate, ref_points
from ..core.dynamics import ICRParams
from ..estimator.icr_ekf import EkfConfig, ekf_init, ekf_predict, ekf_update
from ..world.plant import PlantConfig, plant_init, plant_step


class LoopConfig(NamedTuple):
    nmpc: NmpcConfig = NmpcConfig()
    ekf: EkfConfig = EkfConfig()
    plant: PlantConfig = PlantConfig()
    substeps: int = 5
    use_ekf_icr: bool = True
    icr_guess: tuple = (-0.2, 0.2, 0.1)


class TrackingResult(NamedTuple):
    xytheta: torch.Tensor      # (B, T, 3) true plant poses
    est: torch.Tensor          # (B, T, 6) EKF states
    u_cmd: torch.Tensor        # (B, T, 2) wheel commands (vr, vl)
    pos_err: torch.Tensor      # (B, T) distance to reference pose
    icr_err: torch.Tensor      # (B, T) EKF ICR parameter error norm


def simulate_tracking(tt: TrackedTraj, true_icr: ICRParams, n_ticks: int,
                      cfg: LoopConfig = LoopConfig(), seed: int = 0,
                      x0=None):
    """Track planned trajectories closed-loop for n_ticks control ticks.

    Plant noise (cfg.plant.add_noise) is drawn from a torch.Generator on
    the lanes' device seeded with `seed`."""
    dtype, dev = tt.seq.dtype, tt.seq.device
    dt = cfg.nmpc.dt
    x_start = tt.seq[:, 0] if x0 is None else torch.as_tensor(x0).to(dtype)
    B = x_start.shape[0]

    plant = plant_init(x_start, dtype)
    ekf = ekf_init(x_start, cfg.icr_guess, cfg.ekf, dtype)
    carry = nmpc_init(cfg.nmpc, x_start, dtype)
    gen = None
    if cfg.plant.add_noise:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    u_prev = torch.zeros((B, 2), dtype=dtype, device=dev)
    true_vec = torch.tensor([float(true_icr.yr), float(true_icr.yl),
                             float(true_icr.xv)], dtype=dtype, device=dev)

    xs, es, us, perr, ierr = [], [], [], [], []
    for k in range(n_ticks):
        # tick time rounded as the JAX scan forms it, in the lanes' dtype
        t_k = torch.tensor(float(k), dtype=dtype) * dt
        t, t_next = float(t_k), float(t_k + dt)
        # --- NMPC tick (100 Hz) on the EKF estimate ---
        est_pose = ekf.x[:, :3]
        icr_est = (ICRParams(yr=ekf.x[:, 3], yl=ekf.x[:, 4], xv=ekf.x[:, 5])
                   if cfg.use_ekf_icr else true_icr)
        ref_x, ref_u = ref_points(tt, t, cfg.nmpc.horizon, dt, est_pose[:, 2])
        carry, u_cmd, _, _ = nmpc_rti_step(carry, est_pose, ref_x, ref_u,
                                           icr_est, cfg.nmpc)

        # --- EKF predict on the *applied* command (vl, vr order) ---
        u_applied = torch.stack([u_prev[:, 1], u_prev[:, 0]], dim=1)
        ekf = ekf_predict(ekf, u_applied, dt, cfg.ekf)

        # --- plant substeps at 500 Hz with the applied command ---
        for j in range(cfg.substeps):
            plant = plant_step(plant, u_applied, true_icr, dt / cfg.substeps,
                               cfg.plant, generator=gen)

        # --- EKF pose update from the plant pose ---
        ekf = ekf_update(ekf, plant.xytheta, cfg.ekf)

        ref_now = pstate(tt, torch.full((B, 1), t_next, dtype=dtype,
                                        device=dev))[:, 0]
        xs.append(plant.xytheta)
        es.append(ekf.x)
        us.append(u_cmd)
        perr.append(torch.linalg.vector_norm(
            plant.xytheta[:, :2] - ref_now[:, :2], dim=-1))
        ierr.append(torch.linalg.vector_norm(ekf.x[:, 3:6] - true_vec,
                                             dim=-1))
        u_prev = u_cmd

    return TrackingResult(xytheta=torch.stack(xs, 1), est=torch.stack(es, 1),
                          u_cmd=torch.stack(us, 1), pos_err=torch.stack(perr, 1),
                          icr_err=torch.stack(ierr, 1))
