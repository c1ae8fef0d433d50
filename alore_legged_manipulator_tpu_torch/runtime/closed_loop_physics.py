"""Closed-loop tracking on the CONTACT-PHYSICS plant (port of
runtime/closed_loop_physics.py).

The plant is the grasped robot + object assembly of `world/physics2d.py`,
so the pushed object's ICR dynamics emerge from the grasp geometry and
slip.  Per 100 Hz control tick:

  1. NMPC RTI on the EKF's estimate of the OBJECT pose, with the EKF's
     online-identified ICR (per lane) as the model;
  2. the wheel command maps to the object's twist through that ICR and
     to the robot's servo command (the robot sidesteps -L*w in turns);
  3. the contact engine advances `substeps` times (servo -> contact ->
     grasp weld -> floor friction);
  4. the EKF updates from the noisy OBJECT pose.

No ground-truth ICR appears in the loop.  Batched over the lanes of a
`TrackedTraj`; the JAX lax.scan becomes a Python loop over ticks.  The
pose noise is drawn from one torch.Generator on the lanes' device
seeded with `seed` (`jax.random` streams are not reproduced; parity runs
set pose_noise=0).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..control.nmpc import NmpcConfig, nmpc_init, nmpc_rti_step
from ..control.tracked_traj import TrackedTraj, pstate, ref_points
from ..core.dynamics import ICRParams, body_vel_from_wheels
from ..estimator.icr_ekf import EkfConfig, ekf_init, ekf_predict, ekf_update
from ..world import physics2d as ph

ROBOT, OBJ = 0, 1


class PhysicsLoopConfig(NamedTuple):
    nmpc: NmpcConfig = NmpcConfig()
    ekf: EkfConfig = EkfConfig()
    physics: ph.PhysicsConfig = ph.PhysicsConfig(
        dt=0.005, grasp_impulse_cap=600.0)
    substeps: int = 2               # 200 Hz physics under 100 Hz control
    icr_guess: tuple = (-0.3, 0.3, 0.2)
    pose_noise: float = 0.001       # object pose measurement noise [m]
    obj_mass: float = 15.0
    obj_fric: float = 0.4
    obj_half_ext: tuple = (0.3, 0.3)
    grasp_anchor_robot: tuple = (0.65, 0.0)


class PhysicsTrackingResult(NamedTuple):
    obj_xytheta: torch.Tensor    # (B, T, 3) true object poses
    robot_xytheta: torch.Tensor  # (B, T, 3) true robot poses
    est: torch.Tensor            # (B, T, 6) EKF states
    u_cmd: torch.Tensor          # (B, T, 2) wheel commands (vr, vl)
    pos_err: torch.Tensor        # (B, T) object distance to reference pose
    grasp_gap: torch.Tensor      # (B, T) weld anchor separation


def _docked_bodies(obj_pose, cfg: PhysicsLoopConfig, dtype):
    """Robot docked behind each object (B, 3), the EE anchor on the
    object's rear face.  Returns (BodyState (B, 2, ...), anchor_r (2,),
    anchor_o (2,))."""
    dev = obj_pose.device
    B = obj_pose.shape[0]
    he_o = torch.tensor(cfg.obj_half_ext, dtype=dtype, device=dev)
    anchor_r = torch.tensor(cfg.grasp_anchor_robot, dtype=dtype, device=dev)
    anchor_o = torch.stack([-he_o[0], torch.zeros((), dtype=dtype,
                                                  device=dev)])
    yaw = obj_pose[:, 2]
    c, s = torch.cos(yaw), torch.sin(yaw)
    robot_pos = obj_pose[:, :2] + ph._rotate(c, s, anchor_o) \
        - ph._rotate(c, s, anchor_r)
    poses = torch.stack([torch.cat([robot_pos, yaw[:, None]], -1), obj_pose],
                        dim=1)
    masses = torch.tensor([60.0, cfg.obj_mass], dtype=dtype,
                          device=dev).expand(B, 2)
    half_ext = torch.stack([torch.tensor([0.45, 0.30], dtype=dtype,
                                         device=dev), he_o]).expand(B, 2, 2)
    bodies = ph.BodyState(
        pose=poses, vel=torch.zeros((B, 2, 3), dtype=dtype, device=dev),
        mass=masses, inertia=ph.box_inertia(masses, half_ext),
        half_ext=half_ext,
        box_off=torch.zeros((B, 2, 2), dtype=dtype, device=dev),
        mu_ground=torch.tensor([1.0, cfg.obj_fric], dtype=dtype,
                               device=dev).expand(B, 2))
    return bodies, anchor_r, anchor_o


def simulate_tracking_physics(tt: TrackedTraj, n_ticks: int,
                              cfg: PhysicsLoopConfig = PhysicsLoopConfig(),
                              seed: int = 0) -> PhysicsTrackingResult:
    """Track planned object trajectories (B lanes) with the contact plant."""
    dtype, dev = tt.seq.dtype, tt.seq.device
    dt = cfg.nmpc.dt
    x_start = tt.seq[:, 0]
    B = x_start.shape[0]

    bodies, anchor_r, anchor_o = _docked_bodies(x_start, cfg, dtype)
    grasp = (torch.tensor(True, device=dev), ROBOT, anchor_r, OBJ, anchor_o,
             torch.tensor(True, device=dev))
    servo_mask = torch.tensor([True, False], device=dev)
    pairs = [(ROBOT, OBJ)]
    L = cfg.grasp_anchor_robot[0] + cfg.obj_half_ext[0]

    ekf = ekf_init(x_start, cfg.icr_guess, cfg.ekf, dtype)
    carry = nmpc_init(cfg.nmpc, x_start, dtype)
    gen = None
    if cfg.pose_noise != 0.0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    u_prev = torch.zeros((B, 2), dtype=dtype, device=dev)

    xs, rxs, es, us, perr, gaps = [], [], [], [], [], []
    for k in range(n_ticks):
        # tick time rounded as the JAX scan forms it, in the lanes' dtype
        t_k = torch.tensor(float(k), dtype=dtype) * dt
        t, t_next = float(t_k), float(t_k + dt)

        # --- NMPC on the EKF estimate, with the IDENTIFIED ICR ---
        est_pose = ekf.x[:, :3]
        icr_est = ICRParams(yr=ekf.x[:, 3], yl=ekf.x[:, 4], xv=ekf.x[:, 5])
        ref_x, ref_u = ref_points(tt, t, cfg.nmpc.horizon, dt, est_pose[:, 2])
        carry, u_cmd, _, _ = nmpc_rti_step(carry, est_pose, ref_x, ref_u,
                                           icr_est, cfg.nmpc)

        # --- EKF predict on the applied command (vl, vr order) ---
        ekf = ekf_predict(ekf, torch.stack([u_prev[:, 1], u_prev[:, 0]], 1),
                          dt, cfg.ekf)

        # --- wheel command -> the OBJECT's twist through the model, then
        #     the robot's: v_robot = v_obj + w x r with r = -L along x ---
        v, w, vy = body_vel_from_wheels(u_prev[:, 1], u_prev[:, 0], icr_est)
        servo_cmd = torch.stack([v, vy - L * w, w], dim=-1)
        for _ in range(cfg.substeps):
            wf = ph.servo_forces(bodies, ROBOT, servo_cmd, cfg.physics)
            bodies, _ = ph.physics_substep(bodies, wf, pairs, cfg.physics,
                                           grasp=grasp, servo_mask=servo_mask)

        # --- EKF pose update from the noisy OBJECT pose ---
        obj_pose = bodies.pose[:, OBJ]
        if gen is not None:
            obj_pose = obj_pose + cfg.pose_noise * torch.randn(
                (B, 3), generator=gen, dtype=dtype, device=dev)
        ekf = ekf_update(ekf, obj_pose, cfg.ekf)

        # diagnostics
        ref_now = pstate(tt, torch.full((B, 1), t_next, dtype=dtype,
                                        device=dev))[:, 0]
        obj, rob = bodies.pose[:, OBJ], bodies.pose[:, ROBOT]
        perr.append(torch.linalg.vector_norm(obj[:, :2] - ref_now[:, :2],
                                             dim=-1))
        ro = ph._rotate(torch.cos(obj[:, 2]), torch.sin(obj[:, 2]), anchor_o)
        rr = ph._rotate(torch.cos(rob[:, 2]), torch.sin(rob[:, 2]), anchor_r)
        gaps.append(torch.linalg.vector_norm(
            (obj[:, :2] + ro) - (rob[:, :2] + rr), dim=-1))
        xs.append(obj)
        rxs.append(rob)
        es.append(ekf.x)
        us.append(u_cmd)
        u_prev = u_cmd

    return PhysicsTrackingResult(
        obj_xytheta=torch.stack(xs, 1), robot_xytheta=torch.stack(rxs, 1),
        est=torch.stack(es, 1), u_cmd=torch.stack(us, 1),
        pos_err=torch.stack(perr, 1), grasp_gap=torch.stack(gaps, 1))
