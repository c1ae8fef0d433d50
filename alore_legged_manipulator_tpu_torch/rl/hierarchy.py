"""Hierarchical env mode: the frozen low-level WBC inside the env step
(port of rl/hierarchy.py).

Capability rebuild of the reference `_apply_action`
(b2z1_multiobj_wbc_gnn_plan_env_train.py:438-543): each 50 Hz high-level
step runs `decimation` (4) low-level sub-steps at 200 Hz; every sub-step

  1. assembles the 71-d low-level proprioceptive observation
     (_compute_low_level_observation :545-607) and its 10-step history,
  2. runs the FROZEN ActorCriticLow with hist_encoding=True (:518) to
     produce 18 joint targets,
  3. zeroes the arm part (:519), scales and offsets by the default joint
     pose (:525-526),
  4. advances the joint state through a per-joint PD servo (kp 360 /
     kd 5, configs/b2z1.yaml), and realizes the commanded base velocity
     scaled by how far the legs are held from the stance.

The low-level policy is the port's `ActorCriticLow` module itself (its
weights inside; the JAX package passes a flax module and its
parameters apart).  States carry a leading lane axis; the `fori_loop`
over the decimation is a Python loop.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.low_level import ActorCriticLow
from ..runtime.obs_assembly import (HIST as LOW_HIST, N_PROP as LOW_OBS,
                                    LowObsState, assemble_low_level_obs)
from ..utils.precision import resolve_device
from .obs_layout import DEFAULT_JOINT_POS  # noqa: F401 (single source)
from .obs_layout import RobotView, default_joint_pos

N_JOINTS = 18          # 12 leg + 6 arm


class HierarchyConfig(NamedTuple):
    decimation: int = 4            # 200 Hz low level under 50 Hz high level
    sim_dt: float = 1.0 / 200.0
    action_scale_low: float = 0.25  # cfg.action_scale_low_level
    kp: float = 360.0
    kd: float = 5.0
    joint_inertia: float = 1.2
    # locomotion-quality coupling: base realizes commands scaled by
    # exp(-stance_sensitivity * mean((q_leg - q_default)^2))
    stance_sensitivity: float = 2.0
    base_response: float = 12.0    # 1/s first-order base-velocity response


def low_level_policy_cfg() -> ActorCriticLow:
    """The shipped low-level architecture (env_train.py:1401-1427), with
    torch's default initialisation; load a checkpoint into it."""
    return ActorCriticLow(num_prop=LOW_OBS, num_hist=LOW_HIST, num_priv=18,
                          priv_latent=20, backbone_hidden=(512, 256, 128),
                          leg_head_hidden=(128, 128),
                          arm_head_hidden=(128, 128))


class RobotState(NamedTuple):
    base_pose: torch.Tensor   # (B, 3) x, y, yaw
    base_vel: torch.Tensor    # (B, 3) body vx, vy, wz
    q: torch.Tensor           # (B, 18) joint positions
    dq: torch.Tensor          # (B, 18) joint velocities
    prev_low_action: torch.Tensor  # (B, 18)
    obs_state: LowObsState         # exact 799-d assembly carry


def robot_reset(dtype=torch.float32, n_envs: int = 1,
                device=None) -> RobotState:
    dev = resolve_device(device)
    z = dict(dtype=dtype, device=dev)
    return RobotState(
        base_pose=torch.zeros(n_envs, 3, **z),
        base_vel=torch.zeros(n_envs, 3, **z),
        q=default_joint_pos(dtype, dev).expand(n_envs, N_JOINTS).clone(),
        dq=torch.zeros(n_envs, N_JOINTS, **z),
        prev_low_action=torch.zeros(n_envs, N_JOINTS, **z),
        obs_state=LowObsState.create(dtype, dev, batch=(n_envs,)))


def hierarchical_substep(rs: RobotState, vel_cmd, low_policy: ActorCriticLow,
                         cfg: HierarchyConfig) -> RobotState:
    """One 200 Hz low-level tick (reference :516-543).

    Observation assembly uses the EXACT deployment layout
    (runtime/obs_assembly.py); the planar surrogate supplies
    roll = pitch = 0 and body angular velocity (0, 0, wz)."""
    dtype, dev = rs.q.dtype, rs.q.device
    zero = torch.zeros_like(rs.base_vel[:, 2])
    ang_vel = torch.stack([zero, zero, rs.base_vel[:, 2]], dim=-1)
    q_def = default_joint_pos(dtype, dev)
    obs_state, obs, _ = assemble_low_level_obs(
        rs.obs_state._replace(prev_leg_action=rs.prev_low_action[:, :12]),
        zero, zero, ang_vel, rs.q, rs.dq, q_def, vel_cmd, cfg.sim_dt)

    # frozen policy, history encoding (hist_encoding=True, :518)
    with torch.no_grad():
        act = low_policy(obs, obs_state.hist).clone()
    act[:, 12:] = 0.0                              # :519 arm zeroed
    q_target = cfg.action_scale_low * act + q_def

    # PD joint servo (kp/kd of configs/b2z1.yaml through unit inertia)
    ddq = (cfg.kp * (q_target - rs.q) - cfg.kd * rs.dq) / cfg.joint_inertia
    dq = rs.dq + cfg.sim_dt * ddq
    q = rs.q + cfg.sim_dt * dq

    # locomotion quality from stance deviation of the LEG joints
    leg_dev = torch.mean((q[:, :12] - q_def[:12]) ** 2, dim=-1)
    quality = torch.exp(-cfg.stance_sensitivity * leg_dev)
    target_vel = vel_cmd * quality[:, None]
    beta = 1.0 - math.exp(-cfg.base_response * cfg.sim_dt)
    base_vel = rs.base_vel + beta * (target_vel - rs.base_vel)

    yaw = rs.base_pose[:, 2]
    c, s = torch.cos(yaw), torch.sin(yaw)
    dpos = torch.stack([c * base_vel[:, 0] - s * base_vel[:, 1],
                        s * base_vel[:, 0] + c * base_vel[:, 1],
                        base_vel[:, 2]], dim=-1)
    base_pose = rs.base_pose + cfg.sim_dt * dpos
    return RobotState(base_pose=base_pose, base_vel=base_vel, q=q, dq=dq,
                      prev_low_action=act, obs_state=obs_state)


def hierarchical_apply_action(rs: RobotState, vel_cmd,
                              low_policy: ActorCriticLow,
                              cfg: HierarchyConfig = HierarchyConfig()):
    """`decimation` sub-steps of the frozen WBC under one high-level
    command.  Returns the advanced RobotState; `rs.base_vel` is the
    realized base velocity that the object-contact surrogate consumes."""
    for _ in range(cfg.decimation):
        rs = hierarchical_substep(rs, vel_cmd, low_policy, cfg)
    return rs


def hierarchical_env_step(st, rs: RobotState, action,
                          low_policy: ActorCriticLow, cfg=None,
                          hcfg: HierarchyConfig = HierarchyConfig()):
    """One 50 Hz high-level step with the WBC in the loop: the action's
    base part is the velocity command the low-level policy tracks
    (env_train.py:422-435, then the :438+ decimation loop); the object is
    then pushed by the ROBOT'S REALIZED velocity.

    Returns (env_state, robot_state, obs_hist, reward, done).
    """
    from .env import PushEnvConfig, _scales, env_step

    cfg = cfg or PushEnvConfig()
    a = torch.clamp(action, -1.0, 1.0).to(st.obj_vel.dtype)
    vel_cmd = a[:, :3] * _scales(cfg, a)
    rs = hierarchical_apply_action(rs, vel_cmd, low_policy, hcfg)
    # the realized velocity replaces the action's base part
    a_eff = torch.cat([rs.base_vel / _scales(cfg, a), a[:, 3:]], dim=-1)
    # the observation sees the WBC's REAL robot state (q, dq, base)
    rv = RobotView(base_pose=rs.base_pose, base_vel=rs.base_vel,
                   q=rs.q, dq=rs.dq)
    st, hist, reward, done = env_step(st, a_eff, cfg, rv=rv)
    return st, rs, hist, reward, done
