"""Batched object-pushing environment, the first-order surrogate plant
(port of rl/env.py).

Capability rebuild of the reference IsaacLab Direct env
(Training/b2z1_multiobj_wbc_gnn_plan/b2z1_multiobj_wbc_gnn_plan_env_train.py,
B2Z1MultiObjWBCGNNPLANEnv): the hierarchical high-level policy commands the
*object's* planar velocity (3) plus 6 arm joint deltas; rewards regulate
object-velocity tracking with smoothness/effort penalties; episodes are
20 s at a 50 Hz control rate.  The pushed object is a planar rigid body
with randomized mass/friction/COM whose commanded velocity is realized
through a first-order contact model with lateral ICR slip.

Every field of `PushEnvState` carries a leading lane axis (B, ...) where
the JAX package vmaps one env.  `env_reset` draws from an explicit
`torch.Generator` (the JAX package splits a PRNG key; the streams differ,
so parity runs convert the JAX package's reset states).  The state's
`key` is carried unchanged: the JAX package splits it on every
observation but never draws from it after the reset.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.precision import resolve_device
from .obs_layout import (RobotView, actor_observation,
                         critic_observation_161, default_joint_pos)

N_ACTIONS = 9          # obj (vx, vy, wz) + 6 arm joint deltas
OBS_DIM = 70           # per-step actor observation (rl/obs_layout.py)
HIST = 11
CRITIC_DIM = 161       # privileged critic width (env_train.py:757-790)

# object boxes per class (chair / table / box) and the EE grasp anchor
# in the base frame -- shared with the contact env (rl/env_physics.py)
OBJ_HALF_EXT = ((0.30, 0.30), (0.50, 0.35), (0.25, 0.20))
GRASP_ANCHOR_ROBOT = (0.65, 0.0)


class PushEnvConfig(NamedTuple):
    dt: float = 0.02               # 50 Hz high-level control
    episode_len_s: float = 20.0
    action_scale_lin: float = 1.0  # m/s
    action_scale_ang: float = 1.0  # rad/s
    action_scale_arm: float = 0.1
    # contact model ranges (randomized per episode)
    mass_range: tuple = (5.0, 40.0)
    friction_range: tuple = (0.3, 1.2)
    com_range: float = 0.15
    # reward scales (structure of cfg :821-852)
    w_track_lin: float = 2.0
    w_track_ang: float = 1.0
    w_align: float = 0.5
    w_smooth: float = -0.05
    w_arm_effort: float = -0.01
    tip_vel_limit: float = 3.5

    @property
    def max_steps(self) -> int:
        return int(self.episode_len_s / self.dt)


class PushEnvState(NamedTuple):
    obj_pose: torch.Tensor      # (B, 3) x, y, yaw (world)
    obj_vel: torch.Tensor       # (B, 3) vx, vy, wz (body frame)
    arm_q: torch.Tensor         # (B, 6)
    cmd: torch.Tensor           # (B, 3) commanded object velocity
    mass: torch.Tensor          # (B,)
    friction: torch.Tensor      # (B,)
    com: torch.Tensor           # (B, 2) center-of-mass offset
    obj_type: torch.Tensor      # (B,) int: 0 chair / 1 table / 2 box
    prev_action: torch.Tensor   # (B, 9)
    obs_hist: torch.Tensor      # (B, HIST, OBS_DIM)
    t: torch.Tensor             # (B,) int32 step counter
    key: torch.Tensor           # (B, 2) carried, never drawn from


def _scales(cfg: PushEnvConfig, like):
    return torch.tensor([cfg.action_scale_lin, cfg.action_scale_lin,
                         cfg.action_scale_ang], dtype=like.dtype,
                        device=like.device)


def _rotate(yaw, v):
    """Rotate (..., 2) vectors by yaw (the JAX package's R @ v)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([c * v[..., 0] - s * v[..., 1],
                        s * v[..., 0] + c * v[..., 1]], dim=-1)


def _arm_q18(arm_q):
    """Stance legs + arm home offset by the env's arm joints."""
    q = default_joint_pos(arm_q.dtype, arm_q.device).expand(
        arm_q.shape[:-1] + (18,)).clone()
    q[..., 12:] = q[..., 12:] + arm_q
    return q


def robot_view_docked(st: PushEnvState) -> RobotView:
    """The surrogate world's robot: rigidly docked behind the object at
    the grasp anchor (env_train.py:429, 438-443), legs holding the
    locomotion stance, arm at the env's arm joint state.  Base velocity
    is the rigid-pair transport of the object's body velocity."""
    dtype, dev = st.obj_vel.dtype, st.obj_vel.device
    he = torch.tensor(OBJ_HALF_EXT, dtype=dtype, device=dev)[
        st.obj_type.long()]
    anchor_o = torch.stack([-he[..., 0], torch.zeros_like(he[..., 0])], -1)
    anchor_r = torch.tensor(GRASP_ANCHOR_ROBOT, dtype=dtype, device=dev)
    yaw = st.obj_pose[..., 2]
    d = anchor_o - anchor_r
    pos = st.obj_pose[..., :2] + _rotate(yaw, d)
    # rigid transport: v_r = v_o + w x (p_r - p_o), all body-frame
    w = st.obj_vel[..., 2]
    base_vel = torch.stack([st.obj_vel[..., 0] - w * d[..., 1],
                            st.obj_vel[..., 1] + w * d[..., 0], w], dim=-1)
    q = _arm_q18(st.arm_q)
    return RobotView(base_pose=torch.cat([pos, yaw[..., None]], dim=-1),
                     base_vel=base_vel, q=q, dq=torch.zeros_like(q))


def _observe(st: PushEnvState, cfg: PushEnvConfig, rv: RobotView = None):
    """Per-step 70-d actor observation (env_train.py:687-711) via
    rl/obs_layout.actor_observation, and the carried key."""
    if rv is None:
        rv = robot_view_docked(st)
    obs = actor_observation(st, rv, default_joint_pos(st.obj_vel.dtype,
                                                      st.obj_vel.device))
    return obs, st.key


def critic_observation(st: PushEnvState, cfg: PushEnvConfig,
                       rv: RobotView = None, gripper_ok=None):
    """The 161-d privileged critic observation (env_train.py:757-790)
    via rl/obs_layout.critic_observation_161."""
    if rv is None:
        rv = robot_view_docked(st)
    if gripper_ok is None:
        gripper_ok = torch.ones(st.obj_vel.shape[:-1], dtype=torch.bool,
                                device=st.obj_vel.device)
    return critic_observation_161(
        st, rv, default_joint_pos(st.obj_vel.dtype, st.obj_vel.device),
        gripper_ok)


def graph_features(st: PushEnvState):
    """Structured features for the interaction GNN (models/gnn.py):
    (base_feat (B, 5), joint_feats (B, 6, 11), ee_feat (B, 8),
    object_feat (B, 10), joint_poses (B, 6, 7), ee_pose (B, 7),
    object_pose (B, 7))."""
    dtype, dev = st.obj_vel.dtype, st.obj_vel.device
    lead = st.obj_vel.shape[:-1]
    yaw = st.obj_pose[..., 2:3]
    base_feat = torch.cat([torch.sin(yaw), torch.cos(yaw), st.obj_vel], -1)
    q = st.arm_q                                             # (B, 6)
    zero = torch.zeros_like(q)
    one = torch.ones_like(q)
    xj = torch.tensor([0.1 * (j + 1) for j in range(6)], dtype=dtype,
                      device=dev).expand(lead + (6,))
    joint_poses = torch.stack([xj, zero, 0.05 * q, zero, zero, zero, one],
                              dim=-1)                        # (B, 6, 7)
    joint_feats = torch.cat([joint_poses, torch.stack([q, zero, q, zero],
                                                      dim=-1)], dim=-1)
    ee_pose = torch.tensor([0.7, 0.0, 0.3, 0.0, 0.0, 0.0, 1.0], dtype=dtype,
                           device=dev).expand(lead + (7,))
    ee_feat = torch.cat([ee_pose, torch.ones(lead + (1,), dtype=dtype,
                                             device=dev)], dim=-1)
    head = torch.tensor([0.8, 0.0, 0.0, 0.0, 0.0], dtype=dtype,
                        device=dev).expand(lead + (5,))
    obj_pose7 = torch.cat([head, torch.sin(yaw / 2), torch.cos(yaw / 2)], -1)
    object_feat = torch.cat([obj_pose7, st.cmd], dim=-1)
    return (base_feat, joint_feats, ee_feat, object_feat, joint_poses,
            ee_pose, obj_pose7)


def _uniform(gen, shape, lo, hi, dtype, dev):
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    return (lo + (hi - lo) * u).to(dtype=dtype, device=dev)


def _draw_key(gen, n, dev):
    return torch.randint(0, 2 ** 31 - 1, (n, 2), generator=gen,
                         dtype=torch.int64).to(dev)


def env_reset(gen: torch.Generator, cfg: PushEnvConfig = PushEnvConfig(),
              dtype=torch.float32, n_envs: int = 1,
              device=None) -> PushEnvState:
    """`n_envs` fresh episodes drawn from the CPU generator `gen`, on
    `device` (None: the card)."""
    dev = resolve_device(device)
    B = n_envs
    mass = _uniform(gen, (B,), *cfg.mass_range, dtype, dev)
    fric = _uniform(gen, (B,), *cfg.friction_range, dtype, dev)
    com = _uniform(gen, (B, 2), -cfg.com_range, cfg.com_range, dtype, dev)
    cmd = _uniform(gen, (B, 3), -1.0, 1.0, dtype, dev) \
        * torch.tensor([1.0, 0.5, 1.0], dtype=dtype, device=dev)
    obj_type = torch.randint(0, 3, (B,), generator=gen).to(dev)
    z = dict(dtype=dtype, device=dev)
    st = PushEnvState(
        obj_pose=torch.zeros(B, 3, **z), obj_vel=torch.zeros(B, 3, **z),
        arm_q=torch.zeros(B, 6, **z), cmd=cmd, mass=mass, friction=fric,
        com=com, obj_type=obj_type, prev_action=torch.zeros(B, 9, **z),
        obs_hist=torch.zeros(B, HIST, OBS_DIM, **z),
        t=torch.zeros(B, dtype=torch.int32, device=dev),
        key=_draw_key(gen, B, dev))
    obs, key = _observe(st, cfg)
    hist = obs[:, None, :].expand(B, HIST, OBS_DIM).clone()
    return st._replace(obs_hist=hist, key=key)


def _reward_and_done(st, vel, a, prev_a, arm_delta, cfg: PushEnvConfig):
    """The _get_rewards structure and the velocity-blowup / timeout
    dones shared by both envs."""
    err_lin = torch.sum((st.cmd[..., :2] - vel[..., :2]) ** 2, dim=-1)
    err_ang = (st.cmd[..., 2] - vel[..., 2]) ** 2
    r_track = cfg.w_track_lin * torch.exp(-err_lin / 0.25) \
        + cfg.w_track_ang * torch.exp(-err_ang / 0.25)
    vdir, cdir = vel[..., :2], st.cmd[..., :2]
    align = torch.sum(vdir * cdir, dim=-1) / (
        torch.linalg.vector_norm(vdir, dim=-1)
        * torch.linalg.vector_norm(cdir, dim=-1) + 1e-6)
    r_align = cfg.w_align * align
    r_smooth = cfg.w_smooth * torch.sum((a - prev_a) ** 2, dim=-1)
    r_arm = cfg.w_arm_effort * torch.sum(arm_delta ** 2, dim=-1)
    reward = r_track + r_align + r_smooth + r_arm
    tipped = torch.linalg.vector_norm(vel, dim=-1) > cfg.tip_vel_limit
    timeout = st.t >= cfg.max_steps
    return reward, tipped | timeout


def env_step(st: PushEnvState, action, cfg: PushEnvConfig = PushEnvConfig(),
             rv: RobotView = None):
    """One 50 Hz step.  Returns (new_state, obs_hist, reward, done).

    rv: optional RobotView supplying real robot state for the
    observation (hierarchy mode passes the WBC's RobotState view);
    default = the docked surrogate view."""
    dtype = st.obj_vel.dtype
    a = torch.clamp(action, -1.0, 1.0).to(dtype)
    vel_cmd = a[..., :3] * _scales(cfg, a)
    arm_delta = a[..., 3:] * cfg.action_scale_arm

    # contact surrogate: commanded velocity realized through first-order
    # dynamics; heavier / lower-friction objects respond slower; the COM
    # offset couples angular command into lateral drift (ICR behavior)
    type_inertia = torch.tensor([1.0, 1.6, 0.7], dtype=dtype,
                                device=a.device)[st.obj_type.long()]
    tau = 0.08 * st.mass / 10.0 * type_inertia / torch.clamp(st.friction,
                                                             min=0.1)
    alpha = 1.0 - torch.exp(-cfg.dt / torch.clamp(tau, min=1e-3))
    slip = torch.stack([-st.com[..., 1] * vel_cmd[..., 2],
                        st.com[..., 0] * vel_cmd[..., 2],
                        torch.zeros_like(vel_cmd[..., 2])], dim=-1)
    vel_new = st.obj_vel + alpha[..., None] * (vel_cmd + slip - st.obj_vel)

    yaw = st.obj_pose[..., 2]
    dpos = torch.cat([_rotate(yaw, vel_new[..., :2]), vel_new[..., 2:]], -1)
    pose_new = st.obj_pose + cfg.dt * dpos
    arm_new = torch.clamp(st.arm_q + arm_delta, -1.5, 1.5)

    prev_a = st.prev_action
    st = st._replace(obj_pose=pose_new, obj_vel=vel_new, arm_q=arm_new,
                     prev_action=a, t=st.t + 1)
    obs, key = _observe(st, cfg, rv)
    hist = torch.cat([st.obs_hist[:, 1:], obs[:, None]], dim=1)
    st = st._replace(obs_hist=hist, key=key)
    reward, done = _reward_and_done(st, vel_new, a, prev_a, arm_delta, cfg)
    return st, hist, reward, done
