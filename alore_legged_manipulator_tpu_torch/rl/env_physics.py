"""Physics-backed pushing env: real contact dynamics under the policy
(port of rl/env_physics.py).

The same observation/action/reward contract as the surrogate env
(`rl/env.py`), but the object moves ONLY through rigid-body contact and
the grasp weld of `world/physics2d.py` -- the role PhysX plays in the
reference env (env_train.py:438-543).  Per 50 Hz step: action[:3] is
the commanded planar velocity of the traction-limited base servo;
`decimation` (4) substeps at 200 Hz run servo forces, the grasp weld,
box-box contact and floor friction; the object's realized body-frame
velocity is observed and rewarded as in the surrogate env.  A weld
pulled past the grip budget slips until the anchor gap exceeds
`grasp_loss_dist` (the gripper-contact-loss termination).

States carry a leading lane axis, bodies (B, NB, ...) as in the ported
`world/physics2d.py`.  The substep `scan` is a Python loop carrying the
largest robot-obstacle normal impulse.  `env_reset` draws from an
explicit `torch.Generator`: the class, mass, friction, COM offset,
command and yaw, then the bystanders' draws; the JAX package's
bystander stream (`fold_in(k6, 17)`) is not reproduced, so parity runs
convert the JAX package's reset states.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.precision import resolve_device
from ..world import physics2d as ph
from .env import (HIST, N_ACTIONS, OBJ_HALF_EXT, OBS_DIM, PushEnvConfig,
                  PushEnvState, _arm_q18, _draw_key, _reward_and_done,
                  _rotate, _scales, _uniform)
from .obs_layout import RobotView

ROBOT, OBJ = 0, 1

# B2 base footprint ~0.9x0.6 m, mass ~60 kg
ROBOT_HALF_EXT = (0.45, 0.30)
ROBOT_MASS = 60.0


class PhysicsEnvConfig(NamedTuple):
    base: PushEnvConfig = PushEnvConfig()
    decimation: int = 4
    sim_dt: float = 1.0 / 200.0
    grasp_anchor_robot: tuple = (0.65, 0.0)   # EE point in base frame
    grasp_loss_dist: float = 0.15
    # the weld force budget must exceed the worst-case drag force of the
    # object range (40 kg x mu 1.2 -> ~470 N)
    physics: ph.PhysicsConfig = ph.PhysicsConfig(
        dt=1.0 / 200.0, grasp_impulse_cap=600.0)
    # static scene obstacles (infinite-mass bodies appended at reset);
    # a robot-obstacle normal impulse above `collision_impulse_done`
    # [N s] in one substep terminates the episode (env_train.py:984-1002)
    n_obstacles: int = 0
    collision_impulse_done: float = 5.0
    # bystanders: the other object classes as DYNAMIC bodies
    n_bystanders: int = 0


class PhysPushEnvState(NamedTuple):
    bodies: ph.BodyState           # (B, NB, ...): robot, object, others
    obj_anchor: torch.Tensor       # (B, 2) grasp anchor in object frame
    grasp_active: torch.Tensor     # (B,) bool
    cmd: torch.Tensor              # (B, 3) commanded object velocity
    friction: torch.Tensor         # (B,) object-floor mu (privileged)
    com: torch.Tensor              # (B, 2) object COM offset
    obj_type: torch.Tensor         # (B,) int
    arm_q: torch.Tensor            # (B, 6)
    prev_action: torch.Tensor      # (B, 9)
    obs_hist: torch.Tensor         # (B, HIST, OBS_DIM)
    t: torch.Tensor                # (B,) int32
    key: torch.Tensor              # (B, 2) carried


def _body_frame_vel(pose, vel):
    """World (vx, vy, w) -> body frame (vx, vy, w), (..., 3)."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    return torch.stack([c * vel[..., 0] + s * vel[..., 1],
                        -s * vel[..., 0] + c * vel[..., 1], vel[..., 2]],
                       dim=-1)


def robot_view_phys(st: PhysPushEnvState) -> RobotView:
    """RobotView over the contact world's REAL robot body (pose and
    body-frame velocity from the rigid-body state; legs at stance, arm
    at the env's arm joint state)."""
    pose = st.bodies.pose[:, ROBOT]
    q = _arm_q18(st.arm_q)
    return RobotView(base_pose=pose,
                     base_vel=_body_frame_vel(pose, st.bodies.vel[:, ROBOT]),
                     q=q, dq=torch.zeros_like(q))


def _observe(st: PhysPushEnvState, cfg: PhysicsEnvConfig):
    """The surrogate env's observation builder on `as_surrogate_view`
    (one implementation of the 70-d layout) with the real robot body's
    view."""
    from .env import _observe as surrogate_observe
    return surrogate_observe(as_surrogate_view(st), cfg.base,
                             rv=robot_view_phys(st))


def critic_observation(st: PhysPushEnvState, cfg: PhysicsEnvConfig):
    """env.critic_observation on the surrogate view; the gripper-contact
    slot carries the REAL weld state (env_train.py:757-790)."""
    from .env import critic_observation as surrogate_critic
    return surrogate_critic(as_surrogate_view(st), cfg.base,
                            rv=robot_view_phys(st),
                            gripper_ok=st.grasp_active)


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def env_reset(gen: torch.Generator, cfg: PhysicsEnvConfig = PhysicsEnvConfig(),
              dtype=torch.float32, obstacles=None, obj_type=None,
              obj_pose=None, n_envs: int = 1,
              device=None) -> PhysPushEnvState:
    """`n_envs` docked scenes drawn from the CPU generator `gen`, on
    `device` (None: the card).

    obstacles: optional (centers (M, 2), yaws (M,), half_exts (M, 2)),
    shared by every lane -- M must equal cfg.n_obstacles; appended as
    INFINITE-mass bodies.  obj_type / obj_pose: optional overrides of the
    object class and world (x, y, yaw), shared by every lane (the
    deployment runtime re-anchors a fresh docked scene at the mission
    object's observed pose)."""
    dev = resolve_device(device)
    b = cfg.base
    B = n_envs
    z = dict(dtype=dtype, device=dev)
    mass = _uniform(gen, (B,), *b.mass_range, dtype, dev)
    fric = _uniform(gen, (B,), *b.friction_range, dtype, dev)
    com = _uniform(gen, (B, 2), -b.com_range, b.com_range, dtype, dev)
    cmd = _uniform(gen, (B, 3), -1.0, 1.0, dtype, dev) \
        * torch.tensor([1.0, 0.5, 1.0], **z)
    drawn_type = torch.randint(0, 3, (B,), generator=gen).to(dev)
    yaw_draw = _uniform(gen, (B,), -math.pi, math.pi, dtype, dev)
    key = _draw_key(gen, B, dev)
    if obj_type is None:
        obj_type = drawn_type
    else:
        obj_type = torch.full((B,), int(obj_type), dtype=torch.int64,
                              device=dev)
    obj_he = torch.tensor(OBJ_HALF_EXT, **z)[obj_type]
    if obj_pose is None:
        yaw0 = yaw_draw
        obj_pos = torch.zeros(B, 2, **z)
    else:
        op = _as_tensor(obj_pose).to(**z)
        yaw0 = op[2].expand(B).clone()
        obj_pos = op[:2].expand(B, 2).clone()

    # robot starts "docked": its EE anchor coincides with the object's
    # grasp anchor (env_train.py:429, 438-443)
    anchor_r = torch.tensor(cfg.grasp_anchor_robot, **z)
    anchor_o = torch.stack([-obj_he[:, 0], torch.zeros_like(obj_he[:, 0])],
                           dim=-1)
    robot_pos = obj_pos + _rotate(yaw0, anchor_o) \
        - _rotate(yaw0, anchor_r.expand(B, 2))
    poses = torch.stack([torch.cat([robot_pos, yaw0[:, None]], -1),
                         torch.cat([obj_pos, yaw0[:, None]], -1)], dim=1)
    masses = torch.stack([torch.full((B,), ROBOT_MASS, **z), mass], dim=1)
    half_ext = torch.stack([torch.tensor(ROBOT_HALF_EXT, **z).expand(B, 2),
                            obj_he], dim=1)
    bodies = ph.BodyState(
        pose=poses, vel=torch.zeros(B, 2, 3, **z), mass=masses,
        inertia=ph.box_inertia(masses, half_ext), half_ext=half_ext,
        box_off=torch.stack([torch.zeros(B, 2, **z), -com], dim=1),
        mu_ground=torch.stack([torch.ones(B, **z), fric], dim=1))

    NB = cfg.n_bystanders
    if NB:
        # bystanders: the other classes, placed on a ring around the
        # work area, dynamic (mass drawn from the env range)
        b_types = (obj_type[:, None] + 1
                   + torch.arange(NB, device=dev)[None]) % 3
        b_he = torch.tensor(OBJ_HALF_EXT, **z)[b_types]
        ang = _uniform(gen, (B, NB), -math.pi, math.pi, dtype, dev)
        rad = _uniform(gen, (B, NB), 2.0, 3.5, dtype, dev)
        b_pos = torch.stack([rad * torch.cos(ang), rad * torch.sin(ang)], -1)
        b_yaw = _uniform(gen, (B, NB), -math.pi, math.pi, dtype, dev)
        b_mass = _uniform(gen, (B, NB), *b.mass_range, dtype, dev)
        bodies = ph.BodyState(
            pose=torch.cat([bodies.pose,
                            torch.cat([b_pos, b_yaw[..., None]], -1)], 1),
            vel=torch.cat([bodies.vel, torch.zeros(B, NB, 3, **z)], 1),
            mass=torch.cat([bodies.mass, b_mass], 1),
            inertia=torch.cat([bodies.inertia,
                               ph.box_inertia(b_mass, b_he)], 1),
            half_ext=torch.cat([bodies.half_ext, b_he], 1),
            box_off=torch.cat([bodies.box_off, torch.zeros(B, NB, 2, **z)],
                              1),
            mu_ground=torch.cat([bodies.mu_ground,
                                 torch.full((B, NB), 0.6, **z)], 1))

    M = cfg.n_obstacles
    if M:
        assert obstacles is not None, "cfg.n_obstacles set but no obstacles"
        oc, oy, ohe = (_as_tensor(x).to(**z).expand(B, *np.shape(x))
                       for x in obstacles)
        inf = torch.full((B, M), math.inf, **z)
        bodies = ph.BodyState(
            pose=torch.cat([bodies.pose, torch.cat([oc, oy[..., None]], -1)],
                           1),
            vel=torch.cat([bodies.vel, torch.zeros(B, M, 3, **z)], 1),
            mass=torch.cat([bodies.mass, inf], 1),
            inertia=torch.cat([bodies.inertia, inf], 1),
            half_ext=torch.cat([bodies.half_ext, ohe], 1),
            box_off=torch.cat([bodies.box_off, torch.zeros(B, M, 2, **z)], 1),
            mu_ground=torch.cat([bodies.mu_ground, torch.ones(B, M, **z)],
                                1))

    st = PhysPushEnvState(
        bodies=bodies, obj_anchor=anchor_o,
        grasp_active=torch.ones(B, dtype=torch.bool, device=dev),
        cmd=cmd, friction=fric, com=com, obj_type=obj_type,
        arm_q=torch.zeros(B, 6, **z),
        prev_action=torch.zeros(B, N_ACTIONS, **z),
        obs_hist=torch.zeros(B, HIST, OBS_DIM, **z),
        t=torch.zeros(B, dtype=torch.int32, device=dev), key=key)
    obs, key = _observe(st, cfg)
    hist = obs[:, None, :].expand(B, HIST, OBS_DIM).clone()
    return st._replace(obs_hist=hist, key=key)


def as_surrogate_view(st: PhysPushEnvState) -> PushEnvState:
    """Duck-typed PushEnvState over the physics state: the object's pose
    and BODY-FRAME velocity exactly as the surrogate env stores them."""
    return PushEnvState(
        obj_pose=st.bodies.pose[:, OBJ],
        obj_vel=_body_frame_vel(st.bodies.pose[:, OBJ],
                                st.bodies.vel[:, OBJ]),
        arm_q=st.arm_q, cmd=st.cmd, mass=st.bodies.mass[:, OBJ],
        friction=st.friction, com=st.com, obj_type=st.obj_type,
        prev_action=st.prev_action, obs_hist=st.obs_hist, t=st.t,
        key=st.key)


def _grasp_tuple(st: PhysPushEnvState, cfg: PhysicsEnvConfig):
    dt = dict(dtype=st.bodies.vel.dtype, device=st.bodies.vel.device)
    return (st.grasp_active, ROBOT,
            torch.tensor(cfg.grasp_anchor_robot, **dt), OBJ,
            st.obj_anchor, torch.tensor(True, device=dt["device"]))


def _contact_layout(cfg: PhysicsEnvConfig, device):
    """Static pair list + servo mask + robot-obstacle contact rows.

    Body layout: [robot, object, bystanders..., obstacles...].  All
    dynamic bodies collide with each other and with every obstacle;
    only ROBOT-OBSTACLE impulses feed the collision termination.
    """
    NB, M = cfg.n_bystanders, cfg.n_obstacles
    dyn = [ROBOT, OBJ] + [2 + i for i in range(NB)]
    obs = [2 + NB + i for i in range(M)]
    pairs = [(a, b) for i, a in enumerate(dyn) for b in dyn[i + 1:]]
    robot_obs_rows = []
    for o in obs:
        for d in dyn:
            if d == ROBOT:
                robot_obs_rows.append(len(pairs))
            pairs.append((d, o))
    mask = torch.tensor([True] + [False] * (1 + NB + M), device=device)
    return pairs, mask, robot_obs_rows


def _max_hit(hit, dbg, rows):
    if not rows:
        return hit
    return torch.maximum(hit, torch.amax(dbg.pn[:, rows], dim=(1, 2)))


def env_step(st: PhysPushEnvState, action,
             cfg: PhysicsEnvConfig = PhysicsEnvConfig()):
    """One 50 Hz step through `decimation` contact-dynamics substeps.
    Returns (new_state, obs_hist, reward, done)."""
    a = torch.clamp(action, -1.0, 1.0).to(st.bodies.vel.dtype)
    vel_cmd = a[:, :3] * _scales(cfg.base, a)
    pcfg = cfg.physics
    grasp = _grasp_tuple(st, cfg)
    pairs, servo_mask, obs_rows = _contact_layout(cfg, a.device)
    bodies = st.bodies
    hit = torch.zeros_like(a[:, 0])
    for _ in range(cfg.decimation):
        w = ph.servo_forces(bodies, ROBOT, vel_cmd, pcfg)
        bodies, dbg = ph.physics_substep(bodies, w, pairs, pcfg, grasp=grasp,
                                         servo_mask=servo_mask)
        hit = _max_hit(hit, dbg, obs_rows)
    return _finish_step(st, bodies, a, cfg, collision_impulse=hit)


def hierarchical_env_step(st: PhysPushEnvState, rs, action, low_policy,
                          cfg: PhysicsEnvConfig = PhysicsEnvConfig(),
                          hcfg=None):
    """The COMPLETE reference stack in one step: 9-d high-level action ->
    frozen low-level WBC (200 Hz, rl/hierarchy.py) -> realized base
    velocity -> traction-limited servo -> contact + grasp weld -> object
    motion (env_train.py:422-543 end to end).  Each 200 Hz substep
    interleaves one WBC tick with one contact substep whose servo tracks
    the WBC's realized velocity.

    Returns (env_state, robot_state, obs_hist, reward, done).
    """
    from .hierarchy import HierarchyConfig, hierarchical_substep

    hcfg = hcfg or HierarchyConfig()
    a = torch.clamp(action, -1.0, 1.0).to(st.bodies.vel.dtype)
    vel_cmd = a[:, :3] * _scales(cfg.base, a)
    pcfg = cfg.physics
    grasp = _grasp_tuple(st, cfg)
    pairs, servo_mask, obs_rows = _contact_layout(cfg, a.device)
    bodies = st.bodies
    hit = torch.zeros_like(a[:, 0])
    for _ in range(cfg.decimation):
        rs = hierarchical_substep(rs, vel_cmd, low_policy, hcfg)
        # keep the WBC's pose estimate consistent with the physics body
        rs = rs._replace(base_pose=bodies.pose[:, ROBOT])
        w = ph.servo_forces(bodies, ROBOT, rs.base_vel, pcfg)
        bodies, dbg = ph.physics_substep(bodies, w, pairs, pcfg, grasp=grasp,
                                         servo_mask=servo_mask)
        hit = _max_hit(hit, dbg, obs_rows)
    st, hist, reward, done = _finish_step(st, bodies, a, cfg,
                                          collision_impulse=hit)
    return st, rs, hist, reward, done


def _finish_step(st: PhysPushEnvState, bodies, a, cfg: PhysicsEnvConfig,
                 collision_impulse=None):
    """Shared step tail: grasp-loss check, arm integration, observation,
    reward (env.env_step structure), termination."""
    b = cfg.base
    arm_delta = a[:, 3:] * b.action_scale_arm

    # grasp-loss: the (force-capped) weld slipped too far
    anchor_r = torch.tensor(cfg.grasp_anchor_robot, dtype=a.dtype,
                            device=a.device)
    wa = bodies.pose[:, ROBOT, :2] + _rotate(bodies.pose[:, ROBOT, 2],
                                             anchor_r.expand_as(st.obj_anchor))
    wb = bodies.pose[:, OBJ, :2] + _rotate(bodies.pose[:, OBJ, 2],
                                           st.obj_anchor)
    gap = torch.linalg.vector_norm(wb - wa, dim=-1)
    grasp_lost = gap > cfg.grasp_loss_dist

    arm_new = torch.clamp(st.arm_q + arm_delta, -1.5, 1.5)
    prev_a = st.prev_action
    st = st._replace(bodies=bodies, arm_q=arm_new, prev_action=a,
                     grasp_active=st.grasp_active & ~grasp_lost,
                     t=st.t + 1)
    obs, key = _observe(st, cfg)
    hist = torch.cat([st.obs_hist[:, 1:], obs[:, None]], dim=1)
    st = st._replace(obs_hist=hist, key=key)

    obj_vel = _body_frame_vel(bodies.pose[:, OBJ], bodies.vel[:, OBJ])
    reward, done = _reward_and_done(st, obj_vel, a, prev_a, arm_delta, b)
    done = done | grasp_lost
    if collision_impulse is not None and cfg.n_obstacles:
        # base contact-sensor termination (env_train.py:984-1002)
        done = done | (collision_impulse > cfg.collision_impulse_done)
    return st, hist, reward, done
